"""AdamW with f32 moments (and optional f32 master weights)."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree
from repro_torch.core.blocks import blocks_of, moved

# elements a chunk of the gradient norm's f64 sum (bounds its f64 copy)
_NORM_CHUNK = 1 << 26


def square_sum(g, device) -> torch.Tensor:
    """The sum of squares of ``g`` (a tensor, or a
    :class:`~repro_torch.core.blocks.Sharded` leaf: each distinct
    block's, added in mesh order) in f64 on ``device``.  The square of an
    f32 or bf16 value is exact in f64, so where a leaf is cut into blocks
    moves only the f64 sum's own rounding, far below the f32 norm's
    last bit."""
    total = torch.zeros((), dtype=torch.float64, device=device)
    s = blocks_of(g)
    for key in s.keys():
        for c in s.block(key).reshape(-1).split(_NORM_CHUNK):
            total += torch.sum(torch.square(c.double())).to(device)
    return total


class AdamW:
    """``update`` works in place: the parameters, moments and master
    weights it is given are overwritten with the step's (the counterpart
    of the reference's jitted step, whose state is donated), and returned.
    A leaf of two or more dims is decayed (the reference's ``p.ndim >=
    2``, on the stacked leaf: the stacked norms are decayed too).

    The leaves may be tensors or the blocks of
    :mod:`repro_torch.core.blocks` (parameters, gradients and state in
    one layout): each block is updated on its own device, a block held on
    several devices once on each.  The update is elementwise but for the
    global norm of the clip, the square root of the f64 sum of
    :func:`square_sum` over the leaves."""

    def __init__(self, lr: float | Callable = 3e-4, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, master_weights: bool = False,
                 grad_clip: float = 1.0):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay
        self.master_weights = master_weights
        self.grad_clip = grad_clip

    def init(self, params) -> dict:
        def f32(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        state = {"step": torch.zeros((), dtype=torch.int32,
                                     device=tree.leaves(params)[0].device),
                 "m": tree.map_(f32, params),
                 "v": tree.map_(f32, params)}
        if self.master_weights:
            state["master"] = tree.map_(
                lambda p: p.detach().to(torch.float32, copy=True), params)
        return state

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, grads, state, params):
        """-> (params, state, {``grad_norm``, ``lr``}), updated in place."""
        counter = blocks_of(state["step"])
        for _, _, s in counter.units():
            s += 1
        step = counter.block(())
        first = step.device
        lr = self._lr(step)
        gl = [blocks_of(g) for g in tree.leaves(grads)]
        if self.grad_clip:
            gnorm = torch.sqrt(sum(square_sum(g, first) for g in gl)).float()
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        else:
            gnorm = torch.zeros((), device=first)
            scale = 1.0
        b1, b2 = self.b1, self.b2
        t = step.to(torch.float32)
        c1 = 1 - b1 ** t
        c2 = 1 - b2 ** t
        masters = (tree.leaves(state["master"]) if self.master_weights
                   else [None] * len(gl))
        for p, g, m, v, mw in zip(tree.leaves(params), gl,
                                  tree.leaves(state["m"]),
                                  tree.leaves(state["v"]), masters):
            p, m, v = blocks_of(p), blocks_of(m), blocks_of(v)
            mw = None if mw is None else blocks_of(mw)
            decay = self.weight_decay if p.dim() >= 2 else 0.0
            for key, dev, gb in g.units():
                unit = (key, dev)
                self._block(p.blocks[unit], gb, m.blocks[unit],
                            v.blocks[unit],
                            None if mw is None else mw.blocks[unit],
                            *(moved(x, dev) for x in (scale, c1, c2, lr)),
                            decay)
        metrics = {"grad_norm": gnorm,
                   "lr": torch.as_tensor(lr, device=first)}
        return params, state, metrics

    def _block(self, p, g, m, v, mw, scale, c1, c2, lr, decay) -> None:
        b1, b2 = self.b1, self.b2
        g = g.float() * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
        del g
        base = mw if mw is not None else p.float()
        new = base - lr * (u + decay * base)
        del u
        p.copy_(new)
        if mw is not None:
            mw.copy_(new)
