"""Adafactor (Shazeer & Stern 2018): factored second moments, no first
moment."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree
from repro_torch.core.blocks import blocks_of, covering, moved, sum_into


def _reduction(s, n: int) -> tuple:
    """(the per-block reduction, the divisor) of a mean over ``n`` of
    leaf ``s``'s entries: ``torch.mean`` and 1 for a leaf of one block,
    so a tensor's statistics are the one-device step's bits on every
    device; ``torch.sum`` and ``n`` for a leaf cut into blocks, whose
    partial sums are added in mesh order."""
    return (torch.mean, 1) if len(s.keys()) == 1 else (torch.sum, n)


class Adafactor:
    """``update`` works in place, as :class:`~repro_torch.optim.AdamW`'s.
    Every leaf of two or more dims is factored over its last two axes: a
    stacked (L, d) norm gets ``vr`` (L,) and a ``vc`` (d,) that all its
    layers share, and the update's RMS clip is taken over the whole
    stacked leaf, as the reference's are.

    The leaves may be tensors or the blocks of
    :mod:`repro_torch.core.blocks`.  The factored means, ``vr``'s mean
    and the RMS are taken over the whole leaf: a leaf of one block (a
    tensor) takes ``torch.mean``, as the one-device step always has; a
    leaf cut into blocks adds per-block partial sums in mesh order and
    divides by the count.  Every other step is elementwise, on each
    block's device."""

    def __init__(self, lr: float | Callable = 1e-3, decay: float = 0.8,
                 eps: float = 1e-30, clip_threshold: float = 1.0,
                 weight_decay: float = 0.0):
        self.lr, self.decay, self.eps = lr, decay, eps
        self.clip_threshold = clip_threshold
        self.weight_decay = weight_decay

    @staticmethod
    def _factored(p) -> bool:
        return p.dim() >= 2

    def init(self, params) -> dict:
        def per(p):
            z = dict(dtype=torch.float32, device=p.device)
            if self._factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=tree.leaves(params)[0].device),
                "fac": tree.map_(per, params)}

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, grads, state, params):
        """-> (params, state, {``lr``}), updated in place."""
        counter = blocks_of(state["step"])
        for _, _, s in counter.units():
            s += 1
        step = counter.block(())
        t = step.to(torch.float32)
        beta = 1.0 - t ** (-self.decay)
        lr = self._lr(step)
        for (path, p), g in zip(tree.items(params), tree.leaves(grads)):
            s = tree.get(state["fac"], path)
            p, g = blocks_of(p), blocks_of(g)
            gf = {(k, d): (g.region(k), gb.float()) for k, d, gb in g.units()}
            if self._factored(p):
                u = self._factored_u(g, gf, s, beta)
            else:
                u = self._plain_u(g, gf, s, beta)
            del gf
            # update clipping by RMS over the whole leaf
            red, n = _reduction(g, p.numel())
            sq = {}
            for k in g.keys():
                uk = u[(k, g.block(k).device)]
                sq[k] = ((), red(uk * uk))
            decay = self.weight_decay if p.dim() >= 2 else 0.0
            for key, dev, pb in p.units():
                rms = torch.sqrt(sum_into(sq, (), dev) / n + 1e-30)
                uk = u.pop((key, dev))
                uk = uk / torch.clamp(rms / self.clip_threshold, min=1.0)
                pf = pb.float()
                pb.copy_(pf - moved(lr, dev) * (uk + decay * pf))
        return params, state, {"lr": torch.as_tensor(lr, device=step.device)}

    def _factored_u(self, g, gf: dict, s: dict, beta) -> dict:
        """Each stored block's update before the clip, with ``vr`` and
        ``vc`` updated in place from the gradient's row and column
        means."""
        rows, cols = {}, {}
        red, n_cols = _reduction(g, g.shape[-1])
        _, n_rows = _reduction(g, g.shape[-2])
        for key in g.keys():
            r, gk = gf[(key, g.block(key).device)]
            g2 = gk * gk + self.eps
            rows[key] = (r[:-1], red(g2, -1))
            cols[key] = (r[:-2] + r[-1:], red(g2, -2))
            del g2
        vr, vc = blocks_of(s["vr"]), blocks_of(s["vc"])
        for v, part, n in ((vr, rows, n_cols), (vc, cols, n_rows)):
            for key, dev, vb in v.units():
                b = moved(beta, dev)
                vb.copy_(b * vb + (1 - b) * (sum_into(part, v.region(key),
                                                       dev) / n))
        del rows, cols
        red, n = _reduction(vr, vr.shape[-1])
        vsum = {k: (vr.region(k)[:-1], red(vr.block(k), -1))
                for k in vr.keys()}
        rfac, cfac = {}, {}
        for key, dev, vb in vr.units():
            r = vr.region(key)
            mean = sum_into(vsum, r[:-1], dev) / n
            rfac[(key, dev)] = (r, torch.rsqrt(vb / torch.clamp(
                mean[..., None], min=self.eps)))
        for key, dev, vb in vc.units():
            cfac[(key, dev)] = (vc.region(key), torch.rsqrt(vb))
        u = {}
        for (key, dev), (r, gk) in gf.items():
            rf = covering(rfac, r[:-1], dev)
            cf = covering(cfac, r[:-2] + r[-1:], dev)
            u[(key, dev)] = gk * rf[..., None] * cf[..., None, :]
        return u

    def _plain_u(self, g, gf: dict, s: dict, beta) -> dict:
        """Each stored block's update before the clip, with the unfactored
        ``v`` updated in place."""
        v = blocks_of(s["v"])
        for key, dev, vb in v.units():
            gk = covering(gf, v.region(key), dev)
            b = moved(beta, dev)
            vb.copy_(b * vb + (1 - b) * (gk * gk + self.eps))
        held = {(k, d): (v.region(k), vb) for k, d, vb in v.units()}
        return {(key, dev): gk * torch.rsqrt(covering(held, r, dev))
                for (key, dev), (r, gk) in gf.items()}
