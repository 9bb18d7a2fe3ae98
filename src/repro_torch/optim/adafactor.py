"""Adafactor (Shazeer & Stern 2018): factored second moments, no first
moment."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree


class Adafactor:
    """``update`` works in place, as :class:`~repro_torch.optim.AdamW`'s.
    Every leaf of two or more dims is factored over its last two axes: a
    stacked (L, d) norm gets ``vr`` (L,) and a ``vc`` (d,) that all its
    layers share, and the update's RMS clip is taken over the whole
    stacked leaf, as the reference's are."""

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
        state["step"] += 1
        step = state["step"]
        t = step.to(torch.float32)
        beta = 1.0 - t ** (-self.decay)
        lr = self._lr(step)
        for (path, p), g in zip(tree.items(params), tree.leaves(grads)):
            s = tree.get(state["fac"], path)
            g = g.float()
            g2 = g * g + self.eps
            if self._factored(p):
                s["vr"].copy_(beta * s["vr"] + (1 - beta) * g2.mean(-1))
                s["vc"].copy_(beta * s["vc"] + (1 - beta) * g2.mean(-2))
                vr, vc = s["vr"], s["vc"]
                rfac = torch.rsqrt(vr / torch.clamp(
                    vr.mean(-1, keepdim=True), min=self.eps))
                cfac = torch.rsqrt(vc)
                u = g * rfac[..., None] * cfac[..., None, :]
            else:
                s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
                u = g * torch.rsqrt(s["v"])
            del g2
            # update clipping by RMS
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
            pf = p.float()
            decay = self.weight_decay if p.dim() >= 2 else 0.0
            p.copy_(pf - lr * (u + decay * pf))
        return params, state, {"lr": torch.as_tensor(lr, device=step.device)}
