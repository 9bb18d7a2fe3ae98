"""Learning-rate schedules."""
from __future__ import annotations

import math

import torch


def cosine_warmup(peak: float, warmup: int, total: int, floor: float = 0.1):
    """lr(step): linear warm-up to ``peak`` over ``warmup`` steps, then a
    cosine down to ``floor * peak`` at ``total``; an f32 0-d tensor of a
    step given as an int or a tensor."""
    def lr(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = peak * s / max(warmup, 1)
        frac = ((s - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * frac)))
        return torch.where(s < warmup, warm, cos)
    return lr
