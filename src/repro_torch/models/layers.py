"""Shared neural-net layers of the port's models (the counterpart of
:mod:`repro.models.layers`).

Conventions, as in the JAX package:
  * weights are stored (d_in, d_out), so a projection is ``x @ w``;
  * weights live in ``cfg.dtype`` (bf16 at full width); a product of bf16
    tensors accumulates in f32 inside the matmul and returns bf16;
  * norms run in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def param(shape, dtype: torch.dtype, device) -> nn.Parameter:
    """A zeroed parameter (inference only: no gradient)."""
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over the last axis of ``x`` (the result keeps x's type)."""
    return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in f32 with the ``1 + scale`` gain (zero-initialised
    scales are the identity), returned in x's type."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    return dot(F.silu(dot(x, w1).float()).to(x.dtype) * dot(x, w3), w2)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: "torch.Tensor | None" = None) -> torch.Tensor:
    """Mean token NLL in f32; ``labels`` integer ids (..., S), ``mask``
    (..., S) weights the positions (the mean over its mass)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, dh: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer positions: (..., dh // 2) f32."""
    half = dh // 2
    dev = positions.device
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=dev),
                      -torch.arange(0, half, dtype=torch.float32,
                                    device=dev) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, n, dh); cos/sin: (S, dh // 2) or broadcastable."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)    # (S, 1, half)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------------------
# Initialiser: normal draws from a torch.Generator at the JAX package's
# scales (the draws themselves are not JAX's)
# ---------------------------------------------------------------------------

def ninit_(w: torch.Tensor, gen: torch.Generator, scale: float
           ) -> torch.Tensor:
    """Fill ``w`` in place with N(0, scale^2) draws made in f32."""
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=gen, device=w.device,
                            dtype=torch.float32).mul_(scale))
    return w
