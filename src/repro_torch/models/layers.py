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


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D) as f32 from the operands in their own type: on CUDA
    a low-precision product writes f32 (``torch.mm(..., out_dtype=f32)``)
    from tensor-core f32 sums; otherwise it is the f32 product."""
    if (a.device.type == "cuda" and a.dtype != torch.float32
            and a.dtype == b.dtype):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _Product(torch.autograd.Function):
    """``x @ w`` of 2-D matrices, computed from ``x`` in ``w``'s type
    (``x`` holds values of that type), with the rounding of each result
    placed where a product over a whole weight places it:

    * ``out_f32``: the product in f32, unrounded (``torch.mm(...,
      out_dtype=f32)`` on CUDA, which has no derivative of its own);
      else in ``w``'s type;
    * the backward of an f32 product is the reference's transpose of
      ``dot_general(..., preferred_element_type=f32)``: the f32 cotangent
      times the other operand in f32, rounded to the operand's type;
      with ``grad_low``, whose cotangent holds values of ``w``'s type
      (the gradient of a sum rounded to it), it is the product's own
      backward in that type;
    * the backward of a product in ``w``'s type gives ``x``'s gradient as
      the f32 product, rounded to ``x``'s type (none where ``x`` is an
      f32 copy, so "model" positions' gradients meet unrounded), and
      ``w``'s in its type."""

    @staticmethod
    def forward(ctx, x, w, out_f32: bool, grad_low: bool):
        xl = x.to(w.dtype)
        ctx.save_for_backward(xl, w)
        ctx.x_dtype, ctx.grad_low = x.dtype, grad_low
        return _mm_f32(xl, w) if out_f32 else xl @ w

    @staticmethod
    def backward(ctx, g):
        xl, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        dx = dw = None
        if ctx.grad_low or g.dtype == w.dtype:
            g = g.to(w.dtype)
            if need_x:
                dx = (g @ w.T if ctx.grad_low else _mm_f32(g, w.T)
                      ).to(ctx.x_dtype)
            if need_w:
                dw = xl.T @ g
        else:
            if need_x:
                dx = (g @ w.float().T).to(ctx.x_dtype)
            if need_w:
                dw = (xl.float().T @ g).to(w.dtype)
        return dx, dw, None, None


def _product(x: torch.Tensor, w: torch.Tensor, out_f32: bool,
             grad_low: bool = False) -> torch.Tensor:
    x2 = x.reshape(-1, x.shape[-1])
    out = _Product.apply(x2, w, out_f32, grad_low)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over the last axis of ``x`` as f32, computed from the
    operands in their own type with no rounding of the product to it (the
    reference's ``dot_general(..., preferred_element_type=f32)``): the
    head's logits (:class:`_Product`)."""
    return _product(x, w, True)


def dot_partial(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A "model" position's partial product ``x @ w`` by its rows of a
    row-split weight (``wo``, ``w2``), in f32 and unrounded, for the
    positions' add (``from_model``); its gradient is that of the sum
    rounded to x's type, so the backward is the whole product's, in x's
    type."""
    return _product(x, w, True, grad_low=True)


def dot_column(x32: torch.Tensor, w: torch.Tensor,
               out_f32: bool = False) -> torch.Tensor:
    """A "model" position's product ``x @ w`` by its columns of a
    column-split weight (``wq``, ``wk``, ``wv``, ``w1``, ``w3``; the
    head's with ``out_f32``), from ``x32``, an f32 copy of the
    activations (``to_model``'s): the result as the whole product's
    columns, and x's gradient in f32, so the positions' gradients are
    added unrounded and the sum is rounded once, where the whole
    product's is."""
    return _product(x32, w, out_f32)


def over_columns(split, x: torch.Tensor, ws: list, out_f32: bool = False
                 ) -> list:
    """``x @ w_m`` on each "model" position m of ``split``, by its columns
    ``ws[m]`` of a column-split weight (:func:`dot_column`): x goes to
    every position as an f32 copy (``to_model``), so the positions' input
    gradients are added unrounded and the sum is rounded once, by the
    copy's cast, as the whole product's gradient is."""
    return [dot_column(xm, w, out_f32)
            for xm, w in zip(split.to_model(x.float()), ws)]


def over_rows(split, xs: list, ws: list) -> torch.Tensor:
    """The sum over the "model" positions of ``xs[m] @ ws[m]``, position
    m's rows of a row-split weight: f32 partials (:func:`dot_partial`)
    added in mesh order and rounded once to the activations' type
    (``from_model``), on the first position's device."""
    return split.from_model([dot_partial(xm, w) for xm, w in zip(xs, ws)],
                            xs[0].dtype)[0]


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in f32 with the ``1 + scale`` gain (zero-initialised
    scales are the identity), returned in x's type."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def swiglu_gate(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The SwiGLU's hidden activations ``silu(u) * v`` from its two
    products ``u = x w1``, ``v = x w3`` (the silu in f32, the result in
    their type)."""
    return F.silu(u.float()).to(u.dtype) * v


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    return dot(swiglu_gate(dot(x, w1), dot(x, w3)), w2)


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


def vocab_parallel_cross_entropy(blocks, labels: torch.Tensor
                                 ) -> torch.Tensor:
    """:func:`cross_entropy` (no mask) of logits held as consecutive equal
    column blocks, block m on "model" position m's device: ``blocks``
    f32 (..., S, V / M) in position order, ``labels`` (..., S) on the
    first block's device.  The whole (..., V) logits are never formed.
    The row max over the blocks (no gradient), the sum of ``exp(logits -
    max)`` over each block added in position order, and the gold logit
    from the block that holds the label's column give each row's NLL,
    ``(max - gold) + log(sum)``, on the first block's device; the
    gradient of block m is its softmax block minus the one-hot on its own
    columns (times the row's gradient)."""
    dev, width = blocks[0].device, blocks[0].shape[-1]
    with torch.no_grad():
        mx = blocks[0].amax(-1)
        for b in blocks[1:]:
            mx = torch.maximum(mx, b.amax(-1).to(dev))
    labels = labels.long()
    total = gold = None
    for m, b in enumerate(blocks):
        e = torch.exp(b - mx.to(b.device)[..., None]).sum(-1).to(dev)
        local = labels.to(b.device) - m * width
        inside = (local >= 0) & (local < width)
        g = torch.gather(b, -1, local.clamp(0, width - 1)[..., None])[..., 0]
        g = torch.where(inside, g, torch.zeros_like(g)).to(dev)
        total = e if total is None else total + e
        gold = g if gold is None else gold + g
    return ((mx - gold) + torch.log(total)).mean()


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
