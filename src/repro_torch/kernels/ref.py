"""Plain PyTorch versions of the port's kernels, with the leading batch axis.

They are the correctness contract: the wrappers run them for CPU tensors,
the CPU tests hold them against the JAX package's kernels and oracles
(``repro/kernels/ref.py``), and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  They form the (B, M, K) distance tensor, so
they are a check, not a yardstick of speed.

Semantics shared with the kernels: fp32 throughout (bf16 inputs upcast),
``d2 = max(|x|^2 + |c|^2 - 2 x.c, 0)``, ties to the lowest center index,
and rows with ``w = 0`` add nothing to ``sums``, ``counts`` or ``sse``.
"""
from __future__ import annotations

import torch


def assign_argmin_ref(x: torch.Tensor, c: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, M, d) points, (B, K, d) centers -> nearest-center id (B, M)
    int32 and its squared distance (B, M) f32."""
    x = x.float()
    c = c.float()
    # the cross term one coordinate at a time, in order: every center's
    # distance is the same arithmetic, so coincident centers tie exactly
    # (a blocked matmul may round two identical columns differently)
    xc = torch.zeros((x.shape[0], x.shape[1], c.shape[1]), device=x.device)
    for j in range(x.shape[2]):
        xc += x[:, :, j, None] * c[:, None, :, j]
    d2 = ((x * x).sum(-1, keepdim=True) + (c * c).sum(-1)[:, None, :]
          - 2.0 * xc).clamp_min(0.0)
    idx = d2.argmin(-1)                       # first index of the minimum
    dist = d2.gather(-1, idx[..., None])[..., 0]
    return idx.to(torch.int32), dist


def centroid_update_ref(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                        k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw weighted per-cluster sums (B, k, d) and counts (B, k), f32."""
    b, m, d = x.shape
    w = w.float()
    live = w != 0
    wx = torch.where(live[..., None], x.float() * w[..., None], 0.0)
    flat = (idx.long() + k * torch.arange(b, device=x.device)[:, None]
            ).reshape(-1)
    sums = torch.zeros(b * k, d, device=x.device).index_add_(
        0, flat, wx.reshape(-1, d))
    counts = torch.zeros(b * k, device=x.device).index_add_(
        0, flat, torch.where(live, w, 0.0).reshape(-1))
    return sums.view(b, k, d), counts.view(b, k)


def lloyd_step_ref(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor
                   ) -> tuple[torch.Tensor, ...]:
    """One Lloyd pass: (B, M, d) points, (B, M) weights, (B, K, d) centers
    -> ``(sums (B, K, d), counts (B, K), sse (B,), idx (B, M) int32,
    dist (B, M))``, all f32 but ``idx``."""
    idx, dist = assign_argmin_ref(x, c)
    sums, counts = centroid_update_ref(x, idx, w, c.shape[1])
    wf = w.float()
    sse = torch.where(wf != 0, dist * wf, 0.0).sum(-1)
    return sums, counts, sse, idx, dist
