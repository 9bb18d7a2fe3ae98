"""Plain PyTorch versions of the port's kernels, with the leading batch axis.

They are the correctness contract: the wrappers run them for CPU tensors,
the CPU tests hold them against the JAX package's kernels and oracles
(``repro/kernels/ref.py``), and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  They form the (B, M, K) distance tensor, so
they are a check, not a yardstick of speed.

Semantics shared with the kernels: fp32 throughout (bf16 inputs upcast),
``d2 = max(|x|^2 + |c|^2 - 2 x.c, 0)``, ties to the lowest center index,
and rows with ``w = 0`` add nothing to ``sums``, ``counts`` or ``sse``.
The ADC scan sums one table entry per subspace, in f32.  The cluster
attention returns the unnormalised online-softmax state ``(acc, m, l)``
with the ``-1e30`` sentinel bias on dead centroids, as the Pallas kernel
does.
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
    """Raw weighted per-cluster sums (B, k, d) and counts (B, k), f32 (f64
    for f64 inputs, an exact reference for the kernel's sums).  A row adds
    nothing when its weight is 0 or its id lies outside [0, k) (as with the
    JAX package's one-hot)."""
    b, m, d = x.shape
    acc = torch.promote_types(x.dtype, torch.float32)
    w = w.to(acc)
    live = (w != 0) & (idx >= 0) & (idx < k)
    wx = torch.where(live[..., None], x.to(acc) * w[..., None], 0.0)
    flat = (torch.where(live, idx.long(), 0)
            + k * torch.arange(b, device=x.device)[:, None]).reshape(-1)
    sums = torch.zeros(b * k, d, dtype=acc, device=x.device).index_add_(
        0, flat, wx.reshape(-1, d))
    counts = torch.zeros(b * k, dtype=acc, device=x.device).index_add_(
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


def adc_scan_ref(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """ADC scan: (B, m, C) lookup tables and (B, L, m) integer codes ->
    (B, L) f32 distances ``sum_j lut[b, j, codes[b, l, j]]``, by one gather
    over the code axis and a sum over ``j``."""
    idx = codes.long().transpose(1, 2)                    # (B, m, L)
    return torch.gather(luts.float(), 2, idx).sum(1)      # (B, L)


NEG = -1.0e30     # the dead-centroid bias of the cluster attention


def cluster_attn_decode_ref(q: torch.Tensor, kc: torch.Tensor,
                            vc: torch.Tensor, counts: torch.Tensor,
                            scale: float) -> tuple[torch.Tensor, ...]:
    """Decode attention over a clustered KV cache, the contract of the
    Pallas kernel ``cluster_attn_decode_pallas``: (B, H, dh) queries,
    (B, Hkv, Nc, dh) centroid keys and values, (B, Hkv, Nc) member counts
    -> the unnormalised state ``acc (B, Hkv, g, dh)``, ``m (B, Hkv, g)``,
    ``l (B, Hkv, g)`` (g = H // Hkv), all f32 and computed in f32.  Each
    centroid's logit is ``q.kc * scale + log(max(count, 1e-9))``, or
    ``+ NEG`` for ``count <= 0``; ``m`` is the largest logit,
    ``l = sum exp(logit - m)`` and ``acc = sum exp(logit - m) vc``.  A row
    whose centroids are all dead has ``m = NEG``, ``l = Nc`` and ``acc``
    the sum of its values."""
    b, h, dh = q.shape
    hkv = kc.shape[1]
    qg = q.float().reshape(b, hkv, h // hkv, dh)
    logits = torch.einsum("bkgd,bknd->bkgn", qg, kc.float()) * scale
    counts = counts.float()
    bias = torch.where(counts > 0, torch.log(counts.clamp_min(1e-9)), NEG)
    logits = logits + bias[:, :, None, :]
    m = logits.amax(-1)
    p = torch.exp(logits - m[..., None])
    acc = torch.einsum("bkgn,bknd->bkgd", p, vc.float())
    return acc, m, p.sum(-1)
