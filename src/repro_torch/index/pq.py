"""Product quantization: the paper's local k-means stage, once per subspace.
The port's counterpart of :mod:`repro.index.pq`.

Training is ONE batched k-means with the subspaces as lanes (the JAX
package ``vmap``s one k-means per subspace), so every Lloyd iteration of
every subspace is one kernel launch.  Codebooks are trained on coarse
residuals (``x - coarse_center(cell(x))``).

Encoding and the lookup tables are plain tensor code (the JAX package
leaves them to XLA's einsum too).  Encoding is pointwise per row, so an
index streamed chunk by chunk encodes to the bytes an in-memory build
produces, whatever the chunk size.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.backend import BackendSpec
from repro_torch.core.device import make_generator
from repro_torch.core.kmeans import kmeans_batched
from repro_torch.core.metrics import map_row_blocks

from .spec import PQSpec

# row block of the bounded-memory encode: one (block, m, C) f32 tensor of
# dot products (256 MiB at m = 64, C = 256; the expression holds two such
# tensors at once) whatever the chunk size
ENCODE_BLOCK = 16384


def split_subspaces(x: torch.Tensor, n_subspaces: int) -> torch.Tensor:
    """(n, d) -> (m, n, d/m), contiguous: the subspaces as the batch axis
    of one k-means (the kernels take rows of contiguous coordinates)."""
    n, d = x.shape
    if d % n_subspaces:
        raise ValueError(
            f"split_subspaces: n_subspaces={n_subspaces} does not divide "
            f"d={d}")
    return x.reshape(n, n_subspaces, d // n_subspaces).transpose(0, 1
                                                                 ).contiguous()


def train_codebooks(residuals: torch.Tensor, pq: PQSpec,
                    seed: "int | torch.Generator", *,
                    backend: BackendSpec = None) -> torch.Tensor:
    """Train the (n_subspaces, 2**bits, d_sub) codebooks: one weighted
    k-means per subspace, all subspaces as lanes of one batched fit (one
    kernel launch per Lloyd iteration for all of them).  ``residuals`` are
    the training rows already reduced by their coarse center."""
    sub = split_subspaces(residuals.float(), pq.n_subspaces)
    weights = torch.ones(sub.shape[:2], device=sub.device)
    return kmeans_batched(sub, pq.n_codes, weights=weights,
                          generator=make_generator(seed, sub.device),
                          init="kmeans++", backend=backend, restarts=1,
                          stop=pq.effective_stop).centers


def encode_residuals(residuals: torch.Tensor, codebooks: torch.Tensor, *,
                     block: Optional[int] = ENCODE_BLOCK) -> torch.Tensor:
    """(n, d) residuals -> (n, n_subspaces) uint8 codes: per-subspace
    nearest codebook entry (ties to the lowest), ``block`` rows at a time
    (O(block · m · C) working set; values identical to the dense call)."""
    m, c, ds = codebooks.shape
    cb = codebooks.float()
    cb2 = (cb * cb).sum(-1)                               # (m, C)

    def dense(rows: torch.Tensor) -> torch.Tensor:
        r = rows.float().reshape(rows.shape[0], m, ds)
        dots = torch.einsum("nms,mcs->nmc", r, cb)
        d2 = (r * r).sum(-1)[..., None] + cb2[None]
        d2 -= dots.mul_(2.0)                  # |r|^2 + |c|^2 - 2 r.c
        return d2.argmin(-1).to(torch.uint8)

    return map_row_blocks(residuals, dense, block)


def decode(cells: torch.Tensor, codes: torch.Tensor,
           coarse_centers: torch.Tensor,
           codebooks: torch.Tensor) -> torch.Tensor:
    """Reconstruct (n, d) approximate vectors: coarse center plus the
    per-subspace codebook entries."""
    m, c, ds = codebooks.shape
    sub = codebooks[torch.arange(m, device=codes.device)[None, :],
                    codes.long()]                         # (n, m, ds)
    return (coarse_centers[cells.long()]
            + sub.reshape(codes.shape[0], m * ds).float())


def build_luts(queries: torch.Tensor, probe_cells: torch.Tensor,
               coarse_centers: torch.Tensor,
               codebooks: torch.Tensor) -> torch.Tensor:
    """ADC lookup tables: (Q, d) queries × (Q, P) probed cells ->
    (Q, P, m, C) f32 with ``lut[q, p, j, c] = ||res_j - codebook[j, c]||²``
    and ``res = query - center(cell p)``: one table per (query, cell) pair,
    shared by every candidate the scan walks in that cell."""
    m, c, ds = codebooks.shape
    cb = codebooks.float()
    qr = (queries.float()[:, None, :]
          - coarse_centers[probe_cells.long()])           # (Q, P, d)
    qs = qr.reshape(qr.shape[0], qr.shape[1], m, ds)      # (Q, P, m, ds)
    dots = torch.einsum("qpms,mcs->qpmc", qs, cb)
    cb2 = (cb * cb).sum(-1)                               # (m, C)
    return ((qs * qs).sum(-1)[..., None] + cb2[None, None]) - 2.0 * dots
