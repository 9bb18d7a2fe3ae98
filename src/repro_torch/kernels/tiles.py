"""The GPU tile contract of the port's kernels — ONE place for the launch
shapes that ``csrc/assign.cu`` and ``csrc/lloyd.cu`` are given, and for the
checks their wrappers make before a launch.

  * One point per thread, ``THREADS`` points per tile: ragged M is masked
    in the kernel, so the points are never padded.
  * The point is held in ``register_dim(d)`` registers (the next power of
    two from 2 to 128, zero-filled past ``d``); a wider ``d`` reads the
    point from device memory instead (``register_dim`` returns 0).  There
    is no 128-lane padding of ``d``: at the paper's ``d=2`` the kernel does
    the work of ``d=2``.
  * Centers are staged in shared memory ``center_tile(k, d)`` at a time;
    ragged K is never visited.
  * The Lloyd kernel runs ``lloyd_blocks(...)`` blocks per batch entry and
    keeps each block's (K, d+1) accumulator in shared memory when
    ``acc_in_smem(k, d)``.

A shape outside the contract raises :class:`TileError` (a ``ValueError``)
before anything is launched.
"""
from __future__ import annotations

import torch

THREADS = 256                     # threads per block = points per tile
REGISTER_DIMS = (2, 4, 8, 16, 32, 64, 128)
CENTER_SMEM_BYTES = 48 * 1024     # shared memory for one staged center tile
ACC_SMEM_BYTES = 96 * 1024        # largest accumulator kept in shared memory
SCRATCH_BYTES = 256 * 2 ** 20     # bound on the Lloyd kernel's partials
BLOCKS_PER_SM = 4                 # Lloyd blocks the grid aims at per SM
MAX_BATCH = 65535                 # the grid's y extent


class TileError(ValueError):
    """A kernel was handed a shape its launch contract cannot cover.
    Carries the offending ``(extent, block)`` pair."""

    def __init__(self, message: str, *, extent: int = 0, block: int = 0):
        super().__init__(message)
        self.extent = extent
        self.block = block


def register_dim(d: int) -> int:
    """Registers that hold one point: the smallest of ``REGISTER_DIMS``
    that is >= ``d``, or 0 when ``d`` exceeds them all."""
    for r in REGISTER_DIMS:
        if d <= r:
            return r
    return 0


def center_stride(d: int) -> int:
    """Floats per staged center (coordinates, then |c|^2, float4-padded
    when the point is held in registers) — ``center_stride`` in
    ``csrc/distance.cuh``."""
    dp = register_dim(d)
    return (dp + 4) // 4 * 4 if dp else d + 1


def center_tile(k: int, d: int) -> int:
    """Centers staged per tile: all ``k`` when they fit in
    ``CENTER_SMEM_BYTES``, else as many as fit."""
    bk = min(k, CENTER_SMEM_BYTES // (4 * center_stride(d)))
    if bk < 1:
        raise TileError(
            f"d={d}: one center does not fit the {CENTER_SMEM_BYTES}-byte "
            f"shared-memory tile", extent=d, block=CENTER_SMEM_BYTES // 4)
    return bk


def acc_in_smem(k: int, d: int) -> bool:
    """Whether the Lloyd kernel keeps a block's (K, d) sums and (K,) counts
    in shared memory (else in its slice of the global scratch)."""
    return 4 * k * (d + 1) <= ACC_SMEM_BYTES


def lloyd_blocks(b: int, m: int, k: int, d: int, sm_count: int) -> int:
    """Blocks per batch entry of the Lloyd kernel: enough for about
    ``BLOCKS_PER_SM`` blocks on every SM, never more than the entry has
    tiles, and few enough that the (B, G, K, d+1) partials stay within
    ``SCRATCH_BYTES``."""
    n_tiles = -(-m // THREADS)
    g = min(n_tiles, max(1, -(-BLOCKS_PER_SM * sm_count // b)))
    return max(1, min(g, SCRATCH_BYTES // (4 * b * k * (d + 1))))


def check_inputs(kernel: str, x, c, w=None) -> tuple[int, int, int, int]:
    """Validate a kernel call: ``x`` (B, M, d), ``c`` (B, K, d) and ``w``
    (B, M), each f32 or bf16, on one device, each row contiguous (the batch
    stride is free, so ``expand`` may share one point set across restarts).
    Returns ``(B, M, K, d)``; raises ``TypeError`` / ``ValueError`` /
    :class:`TileError` on anything else."""
    ok = (torch.float32, torch.bfloat16)
    named = [("x", x), ("c", c)] + ([("w", w)] if w is not None else [])
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{kernel}: {name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.dtype not in ok:
            raise TypeError(f"{kernel}: {name} must be float32 or bfloat16, "
                            f"got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, x on "
                             f"{x.device}")
    if x.dim() != 3 or c.dim() != 3:
        raise ValueError(f"{kernel}: x must be (B, M, d) and c (B, K, d), "
                         f"got {tuple(x.shape)} and {tuple(c.shape)}")
    b, m, d = x.shape
    k = c.shape[1]
    if c.shape[0] != b or c.shape[2] != d:
        raise ValueError(f"{kernel}: c {tuple(c.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if w is not None and tuple(w.shape) != (b, m):
        raise ValueError(f"{kernel}: w must be {(b, m)}, got "
                         f"{tuple(w.shape)}")
    if min(b, m, k, d) < 1:
        raise ValueError(f"{kernel}: empty input (B, M, K, d) = "
                         f"{(b, m, k, d)}")
    if b > MAX_BATCH:
        raise TileError(f"{kernel}: batch {b} exceeds the grid's "
                        f"{MAX_BATCH}", extent=b, block=MAX_BATCH)
    rows = [("x", x, m, d), ("c", c, k, d)]
    for name, t, n, width in rows:
        if (width > 1 and t.stride(2) != 1) or (n > 1 and t.stride(1) != width):
            raise ValueError(f"{kernel}: {name} rows must be contiguous "
                             f"(strides {t.stride()})")
    if w is not None and m > 1 and w.stride(1) != 1:
        raise ValueError(f"{kernel}: w rows must be contiguous (strides "
                         f"{w.stride()})")
    return b, m, k, d
