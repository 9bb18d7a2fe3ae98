"""Clustering quality metrics — the port's counterpart of
:mod:`repro.core.metrics`.

Plain PyTorch (``torch.matmul`` for the cross term), as the JAX package
leaves them to XLA.  The nearest-center reductions support **blocked**
evaluation (``block=``): the (N, K) distance matrix never materialises —
fixed-size row blocks are walked one at a time, so peak memory is
O(block · K) regardless of N.  Per-row results are independent, so the
blocked path returns the same values as the dense one.
"""
from __future__ import annotations

import numpy as np
import torch


def _min_sqdist_dense(x: torch.Tensor, centers: torch.Tensor
                      ) -> torch.Tensor:
    """(m, d) -> (m,) squared distance to the nearest center (clamped)."""
    d = ((x * x).sum(-1, keepdim=True) + (centers * centers).sum(-1)[None, :]
         - 2.0 * (x @ centers.T))
    return d.amin(-1).clamp_min(0.0)


def map_row_blocks(x: torch.Tensor, fn, block: int | None) -> torch.Tensor:
    """Apply a row-wise ``fn((b, d)) -> (b, ...)`` over ``x`` in
    ``block``-row pieces and concatenate.  Row results must be independent
    (every consumer here is a per-row reduction against a fixed center
    set).  ``block=None`` (or ``m <= block``) is the dense path."""
    m = x.shape[0]
    if block is None or m <= block:
        return fn(x)
    return torch.cat([fn(x[i:i + block]) for i in range(0, m, block)])


def min_sqdist(x: torch.Tensor, centers: torch.Tensor, *,
               block: int | None = None) -> torch.Tensor:
    """Nearest-center squared distance per point; ``block`` bounds the
    working set at O(block · k) (see :func:`map_row_blocks`)."""
    return map_row_blocks(x, lambda b: _min_sqdist_dense(b, centers), block)


def sse(x: torch.Tensor, centers: torch.Tensor,
        weights: torch.Tensor | None = None, *,
        block: int | None = None) -> torch.Tensor:
    """Weighted sum of squared distances to the nearest center — the
    paper's accuracy number.  ``block`` bounds the working set at
    O(block · k)."""
    mind = min_sqdist(x, centers, block=block)
    if weights is not None:
        mind = mind * weights
    return mind.sum()


def relative_error(sse_method: float, sse_baseline: float) -> float:
    """Paper-style approximation error of a sampled clustering vs full
    k-means."""
    return float((sse_method - sse_baseline) / max(sse_baseline, 1e-12))


def clustering_accuracy(labels_true, labels_pred) -> float:
    """Best label-permutation accuracy (Hungarian matching)."""
    from scipy.optimize import linear_sum_assignment

    labels_true, labels_pred = (
        np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
        for v in (labels_true, labels_pred))
    n = max(labels_true.max() + 1, labels_pred.max() + 1)
    cm = np.zeros((n, n), dtype=np.int64)
    np.add.at(cm, (labels_pred, labels_true), 1)
    row, col = linear_sum_assignment(-cm)
    return float(cm[row, col].sum()) / float(len(labels_true))
