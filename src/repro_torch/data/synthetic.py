"""Synthetic data for the PyTorch port.

``blobs`` is a copy of the JAX package's generator (numpy only), so the
port's tests, ``chip_smoke.py`` and the JAX package build the same points
from the same seed.
"""
from __future__ import annotations

import numpy as np


def blobs(n_points: int, n_clusters: int | None = None, dim: int = 2,
          seed: int = 0, spread: float = 0.04):
    """Paper-style synthetic set: ~500 points per cluster.  Returns numpy
    ``(points (n, dim) f32, labels (n,), centers (n_clusters, dim) f32)``."""
    if n_clusters is None:
        n_clusters = max(2, n_points // 500)
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.0, 10.0, (n_clusters, dim))
    sizes = np.full(n_clusters, n_points // n_clusters)
    sizes[: n_points - sizes.sum()] += 1
    pts = np.concatenate([
        rng.normal(c, spread * 10.0, (s, dim))
        for c, s in zip(centers, sizes)]).astype(np.float32)
    labels = np.repeat(np.arange(n_clusters), sizes)
    perm = rng.permutation(n_points)
    return pts[perm], labels[perm], centers.astype(np.float32)
