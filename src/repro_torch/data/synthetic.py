"""Synthetic data for the PyTorch port.

``blobs``, ``drifting_blobs``, ``surrogate_iris``, ``surrogate_seeds`` and
``token_stream`` are copies of the JAX package's generators (numpy only),
so the port's tests, ``chip_smoke.py`` and the JAX package build the same
points and batches from the same seed.  The surrogates stand in for the
paper's accuracy-table data sets (Iris 150 x 4, Seeds 210 x 7, 3 classes
each), which are not available offline.
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


def drifting_blobs(n_chunks: int, chunk_size: int, n_clusters: int = 8,
                   dim: int = 2, seed: int = 0, drift: float = 0.05,
                   spread: float = 0.04):
    """Non-stationary stream for the streaming engine: Gaussian clusters
    whose centers random-walk by ``drift`` per chunk.  Returns numpy
    ``(chunks (n_chunks, chunk_size, dim) f32, labels (n_chunks,
    chunk_size), center_traj (n_chunks, n_clusters, dim) f32)``;
    ``center_traj[t]`` is the ground truth while chunk t was emitted."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.0, 10.0, (n_clusters, dim))
    chunks, labels, traj = [], [], []
    for _ in range(n_chunks):
        centers = centers + rng.normal(0.0, drift, centers.shape)
        ids = rng.integers(0, n_clusters, chunk_size)
        pts = centers[ids] + rng.normal(0.0, spread * 10.0, (chunk_size, dim))
        chunks.append(pts.astype(np.float32))
        labels.append(ids)
        traj.append(centers.astype(np.float32).copy())
    return np.stack(chunks), np.stack(labels), np.stack(traj)


def surrogate_iris(seed: int = 0):
    """150 x 4, 3 classes; one pair of classes overlaps (like versicolor /
    virginica) so the clustering problem has the same character.  Returns
    numpy ``(points (150, 4) f32, labels (150,))``."""
    rng = np.random.default_rng(seed)
    mus = np.array([[5.0, 3.4, 1.5, 0.2],
                    [5.9, 2.8, 4.3, 1.3],
                    [6.6, 3.0, 5.6, 2.0]])
    sds = np.array([[0.35, 0.38, 0.17, 0.10],
                    [0.52, 0.31, 0.47, 0.20],
                    [0.64, 0.32, 0.55, 0.27]])
    x = np.concatenate([rng.normal(m, s, (50, 4)) for m, s in zip(mus, sds)])
    y = np.repeat(np.arange(3), 50)
    perm = rng.permutation(150)
    return x[perm].astype(np.float32), y[perm]


def surrogate_seeds(seed: int = 0):
    """210 x 7, 3 classes (wheat kernel geometry style: correlated
    features).  Returns numpy ``(points (210, 7) f32, labels (210,))``."""
    rng = np.random.default_rng(seed)
    mus = np.array([
        [14.3, 14.3, 0.880, 5.51, 3.24, 2.67, 5.09],
        [18.3, 16.1, 0.885, 6.14, 3.68, 3.60, 6.02],
        [11.9, 13.2, 0.849, 5.23, 2.85, 4.83, 5.12]])
    sds = np.array([
        [1.21, 0.57, 0.016, 0.23, 0.18, 1.17, 0.26],
        [1.44, 0.62, 0.012, 0.27, 0.19, 1.25, 0.25],
        [0.72, 0.34, 0.022, 0.14, 0.15, 1.34, 0.16]])
    x = np.concatenate([rng.normal(m, s, (70, 7)) for m, s in zip(mus, sds)])
    y = np.repeat(np.arange(3), 70)
    perm = rng.permutation(210)
    return x[perm].astype(np.float32), y[perm]


def token_stream(step: int, global_batch: int, seq_len: int, vocab: int,
                 seed: int = 0):
    """Deterministic batch for a given step (structured enough for a language
    model to reduce loss on: a noisy order-2 markov-ish process).  Returns
    numpy ``{"tokens", "labels"}``, each (global_batch, seq_len) int32."""
    rng = np.random.default_rng((seed * 1_000_003 + step) % (2 ** 63))
    base = rng.integers(0, vocab, (global_batch, seq_len + 1), dtype=np.int64)
    # inject learnable structure: token_{t+1} = (token_t + delta) % vocab on
    # 70% of positions
    delta = rng.integers(1, 17)
    mask = rng.random((global_batch, seq_len)) < 0.7
    nxt = (base[:, :-1] + delta) % vocab
    base[:, 1:][mask] = nxt[mask]
    tokens = base[:, :-1].astype(np.int32)
    labels = base[:, 1:].astype(np.int32)
    return {"tokens": tokens, "labels": labels}
