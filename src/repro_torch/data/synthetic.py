"""Synthetic data for the PyTorch port.

``blobs``, ``drifting_blobs`` and ``token_stream`` are copies of the JAX
package's generators (numpy only), so the port's tests, ``chip_smoke.py``
and the JAX package build the same points and batches from the same
seed.
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
