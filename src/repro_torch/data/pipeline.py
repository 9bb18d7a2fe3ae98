"""Data pipeline with the paper's clustering applied to batch composition
(the counterpart of :mod:`repro.data.pipeline`).

``ClusterBalancedSampler`` builds document *sketches* (hashed bag-of-token
counts, normalised), runs the paper's two-level sampled k-means over them
on the device, assigns every document to its nearest center, and then
draws batches cluster-uniformly: rare clusters are not swamped by
near-duplicate documents (the sampled-clustering form of dedup and
mixture balancing).  The draws are deterministic in (seed, step), so a
restarted trainer replays the stream with no iterator state to save.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import ClusterSpec, get_backend, sampled_kmeans
from repro_torch.core.device import resolve_device

HASH_MULT = 2654435761
ASSIGN_BLOCK = 65_536      # rows a block of the plain assignment


def doc_sketch(tokens, dim: int = 32, *,
               device: "torch.device | str | None" = None) -> torch.Tensor:
    """(n_docs, seq) integer tokens -> (n_docs, dim) f32 sketches on
    ``device`` (``None``: the CUDA device): each token hashed to
    ``(t * 2654435761 mod 2^31) mod dim``, the bins counted per document
    (exact integers), each row divided by its norm (at least 1e-6)."""
    dev = resolve_device(device)
    t = torch.as_tensor(tokens, device=dev)
    n, s = t.shape
    h = (t.long() * HASH_MULT % 2 ** 31) % dim
    flat = (h + dim * torch.arange(n, device=dev)[:, None]).reshape(-1)
    out = torch.zeros(n * dim, dtype=torch.float32, device=dev).index_add_(
        0, flat, torch.ones(n * s, dtype=torch.float32, device=dev))
    out = out.view(n, dim)
    norms = torch.linalg.vector_norm(out, dim=1, keepdim=True)
    return out / norms.clamp_min(1e-6)


class ClusterBalancedSampler:
    """Cluster a corpus of documents once (the paper's pipeline, on
    ``device``; ``None``: the CUDA device), then sample batches uniformly
    over the clusters.

    ``docs_tokens`` is the (n_docs, seq) numpy corpus; batches come from
    it on the host.  Without ``spec`` the fit is ``ClusterSpec.make(
    n_clusters or 16, scheme="equal", n_sub=n_sub,
    compression=compression)``; with one, ``n_clusters`` must be its
    ``merge.k`` or ``None``.  Each document goes to its nearest fitted
    center by ``spec.execution.backend``'s assignment (ties to the lowest
    index).  ``centers`` holds the fitted centers, ``assignment`` each
    document's cluster (int32), ``by_cluster`` the document ids of every
    non-empty cluster in increasing order."""

    def __init__(self, docs_tokens: np.ndarray, n_clusters: Optional[int] = None,
                 *, n_sub: int = 8, compression: int = 5, seed: int = 0,
                 spec: Optional[ClusterSpec] = None,
                 device: "torch.device | str | None" = None):
        dev = resolve_device(device)
        self.docs = docs_tokens
        sketches = doc_sketch(docs_tokens, device=dev)
        if spec is None:
            spec = ClusterSpec.make(16 if n_clusters is None else n_clusters,
                                    scheme="equal", n_sub=n_sub,
                                    compression=compression)
        elif n_clusters is not None and n_clusters != spec.merge.k:
            raise ValueError(f"n_clusters={n_clusters} disagrees with "
                             f"spec.merge.k={spec.merge.k}")
        res = sampled_kmeans(sketches, spec.merge.k, spec=spec, seed=seed,
                             device=dev)
        self.centers = res.centers
        idx, _ = get_backend(spec.execution.backend, device=dev
                             ).assign_points(sketches, res.centers,
                                             block=ASSIGN_BLOCK)
        self.assignment = idx.cpu().numpy()
        self.n_clusters = spec.merge.k
        order = np.argsort(self.assignment, kind="stable")
        sizes = np.bincount(self.assignment, minlength=self.n_clusters)
        self.by_cluster = [ids for ids in np.split(order, np.cumsum(sizes)[:-1])
                           if len(ids)]
        self.seed = seed

    def batch_indices(self, step: int, batch_size: int) -> np.ndarray:
        """``batch_size`` document ids for ``step``: a cluster drawn
        uniformly, then a document of it drawn uniformly, for each."""
        rng = np.random.default_rng((self.seed * 7_919 + step) % 2 ** 63)
        cl = rng.integers(0, len(self.by_cluster), batch_size)
        return np.array([
            self.by_cluster[c][rng.integers(0, len(self.by_cluster[c]))]
            for c in cl])

    def batch(self, step: int, batch_size: int, seq_len: int) -> dict:
        """numpy ``{"tokens", "labels"}``, each (batch_size, seq_len)
        int32: the first ``seq_len + 1`` tokens of each drawn document,
        shifted by one."""
        ids = self.batch_indices(step, batch_size)
        toks = self.docs[ids, : seq_len + 1].astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
