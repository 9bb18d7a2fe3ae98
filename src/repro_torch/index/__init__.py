"""``repro_torch.index`` — IVF/PQ approximate-nearest-neighbour search built
from the paper's clustering pipeline; the port's counterpart of
:mod:`repro.index`.

The coarse quantizer is an ordinary ClusterSpec job (the Lloyd kernel),
the PQ codebooks are one batched k-means over the subspaces, cells are
routed by the assignment kernel, and queries run through the ADC scan
kernel (:mod:`repro_torch.kernels.scan`).

    from repro_torch.index import IndexSpec, build_index

    spec = IndexSpec.make(nlist=256, n_subspaces=16, bits=8, nprobe=8)
    index, stats = build_index(source, spec)        # on the CUDA device
    dists, ids = index.search(queries, k=10)        # (Q, k) each
"""
from .ivf import (IndexBuildStats, IndexPlan, IVFIndex, build_index,
                  exact_search, plan_index, recall_at_k, search)
from .pq import (build_luts, decode, encode_residuals, split_subspaces,
                 train_codebooks)
from .spec import IndexSpec, PQSpec

__all__ = [
    "IndexSpec", "PQSpec", "IndexPlan", "IVFIndex", "IndexBuildStats",
    "plan_index", "build_index", "search", "exact_search", "recall_at_k",
    "train_codebooks", "encode_residuals", "decode", "split_subspaces",
    "build_luts",
]
