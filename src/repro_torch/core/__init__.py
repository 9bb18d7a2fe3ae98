"""Core library of the PyTorch port: the paper's parallel sampling-based
clustering, batched over partitions and restarts.

Public API (the names of :mod:`repro.core` that this slice ports):
  ClusterSpec (+ PartitionSpec/LocalSpec/LevelSpec/MergeSpec/ChunkSpec/
               ExecutionSpec/StopSpec)   — declarative job description
  kmeans, KMeansResult                   — weighted Lloyd's algorithm
  kmeans_lloyd_step                      — one exposed Lloyd iteration
  register_init / get_init               — init registry (kmeans++ | random |
                                           landmark | kmeans||)
  register_partitioner / get_partitioner — subclustering registry (equal |
                                           unequal, paper Algorithms 1/2)
  get_backend, register_backend          — LloydBackend registry (torch |
                                           cuda | cuda_fused | cuda_tuned |
                                           auto)
  fit_from_spec                          — spec-driven single-device pipeline
  fit_chunked, ChunkStats                — out-of-core executor over a
                                           DataSource (mode="chunked")
  make_distributed_sampled_kmeans,       — the multi-device executors over a
  DistributedClusteringResult,             repro_torch.launch.mesh.Mesh
  fit_chunked_dist, ChunkDistStats,        (mode="shard_map",
  merge_pool_distributed                   mode="chunked_dist")
  chunk_fold / local_stage / reduce_pool / merge_pool / scale_pass /
  minmax_pass / sse_pass                 — the stages the executors compose
  sampled_kmeans, standard_kmeans        — thin adapters
  sse, min_sqdist, relative_error, clustering_accuracy — metrics

The estimator facade (`SampledKMeans`) lives one level up in
:mod:`repro_torch.api`.
"""
from .backend import (CudaBackend, CudaFusedBackend, CudaTunedBackend,
                      LloydBackend, LloydStats, available_backends,
                      get_backend, register_backend)
from .distributed import (ChunkDistStats, DistributedClusteringResult,
                          fit_chunked_dist, make_distributed_sampled_kmeans,
                          merge_pool_distributed)
from .kmeans import (KMeansResult, available_inits, get_init, kmeans,
                     kmeans_batched, kmeans_lloyd_step, kmeans_parallel_init,
                     kmeans_pp_init, landmark_init, pairwise_sqdist,
                     random_init, register_init, update_centers)
from .metrics import (clustering_accuracy, map_row_blocks, min_sqdist,
                      relative_error, sse)
from .pipeline import (ChunkStats, SampledClusteringResult, chunk_fold,
                       fit_chunked, fit_from_spec, local_stage, merge_pool,
                       minmax_pass, reduce_pool, sampled_kmeans, scale_pass,
                       sse_pass, standard_kmeans)
from .spec import (ChunkSpec, ClusterSpec, ExecutionSpec, LevelSpec,
                   LocalSpec, MergeSpec, PartitionSpec, StopSpec)
from .subcluster import (Partition, available_partitioners, equal_partition,
                         feature_scale, gather_partitions, get_partitioner,
                         register_partitioner, unequal_landmarks,
                         unequal_partition, unscale)

__all__ = [
    "ClusterSpec", "PartitionSpec", "LocalSpec", "MergeSpec",
    "ExecutionSpec", "LevelSpec", "ChunkSpec", "StopSpec",
    "KMeansResult", "kmeans", "kmeans_batched", "kmeans_lloyd_step",
    "kmeans_pp_init",
    "kmeans_parallel_init", "landmark_init", "random_init",
    "pairwise_sqdist", "register_init", "get_init", "available_inits",
    "update_centers",
    "Partition", "equal_partition", "unequal_partition",
    "register_partitioner", "get_partitioner", "available_partitioners",
    "feature_scale", "unscale", "gather_partitions", "unequal_landmarks",
    "SampledClusteringResult", "fit_from_spec", "sampled_kmeans",
    "standard_kmeans", "local_stage", "reduce_pool", "chunk_fold",
    "merge_pool", "ChunkStats", "fit_chunked", "scale_pass", "minmax_pass",
    "sse_pass", "sse", "min_sqdist", "map_row_blocks", "relative_error",
    "clustering_accuracy", "LloydBackend", "CudaBackend", "CudaFusedBackend",
    "CudaTunedBackend",
    "LloydStats", "DistributedClusteringResult",
    "make_distributed_sampled_kmeans", "ChunkDistStats", "fit_chunked_dist",
    "merge_pool_distributed",
    "get_backend", "register_backend", "available_backends",
]
