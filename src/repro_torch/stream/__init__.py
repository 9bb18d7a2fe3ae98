"""Streaming sampled clustering in the PyTorch port — the paper's pipeline
run continuously.

Public API (the names of :mod:`repro.stream` that the port has):
  StreamConfig, StreamState, StreamingClusterer — the online engine
      (init / update / query); ``StreamConfig.from_spec`` derives the
      config from a ``ClusterSpec`` (``StreamingClusterer`` and
      ``SampledKMeans.partial_fit`` also accept one)
  summarize_chunk, fold_coreset, reseed_dead_centers, fold_and_merge
      — the engine's stages
  make_sharded_update — one update over a device mesh, the chunk split
      across the shards (:mod:`repro_torch.stream.distributed`)
  refresh_clustered_cache, refresh_layer_cache — the incremental
      clustered-KV decode-cache refresh (used by repro_torch.serve)
"""
from .distributed import make_sharded_update
from .engine import (StreamConfig, StreamState, StreamingClusterer,
                     fold_and_merge, fold_coreset, reseed_dead_centers,
                     summarize_chunk)
from .kv import refresh_clustered_cache, refresh_layer_cache

__all__ = [
    "StreamConfig", "StreamState", "StreamingClusterer", "summarize_chunk",
    "fold_coreset", "reseed_dead_centers", "fold_and_merge",
    "make_sharded_update",
    "refresh_clustered_cache", "refresh_layer_cache",
]
