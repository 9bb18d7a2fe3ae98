"""Streaming pieces of the PyTorch port.  Ported so far: the incremental
clustered-KV decode-cache refresh (used by :mod:`repro_torch.serve`).  The
streaming clusterer (``StreamingClusterer`` and its stages) is still to
port (ROADMAP §1)."""
from .kv import refresh_clustered_cache, refresh_layer_cache

__all__ = ["refresh_clustered_cache", "refresh_layer_cache"]
