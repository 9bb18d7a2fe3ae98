"""Serving on the PyTorch port: :class:`ServeEngine` (prefill + decode with
the clustered-KV refresh), :class:`ServeConfig`, ``resolve_recompress`` and
the offline ``build_clustered_cache_from_full``."""
from .engine import (ServeConfig, ServeEngine, build_clustered_cache_from_full,
                     resolve_recompress)

__all__ = ["ServeConfig", "ServeEngine", "build_clustered_cache_from_full",
           "resolve_recompress"]
