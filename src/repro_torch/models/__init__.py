"""Models of the PyTorch port: the dense decoder-only LM and its decode
attention over a full or a clustered KV cache.

  layers.py     dot, rms_norm, swiglu, RoPE, initialisers
  attention.py  full-cache and clustered-cache decode, compress_kv_cache
  lm.py         AttnBlock, DecoderLM (init_params, init_caches,
                decode_step, head_out)
  registry.py   build_model, cache_kind
"""
from .attention import (AttnDims, attention_decode,
                        attention_decode_clustered, compress_kv_cache,
                        init_clustered_cache, init_kv_cache,
                        window_valid_mask)
from .lm import AttnBlock, DecoderLM
from .registry import build_model, cache_kind

__all__ = ["AttnDims", "AttnBlock", "DecoderLM", "attention_decode",
           "attention_decode_clustered", "build_model", "cache_kind",
           "compress_kv_cache", "init_clustered_cache", "init_kv_cache",
           "window_valid_mask"]
