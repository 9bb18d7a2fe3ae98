"""Models of the PyTorch port: the decoder-only LMs built from the
attention block (dense, gemma's local/global pattern, MoE, the VLM
backbone), the recurrent ones (xlstm's mLSTM/sLSTM, zamba2's Mamba2
with a shared attention block) and whisper's encoder-decoder, their
chunked forward and loss, and decode over a full, a sliding-window or a
clustered KV cache or a recurrent state.

  layers.py     dot, rms_norm, swiglu, cross_entropy, RoPE, initialisers
  attention.py  chunked attention (``models.attention.attention``: the
                package's ``attention`` is the module); full-cache,
                window and clustered decode; compress_kv_cache
  moe.py        routed experts with sort/gather dispatch (moe_ffn,
                moe_ffn_decode)
  ssm.py        chunked_lin_attn, lin_attn_step; MLSTMBlock, SLSTMBlock,
                Mamba2Block (causal_conv, conv_history)
  lm.py         AttnBlock, GemmaSuper, XLSTMSuper, ZambaSuper, DecoderLM
                (init_params, forward, loss, init_caches, decode_step,
                head_out)
  encdec.py     EncBlock, DecBlock, EncDecLM (encode, forward, loss,
                loss_embedded, init_caches, decode_step)
  registry.py   build_model, cache_kind, input_specs, batch_like
"""
from .attention import (AttnDims, attention_decode,
                        attention_decode_clustered, attention_decode_window,
                        compress_kv_cache, init_clustered_cache,
                        init_kv_cache, init_window_cache, window_valid_mask)
from .encdec import DecBlock, EncBlock, EncDecLM
from .lm import AttnBlock, DecoderLM, GemmaSuper, XLSTMSuper, ZambaSuper
from .moe import moe_ffn, moe_ffn_decode
from .registry import batch_like, build_model, cache_kind, input_specs
from .ssm import (Mamba2Block, MLSTMBlock, SLSTMBlock, chunked_lin_attn,
                  lin_attn_step)

__all__ = ["AttnDims", "AttnBlock", "DecBlock", "DecoderLM", "EncBlock",
           "EncDecLM", "GemmaSuper",
           "Mamba2Block", "MLSTMBlock", "SLSTMBlock", "XLSTMSuper",
           "ZambaSuper", "attention_decode", "attention_decode_clustered",
           "attention_decode_window", "batch_like", "build_model",
           "cache_kind", "input_specs",
           "chunked_lin_attn", "compress_kv_cache", "init_clustered_cache",
           "init_kv_cache", "init_window_cache", "lin_attn_step", "moe_ffn",
           "moe_ffn_decode", "window_valid_mask"]
