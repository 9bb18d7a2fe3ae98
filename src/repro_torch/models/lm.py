"""Decoder-only LM of the port: embeddings -> a stack of attention blocks
-> head (the counterpart of :mod:`repro.models.lm` for the dense, non-MoE
branch of ``make_attn_block``).

Parameters keep the JAX package's layouts and names: ``embed`` (Vp, d),
``final_ln`` (d,), ``head`` (d, Vp), and per layer ``ln1``, ``attn.wq`` ...
``attn.wo``, ``ln2``, ``w1``, ``w3``, ``w2``, each (d_in, d_out), so
:func:`repro_torch.convert.lm_params_from_jax` carries a JAX-package
parameter tree across by name.  Decode caches are the reference's stacked
``(L, B, kv, ...)`` tensors under the group name ``"blocks"``; a decode
step is a Python loop over the layers that updates them in place.

Still to port (ROADMAP): gemma's local/global groups, MoE, xLSTM, Zamba,
the VLM patches, and the chunked forward / loss.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs import ArchConfig, ShapeConfig
from repro_torch.core.device import derive_seed, resolve_device, seed_of

from .attention import (AttnDims, attention_decode,
                        attention_decode_clustered, init_clustered_cache,
                        init_kv_cache)
from .layers import ninit_, rms_norm, rope_tables, swiglu

CACHE_KINDS = ("full", "clustered")


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


class AttnBlock(nn.Module):
    """Pre-norm GQA attention + SwiGLU FFN, one layer (the dense branch of
    the JAX package's ``make_attn_block``)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device):
        super().__init__()
        d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
        self.dims = AttnDims(h, kv, dh)
        self.eps = cfg.norm_eps
        self.ln1 = _param((d,), dtype, device)
        self.attn = nn.ParameterDict({
            "wq": _param((d, h * dh), dtype, device),
            "wk": _param((d, kv * dh), dtype, device),
            "wv": _param((d, kv * dh), dtype, device),
            "wo": _param((h * dh, d), dtype, device)})
        self.ln2 = _param((d,), dtype, device)
        self.w1 = _param((d, cfg.d_ff), dtype, device)
        self.w3 = _param((d, cfg.d_ff), dtype, device)
        self.w2 = _param((cfg.d_ff, d), dtype, device)

    def projections(self) -> list[torch.Tensor]:
        """The weights drawn at ``d_in ** -0.5`` (the norms start at 0)."""
        return [*self.attn.values(), self.w1, self.w3, self.w2]

    def decode(self, cache_l: dict, x: torch.Tensor, ctx: dict
               ) -> tuple[torch.Tensor, dict]:
        xn = rms_norm(x, self.ln1, self.eps)
        if ctx["cache_kind"] == "clustered":
            a, cache_l = attention_decode_clustered(self.attn, cache_l, xn,
                                                    self.dims, ctx)
        else:
            a, cache_l = attention_decode(self.attn, cache_l, xn, self.dims,
                                          ctx)
        h = x + a
        hn = rms_norm(h, self.ln2, self.eps)
        return h + swiglu(hn, self.w1, self.w3, self.w2), cache_l


class DecoderLM(nn.Module):
    """Decoder-only LM built from :class:`AttnBlock` layers, on ``device``
    (``None``: the CUDA device).  Weights are zero until
    :meth:`init_params` draws them or a state dict is loaded."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.embed = _param((cfg.padded_vocab, cfg.d_model), self.dtype, dev)
        self.final_ln = _param((cfg.d_model,), self.dtype, dev)
        if not cfg.tie_embeddings:
            self.head = _param((cfg.d_model, cfg.padded_vocab), self.dtype,
                               dev)
        self.blocks = nn.ModuleList(AttnBlock(cfg, self.dtype, dev)
                                    for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- params ------------------------------------------------------------
    def init_params(self, seed: "int | torch.Generator" = 0) -> "DecoderLM":
        """Draw every weight at the JAX package's scales (embeddings 0.02,
        projections ``d_in ** -0.5``, norms 0), each tensor from its own
        generator seeded from ``seed``; returns ``self``."""
        base = seed_of(seed)
        projections = [] if self.cfg.tie_embeddings else [self.head]
        projections += [w for blk in self.blocks for w in blk.projections()]
        scaled = [(self.embed, 0.02)] + [(w, w.shape[0] ** -0.5)
                                         for w in projections]
        for i, (w, scale) in enumerate(scaled):
            gen = torch.Generator(device=w.device)
            gen.manual_seed(derive_seed(base, i))
            ninit_(w, gen, scale)
        return self

    # -- decode ------------------------------------------------------------
    def init_caches(self, b: int, shape: ShapeConfig, kind: str) -> dict:
        """Zeroed decode caches for batch ``b`` at ``shape``: ``"full"``
        (capacity ``shape.seq_len``) or ``"clustered"``
        (``seq_len // cluster_compression`` centroids beside a
        ``cluster_window`` ring)."""
        cfg = self.cfg
        dims = AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.dh)
        if kind == "clustered":
            nc = shape.seq_len // shape.cluster_compression
            cache = init_clustered_cache(cfg.n_layers, b, nc,
                                         shape.cluster_window, dims,
                                         self.dtype, self.device)
        elif kind == "full":
            cache = init_kv_cache(cfg.n_layers, b, shape.seq_len, dims,
                                  self.dtype, self.device)
        else:
            raise ValueError(f"unknown cache kind {kind!r}; known: "
                             f"{CACHE_KINDS}")
        return {"blocks": cache}

    def head_out(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and the vocabulary projection, f32 logits computed
        from the activations and the head in their own type, with no
        rounding of the product to that type (the reference's
        ``dot_general(..., preferred_element_type=f32)``).  On CUDA the
        product reads the head once and writes f32; on the CPU it is the
        f32 product."""
        xn = rms_norm(x, self.final_ln, self.cfg.norm_eps)
        w = self.embed.T if self.cfg.tie_embeddings else self.head
        x2 = xn.reshape(-1, xn.shape[-1])
        if x2.device.type == "cuda" and x2.dtype != torch.float32:
            logits = torch.mm(x2, w, out_dtype=torch.float32)
        else:
            logits = x2.float() @ w.float()
        return logits.reshape(*xn.shape[:-1], w.shape[-1])

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, caches: dict, pos: int, *,
                    cache_kind: str = "full") -> tuple[torch.Tensor, dict]:
        """tokens: (B, 1) integer ids; ``pos`` the write position.  ->
        (logits (B, 1, Vp) f32, the caches, updated in place)."""
        cfg = self.cfg
        # a device-side fill: a copy from host memory would wait for the
        # queued steps, so the host could not run ahead of the card
        positions = torch.full((1,), pos, device=self.device)
        ctx = {"pos": int(pos), "cache_kind": cache_kind,
               "rope": rope_tables(positions, cfg.dh, cfg.rope_theta)}
        x = self.embed[tokens.long()]
        stack = caches["blocks"]
        for i, blk in enumerate(self.blocks):
            cache_l = {name: t[i] for name, t in stack.items()}
            x, _ = blk.decode(cache_l, x, ctx)
        return self.head_out(x), caches
