"""Whisper-style encoder-decoder of the port (the counterpart of
:mod:`repro.models.encdec`); the conv/audio frontend is a stub, as in the
reference: the inputs are precomputed frame embeddings.

Encoder (``enc``): bidirectional self-attention over ``encoder_ctx``
frames with sinusoidal positions, no RoPE, then ``enc_ln``.  Decoder
(``dec``): causal self-attention (RoPE), cross attention into the
encoder's output, a SwiGLU FFN.  The parameters keep the reference's
names: ``embed`` (Vp, d), ``head`` (d, Vp, untied), ``final_ln``,
``enc_ln``, per encoder layer ``ln1``, ``attn.wq`` ... ``attn.wo``,
``ln2``, ``w1``, ``w3``, ``w2``, and per decoder layer also ``lnx`` and
``xattn.wq`` ... ``xattn.wo``; so
:func:`repro_torch.convert.lm_params_from_jax` carries the reference's
``enc``/``dec`` stacks across by name.

Decode caches are ``{"self": {k, v: (L, B, kv, seq_len, dh)}, "xk", "xv":
(L, B, kv, encoder_ctx, dh)}``: the decoder's full self-attention cache
and each layer's cross keys and values.  Nothing here fills ``xk``/``xv``
(the reference's engine leaves them zero too); a caller that decodes
against an encoding writes ``blk.cross_kv(encode(frames))`` of each
layer ``blk`` into them, transposed to (B, kv, T, dh).

Over a "model" axis of M positions (a sharded train step's
``ctx["model_split"]``), as :mod:`repro_torch.models.lm`'s blocks: each
layer's self attention and the decoder's cross attention by heads where
M divides ``n_heads`` (the cross attention's keys and values from the
encoder output, which goes to every position as an f32 copy), its SwiGLU
FFN by hidden columns where M divides ``d_ff``, and the untied head by
vocab columns where M divides the padded vocabulary; the norms, the
embedding and the residual streams stay on the data shard's first
position.  Serving (``decode``, ``cross_kv``) runs on one device.
"""
from __future__ import annotations

from typing import Optional

import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ArchConfig, ShapeConfig
from repro_torch.core.device import resolve_device

from .attention import (AttnDims, _cache_attend, attention_decode,
                        init_kv_cache)
from .layers import cross_entropy, dot, param, rms_norm, rope_tables, swiglu
from .lm import (_index, attend, attn_params, attn_regions, draw_weights,
                 ffn_regions, gathered_call, holds, model_parts,
                 model_regions, project_kv, swiglu_over_model, vocab_logits,
                 vocab_parallel_loss, weight_draws)


def _sinusoid(n: int, d: int, device=None) -> torch.Tensor:
    """(n, d) f32 positions: sines of the first d / 2 frequencies, then
    their cosines."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * i / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class _Block(nn.Module):
    """The parameters every layer has: ``ln1``, ``attn``, ``ln2`` and the
    SwiGLU FFN."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device):
        super().__init__()
        d = cfg.d_model
        self.dims = AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.dh)
        self.eps = cfg.norm_eps
        self.ln1 = param((d,), dtype, device)
        self.attn = attn_params(d, self.dims, dtype, device)
        self.ln2 = param((d,), dtype, device)
        self.w1 = param((d, cfg.d_ff), dtype, device)
        self.w3 = param((d, cfg.d_ff), dtype, device)
        self.w2 = param((cfg.d_ff, d), dtype, device)

    def projections(self) -> list[torch.Tensor]:
        """The weights drawn at ``d_in ** -0.5`` (the norms start at 0)."""
        return [*self.attn.values(), self.w1, self.w3, self.w2]

    def split_regions(self, n_model: int) -> dict:
        """``{name within the block: [region a "model" position computes
        with]}``: where M divides the heads, position m's heads' columns
        of ``attn.wq``, ``attn.wk``, ``attn.wv`` and rows of ``attn.wo``
        (:func:`~repro_torch.models.lm.attn_regions`); where M divides
        ``d_ff``, its ``d_ff / M`` columns of ``w1``, ``w3`` and rows of
        ``w2``.  Empty at M = 1."""
        d = self.ln1.shape[0]
        return {**attn_regions(self.dims, d, n_model),
                **ffn_regions(d, self.w1.shape[1], n_model)}

    def ffn(self, h: torch.Tensor, split=None, parts=None) -> torch.Tensor:
        """The residual update by the SwiGLU FFN, over "model" where
        ``parts`` splits ``w1``."""
        hn = rms_norm(h, self.ln2, self.eps)
        if holds(parts, "w1"):
            return h + swiglu_over_model(split, hn, parts, "")
        return h + swiglu(hn, self.w1, self.w3, self.w2)


class EncBlock(_Block):
    """One encoder layer: bidirectional self-attention without RoPE, then
    the FFN; each over "model" where ``ctx["model_split"]`` holds its
    regions (:meth:`split_regions`)."""

    def forward(self, x: torch.Tensor, ctx: dict) -> torch.Tensor:
        split, parts = model_parts(ctx, self)
        h = x + attend(self.attn, rms_norm(x, self.ln1, self.eps), self.dims,
                       ctx, split, parts, causal=False, use_rope=False)
        return self.ffn(h, split, parts)


class DecBlock(_Block):
    """One decoder layer: causal self-attention (RoPE), cross attention
    (``lnx``, ``xattn``) into the encoder's output, then the FFN."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device):
        super().__init__(cfg, dtype, device)
        self.lnx = param((cfg.d_model,), dtype, device)
        self.xattn = attn_params(cfg.d_model, self.dims, dtype, device)

    def projections(self) -> list[torch.Tensor]:
        return [*self.attn.values(), *self.xattn.values(), self.w1, self.w3,
                self.w2]

    def split_regions(self, n_model: int) -> dict:
        """:meth:`_Block.split_regions` and the cross attention's heads'
        columns of ``xattn.wq``, ``xattn.wk``, ``xattn.wv`` and rows of
        ``xattn.wo`` where M divides the heads."""
        return {**super().split_regions(n_model),
                **attn_regions(self.dims, self.lnx.shape[0], n_model,
                               "xattn.")}

    def cross_kv(self, enc: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """This layer's cross keys and values of the encoder output ``enc``
        (B, T, d): each (B, T, kv, dh)."""
        return project_kv(self.xattn, enc, self.dims)

    def forward(self, x: torch.Tensor, enc: torch.Tensor, ctx: dict
                ) -> torch.Tensor:
        """The layer over the tokens ``x`` (B, S, d) and the encoder output
        ``enc`` (B, T, d); each attention and the FFN over "model" where
        ``ctx["model_split"]`` holds its regions (the cross attention's
        keys and values each position's products of ``enc``)."""
        split, parts = model_parts(ctx, self)
        h = x + attend(self.attn, rms_norm(x, self.ln1, self.eps), self.dims,
                       ctx, split, parts)
        h = h + attend(self.xattn, rms_norm(h, self.lnx, self.eps),
                       self.dims, ctx, split, parts, "xattn.", kv=enc,
                       causal=False, use_rope=False)
        return self.ffn(h, split, parts)

    def decode(self, cache_l: dict, xk: torch.Tensor, xv: torch.Tensor,
               x: torch.Tensor, ctx: dict) -> torch.Tensor:
        """One token: the self-attention on the full cache ``cache_l``
        (written in place at ``ctx["pos"]``), the cross attention over all
        of ``xk``/``xv`` (B, kv, T, dh)."""
        b = x.shape[0]
        h, _, dh = self.dims
        a, _ = attention_decode(self.attn, cache_l,
                                rms_norm(x, self.ln1, self.eps), self.dims,
                                ctx)
        x = x + a
        q = dot(rms_norm(x, self.lnx, self.eps), self.xattn["wq"]
                ).reshape(b, 1, h, dh)
        valid = torch.ones(xk.shape[2], dtype=torch.bool, device=x.device)
        out = _cache_attend(q, xk, xv, valid)
        x = x + dot(out.reshape(b, 1, h * dh), self.xattn["wo"])
        return self.ffn(x)


class EncDecLM(nn.Module):
    """Encoder-decoder LM on ``device`` (``None``: the CUDA device): the
    ``enc`` layers over (B, encoder_ctx, d) frames, the ``dec`` layers
    over the tokens.  Weights are zero until :meth:`init_params` draws
    them or a state dict is loaded."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.dims = AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.dh)
        d = cfg.d_model
        self.embed = param((cfg.padded_vocab, d), self.dtype, dev)
        self.head = param((d, cfg.padded_vocab), self.dtype, dev)
        self.final_ln = param((d,), self.dtype, dev)
        self.enc = nn.ModuleList(EncBlock(cfg, self.dtype, dev)
                                 for _ in range(cfg.encoder_layers))
        self.dec = nn.ModuleList(DecBlock(cfg, self.dtype, dev)
                                 for _ in range(cfg.n_layers))
        self.enc_ln = param((d,), self.dtype, dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def draws(self) -> list:
        """(parameter, scale) of every drawn weight in draw order
        (:func:`~repro_torch.models.lm.weight_draws`): embeddings, head,
        encoder layers, decoder layers."""
        return weight_draws(self.embed, [self.head] + [
            w for blk in [*self.enc, *self.dec] for w in blk.projections()])

    def init_params(self, seed: "int | torch.Generator" = 0) -> "EncDecLM":
        """Draw every weight at the JAX package's scales (embeddings 0.02,
        projections ``d_in ** -0.5``; norms 0), each tensor from its own
        generator seeded from ``seed``, in the order of :meth:`draws`;
        returns ``self``."""
        draw_weights(self.draws(), seed)
        return self

    def make_ctx(self, positions: torch.Tensor, *, q_chunk: int = 2048,
                 cache_kind: str = "full", pos: Optional[int] = None
                 ) -> dict:
        """The per-call context: the decoder's RoPE tables at
        ``positions``, the query chunk, and for a decode step the cache
        kind and the write position ``pos``."""
        cfg = self.cfg
        ctx = {"rope": rope_tables(positions, cfg.dh, cfg.rope_theta),
               "q_chunk": q_chunk, "cache_kind": cache_kind}
        if pos is not None:
            ctx["pos"] = int(pos)
        return ctx

    # -- encoder -------------------------------------------------------------
    def encode(self, frames: torch.Tensor, ctx: Optional[dict] = None
               ) -> torch.Tensor:
        """(B, T, d) frame embeddings -> the encoder output (B, T, d) in the
        model's type: the frames plus the sinusoid, each cast to that type
        first, through the ``enc`` layers (queries in chunks of
        ``ctx["q_chunk"]``), then ``enc_ln``."""
        t = frames.shape[1]
        x = (frames.to(self.dtype)
             + _sinusoid(t, self.cfg.d_model, self.device).to(self.dtype))
        ctx = ctx or {}
        ectx = {"rope": (None, None), "q_chunk": ctx.get("q_chunk", 2048)}
        if "model_split" in ctx:
            ectx["model_split"] = ctx["model_split"]
        gather = ctx.get("gather")
        for i, blk in enumerate(self.enc):
            x = (blk(x, ectx) if gather is None
                 else gathered_call(blk, gather, f"enc.{i}", x, ectx))
        return rms_norm(x, self.enc_ln, self.cfg.norm_eps)

    # -- decoder (training, prefill) -------------------------------------------
    def embed_in(self, batch: dict, ctx: Optional[dict] = None
                 ) -> torch.Tensor:
        """The token embeddings (B, S, d) (``ctx``, as the reference's,
        changes nothing here)."""
        return self.embed[batch["tokens"].long()].to(self.dtype)

    def decode_stack(self, x: torch.Tensor, frames: torch.Tensor, ctx: dict,
                     *, remat: bool = True) -> torch.Tensor:
        """The encoder over ``frames``, then the decoder layers over the
        embedded tokens ``x`` -> the last layer's output (B, S, d).  ``remat``
        recomputes each decoder layer in the backward pass (the
        reference's ``jax.checkpoint`` of the decoder's layer; the encoder
        keeps its activations), only where a gradient is being
        recorded.  With ``ctx["gather"]`` (a sharded train step's) each
        layer computes with the weights it gathers: a decoder layer inside
        its checkpointed call, an encoder layer plainly, so the encoder's
        gathered weights live until the backward, as its activations
        do."""
        enc = self.encode(frames, ctx)
        gather = ctx.get("gather")
        remat = remat and torch.is_grad_enabled() and (
            gather is not None or x.requires_grad
            or any(p.requires_grad for p in self.parameters()))
        for i, blk in enumerate(self.dec):
            call = blk if gather is None else functools.partial(
                gathered_call, blk, gather, f"dec.{i}")
            x = (checkpoint(call, x, enc, ctx, use_reentrant=False) if remat
                 else call(x, enc, ctx))
        return x

    def forward(self, batch: dict, ctx: Optional[dict] = None, *,
                remat: bool = True, last_only: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """``batch``: ``tokens`` (B, S) and ``frames`` (B, T, d); ``ctx``
        from :meth:`make_ctx` (default: positions 0 .. S - 1, ``q_chunk``
        2048).  -> (f32 logits (B, S', Vp), a zero aux loss), S' = 1 at
        ``last_only``."""
        if ctx is None:
            ctx = self.make_ctx(torch.arange(batch["tokens"].shape[1],
                                             device=self.device))
        x = self.decode_stack(self.embed_in(batch), batch["frames"], ctx,
                              remat=remat)
        logits = self.head_out(x[:, -1:] if last_only else x)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device)

    def loss(self, batch: dict, ctx: Optional[dict] = None, *,
             remat: bool = True, aux_weight: float = 0.0) -> torch.Tensor:
        """Mean next-token NLL against ``batch["labels"]`` (B, S)."""
        logits, _ = self.forward(batch, ctx, remat=remat)
        return cross_entropy(logits, batch["labels"])

    def loss_embedded(self, x: torch.Tensor, rest: dict, ctx: dict, *,
                      remat: bool = True, aux_weight: float = 0.0
                      ) -> torch.Tensor:
        """:meth:`loss` from tokens already embedded (``x`` from
        :meth:`embed_in`); ``rest`` holds ``frames`` and ``labels``.  Where
        ``ctx["model_split"]`` holds this model's columns of ``head``, the
        head and the loss are computed over "model"
        (:func:`~repro_torch.models.lm.vocab_parallel_loss`)."""
        x = self.decode_stack(x, rest["frames"], ctx, remat=remat)
        split, parts = model_parts(ctx, self)
        if holds(parts, "head"):
            return vocab_parallel_loss(split, parts, x, self.final_ln,
                                       self.cfg.norm_eps, rest["labels"])
        return cross_entropy(self.head_out(x), rest["labels"])

    def split_regions(self, n_model: int) -> dict:
        """``{parameter name: [region a "model" position computes
        with]}`` (:func:`~repro_torch.models.lm.model_regions`): each
        encoder and decoder layer's (:meth:`EncBlock.split_regions`,
        :meth:`DecBlock.split_regions`) under ``enc.i.`` / ``dec.i.``, and
        position m's ``Vp / M`` columns of ``head`` where M divides the
        padded vocabulary.  Empty at M = 1."""
        return model_regions(self, n_model, {
            "head": (self.cfg.d_model, self.cfg.padded_vocab)})

    def head_out(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and the head's f32 logits (:func:`vocab_logits`)."""
        return vocab_logits(x, self.final_ln, self.head, self.cfg.norm_eps)

    # -- decode --------------------------------------------------------------
    def init_caches(self, b: int, shape: ShapeConfig, kind: str) -> dict:
        """Zeroed decode caches for batch ``b``: the decoder's full
        self-attention cache of ``shape.seq_len`` slots and the cross
        keys and values of ``encoder_ctx`` frames.  The decoder has no
        other cache kind (the reference's ``cache_kind`` gives ``"full"``
        for this family at every shape)."""
        if kind != "full":
            raise ValueError(f"{self.cfg.name}: cache kind {kind!r}; the "
                             f"encoder-decoder decodes on the full cache")
        cfg = self.cfg

        def cross():
            return torch.zeros((cfg.n_layers, b, self.dims.n_kv,
                                cfg.encoder_ctx, self.dims.dh),
                               dtype=self.dtype, device=self.device)

        return {"self": init_kv_cache(cfg.n_layers, b, shape.seq_len,
                                      self.dims, self.dtype, self.device),
                "xk": cross(), "xv": cross()}

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, caches: dict, pos: int, *,
                    cache_kind: str = "full") -> tuple[torch.Tensor, dict]:
        """tokens: (B, 1) integer ids; ``pos`` the write position.  ->
        (logits (B, 1, Vp) f32, the caches, their self-attention part
        updated in place)."""
        positions = torch.full((1,), pos, device=self.device)
        ctx = self.make_ctx(positions, cache_kind=cache_kind, pos=pos)
        x = self.embed[tokens.long()]
        for i, blk in enumerate(self.dec):
            x = blk.decode(_index(caches["self"], i), caches["xk"][i],
                           caches["xv"][i], x, ctx)
        return self.head_out(x), caches
