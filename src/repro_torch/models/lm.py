"""Decoder-only LM of the port: embeddings (and the VLM's patch prefix) ->
block groups -> head (the counterpart of :mod:`repro.models.lm`).

A model is one *group* of layers, as in the reference: ``blocks``, one
:class:`AttnBlock` per layer (dense, MoE, VLM), or ``super``, one
superblock per step of the pattern: :class:`GemmaSuper`
(``local_per_global`` sliding-window layers, then one global layer),
:class:`XLSTMSuper` (``mlstm_per_slstm`` mLSTM blocks, then one sLSTM) or
:class:`ZambaSuper` (``mamba_per_attn`` Mamba2 blocks, then the attention
block ``shared``, registered once on the model and called by every
superblock).  Parameters keep the JAX package's names and layouts, each
(d_in, d_out): ``embed`` (Vp, d), ``final_ln``, ``head`` (d, Vp),
``patch_proj`` (d, d), and per attention layer ``ln1``, ``attn.wq`` ...
``attn.wo``, ``ln2`` and either ``w1``, ``w3``, ``w2`` or ``moe.router``
(f32), ``moe.we1`` ... (plus ``moe.w1`` ... for llama4's shared expert);
the recurrent blocks' are :mod:`repro_torch.models.ssm`'s.  So
:func:`repro_torch.convert.lm_params_from_jax` carries a JAX-package tree
across by name.

Decode caches are the reference's stacked tensors under the group's name:
``{"blocks": (L, B, kv, ...)}``; gemma's ``{"super": {"local": (n_super,
lpg, B, kv, W, dh) rings, "global": (n_super, B, kv, ...)}}``; xlstm's
``{"super": {"mlstm": {"state": (n_super, mps, B, H, dh, dh + 1)},
"slstm": {c, n, h: (n_super, B, d)}}}``; zamba2's ``{"super": {"mamba":
{"state": (n_super, mpa, B, nh, d_state, 64), "conv": (n_super, mpa, B,
3, C)}, "attn": (n_super, B, kv, ...)}}``.  A decode step is a Python
loop over the layers that updates them in place, under ``no_grad``.
``forward``, ``loss`` and ``loss_embedded`` are differentiable: the
parameters are made without gradients (serving builds no graph), and the
trainer turns gradients on for the ones it trains
(:mod:`repro_torch.train.step`).  With ``remat`` each layer (each
superblock) runs under ``torch.utils.checkpoint``, the counterpart of the
reference's ``jax.checkpoint(..., nothing_saveable)``: its activations
are recomputed in the backward pass.

Over a "model" axis of M positions (a sharded train step's
``ctx["model_split"]``, :class:`repro_torch.core.model_axis.ModelSplit`;
:meth:`DecoderLM.split_regions` says which weights split), the norms,
the residual stream and everything computed whole stay on the data
shard's first position, and:

* attention (every :class:`AttnBlock`, when M divides ``n_heads`` and a
  position's heads hold whole GQA groups or lie inside one,
  :func:`head_split`): position m holds the columns of ``attn.wq`` of its
  query heads ``[m h/M, (m+1) h/M)``, the columns of ``attn.wk`` and
  ``attn.wv`` of the kv heads they read, and the rows of ``attn.wo`` of
  its query heads; it computes those heads and its f32 partial product
  by its rows of ``wo``, and the partials are added in mesh order;
* the dense SwiGLU FFN (when M divides ``d_ff``): position m holds the
  columns ``[m d_ff/M, (m+1) d_ff/M)`` of ``w1`` and ``w3`` and those rows
  of ``w2``; it computes those hidden columns and its f32 partial by its
  rows of ``w2``, added as above; llama4's shared expert (``moe.w1``,
  ``moe.w3``, ``moe.w2``) likewise;
* the MoE experts (when M divides ``n_experts``): position m holds
  experts ``[m E/M, (m+1) E/M)`` of ``moe.we1``, ``moe.we3`` and
  ``moe.we2``, whole along d and d_ff, and computes their SwiGLU on its
  slice of the dispatch block; the router, the routing, the dispatch and
  the combine stay on the first position
  (:func:`~repro_torch.models.moe.moe_ffn`);
* an untied head (when M divides the padded vocabulary): position m
  holds and computes the logits of the columns ``[m Vp/M, (m+1) Vp/M)``,
  and the loss is combined over the positions
  (:func:`~repro_torch.models.layers.vocab_parallel_cross_entropy`)
  without forming whole logits;
* a VLM's ``patch_proj`` (when M divides ``d_model``): position m
  projects the patches by its columns ``[m d/M, (m+1) d/M)``, and the
  first position puts the columns together (``concat_model``);
* whisper's encoder and decoder layers
  (:mod:`~repro_torch.models.encdec`): their self attention and cross
  attention by heads and their FFN by hidden columns, as above, and its
  head by vocab columns;
* the recurrent blocks (:mod:`~repro_torch.models.ssm`): the mLSTM by
  heads (by value columns of a head where the heads divide M), the sLSTM
  by heads, Mamba2 by its 64-wide heads, each where M divides, its
  output projection's f32 partials added as above.

Each position's input arrives as an f32 copy (``to_model``), so its
gradient reaches the positions' add unrounded, and the sum is rounded
once, where the one-device product rounds; the partials are added in f32
and rounded once (``from_model``).  The experts and ``patch_proj`` split no
sum: the experts' dispatch block is cut along E (``split_model``), and
their outputs and the patches' columns are put back together
(``concat_model``).  The attention, FFN and head code over "model"
(:func:`attend`, :func:`swiglu_over_model`, :func:`vocab_parallel_loss`,
:func:`attn_regions`, :func:`ffn_regions`, :func:`model_regions`) is
shared by both model classes.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ArchConfig, ShapeConfig
from repro_torch.core.device import derive_seed, resolve_device, seed_of

from .attention import (AttnDims, attend_projected, attention,
                        attention_decode,
                        attention_decode_clustered, attention_decode_window,
                        init_clustered_cache, init_kv_cache,
                        init_window_cache)
from .layers import (cross_entropy, dot, dot_f32, ninit_, over_columns,
                     over_rows, param, rms_norm, rope_tables, swiglu,
                     swiglu_gate, vocab_parallel_cross_entropy)
from .moe import moe_ffn, moe_ffn_decode
from .ssm import Mamba2Block, MLSTMBlock, SLSTMBlock

CACHE_KINDS = ("full", "clustered")


def attn_params(d: int, dims: AttnDims, dtype: torch.dtype, device
                ) -> nn.ParameterDict:
    """An attention layer's zeroed projections ``wq``, ``wk``, ``wv``,
    ``wo``, each (d_in, d_out)."""
    h, kv, dh = dims
    return nn.ParameterDict({
        "wq": param((d, h * dh), dtype, device),
        "wk": param((d, kv * dh), dtype, device),
        "wv": param((d, kv * dh), dtype, device),
        "wo": param((h * dh, d), dtype, device)})


def vocab_logits(x: torch.Tensor, final_ln: torch.Tensor, w: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """Final norm and the vocabulary projection by ``w`` (d, Vp): f32
    logits computed from the activations and ``w`` in their own type, with
    no rounding of the product to that type (:func:`dot_f32`)."""
    return dot_f32(rms_norm(x, final_ln, eps), w)


def weight_draws(embed: torch.Tensor, projections: list) -> list:
    """(tensor, scale) of every drawn weight in draw order: ``embed`` at
    0.02, then each projection at ``d_in ** -0.5`` (d_in its next-to-last
    axis)."""
    return [(embed, 0.02)] + [(w, w.shape[-2] ** -0.5) for w in projections]


def draw(w: torch.Tensor, base: int, i: int, scale: float) -> None:
    """Fill ``w`` with N(0, scale^2) draws from its own generator on its
    device, seeded ``derive_seed(base, i)``."""
    gen = torch.Generator(device=w.device)
    gen.manual_seed(derive_seed(base, i))
    ninit_(w, gen, scale)


def draw_weights(draws: list, seed: "int | torch.Generator") -> None:
    """Fill the i-th tensor of ``draws`` (:func:`weight_draws`) by
    :func:`draw` from ``seed``."""
    base = seed_of(seed)
    for i, (w, scale) in enumerate(draws):
        draw(w, base, i, scale)


def initial_fill(model: nn.Module, name: str) -> float:
    """The value parameter ``name`` of ``model`` is made with, before any
    draw: one for the names its owning block lists in ``ONES`` (Mamba2's
    ``D``), else zero."""
    owner, _, leaf = name.rpartition(".")
    return 1.0 if leaf in getattr(model.get_submodule(owner), "ONES",
                                  ()) else 0.0


def gathered_call(layer: nn.Module, gather, name: str, *args):
    """``layer(*args)`` computing with the weights ``gather(name)`` gives:
    a sharded train step's per-layer gather, which the caller puts inside
    the checkpointed call so the backward's recompute gathers again.
    ``gather(name)`` -> (``{name within the layer: tensor}``, the weights
    the layer computes whole with on the data shard's device; and, where
    the layer computes over "model", one such dict a position of the
    weights split there, else ``None``).  The split weights reach each
    block of the layer that names regions (``split_regions``: an
    :class:`AttnBlock`, an mLSTM, sLSTM or Mamba2 block, a whisper
    encoder or decoder layer) through the
    ``model_split`` of the context, ``args``' last entry."""
    params, parts = gather(name)
    if parts is not None:
        weights = {}
        for prefix, blk in layer.named_modules():
            if not hasattr(blk, "split_regions"):
                continue
            prefix = prefix + "." if prefix else ""
            own = [{k[len(prefix):]: t for k, t in part.items()
                    if k.startswith(prefix)} for part in parts]
            if own[0]:
                weights[blk] = own
        ctx = args[-1]
        args = args[:-1] + (dict(ctx, model_split=ctx[
            "model_split"].with_weights(weights)),)
    return functional_call(layer, params, args)


def swiglu_over_model(split, x: torch.Tensor, parts: list, prefix: str
                      ) -> torch.Tensor:
    """The SwiGLU FFN by the weights ``prefix + "w1"``, ``"w3"``, ``"w2"``
    of ``parts`` over "model": each position's hidden columns
    (:func:`over_columns`), the f32 partials by its rows of ``w2`` added
    in mesh order (:func:`over_rows`)."""
    u, v = (over_columns(split, x, [p[prefix + n] for p in parts])
            for n in ("w1", "w3"))
    return over_rows(split, [swiglu_gate(um, vm) for um, vm in zip(u, v)],
                     [p[prefix + "w2"] for p in parts])


def model_parts(ctx: dict, module: nn.Module) -> tuple:
    """(``ctx["model_split"]`` or ``None``, the per-position weights it
    holds for ``module`` or ``None``)."""
    split = ctx.get("model_split")
    return split, (split.parts(module) if split is not None else None)


def holds(parts, name: str) -> bool:
    """Whether the per-position weights ``parts`` split ``name``."""
    return parts is not None and name in parts[0]


def attend(p, x: torch.Tensor, dims: AttnDims, ctx: dict, split=None,
           parts=None, prefix: str = "attn.", *, kv=None, window: int = 0,
           causal: bool = True, use_rope: bool = True) -> torch.Tensor:
    """An attention layer's output (B, S, d) for the normed input ``x``:
    by its whole weights ``p`` (:func:`attention`), or, where ``parts``
    splits ``prefix + "wq"``, over "model": each position's query heads'
    columns of ``wq`` and its kv heads' columns of ``wk`` and ``wv``
    (:func:`over_columns`), its heads' outputs
    (:func:`attend_projected`), its f32 partial by its rows of ``wo``,
    added in mesh order (:func:`over_rows`).  ``kv`` (B, T, d) is cross
    attention's source: the keys and values are its products by ``wk``
    and ``wv`` (x's are never formed)."""
    if not holds(parts, prefix + "wq"):
        return attention(p, x, dims, ctx, window=window, causal=causal,
                         use_rope=use_rope,
                         kv_override=None if kv is None else project_kv(
                             p, kv, dims))
    src = x if kv is None else kv
    q = over_columns(split, x, [w[prefix + "wq"] for w in parts])
    k, v = (over_columns(split, src, [w[prefix + n] for w in parts])
            for n in ("wk", "wv"))
    outs = []
    for qm, km, vm in zip(q, k, v):
        dm = AttnDims(qm.shape[-1] // dims.dh, km.shape[-1] // dims.dh,
                      dims.dh)
        over = None if kv is None else tuple(
            t.reshape(*t.shape[:2], dm.n_kv, dm.dh) for t in (km, vm))
        outs.append(attend_projected(qm, km, vm, dm, ctx, window=window,
                                     causal=causal, use_rope=use_rope,
                                     kv_override=over))
    return over_rows(split, outs, [w[prefix + "wo"] for w in parts])


def project_kv(p, src: torch.Tensor, dims: AttnDims) -> tuple:
    """The keys and values (B, T, kv, dh) of ``src`` (B, T, d) by the
    attention weights ``p``'s ``wk`` and ``wv``: cross attention's."""
    b, t, _ = src.shape
    return tuple(dot(src, p[n]).reshape(b, t, dims.n_kv, dims.dh)
                 for n in ("wk", "wv"))


def vocab_parallel_loss(split, parts, x: torch.Tensor,
                        final_ln: torch.Tensor, eps: float,
                        labels: torch.Tensor, offset: int = 0
                        ) -> torch.Tensor:
    """The head and the mean NLL over "model": the final norm of ``x``,
    each position's f32 logits of its columns of ``head``
    (:func:`over_columns`), the sequence positions from ``offset`` on
    (after a VLM's patches) held against ``labels`` without forming
    whole logits (:func:`vocab_parallel_cross_entropy`)."""
    xn = rms_norm(x, final_ln, eps)
    blocks = over_columns(split, xn, [p["head"] for p in parts], out_f32=True)
    return vocab_parallel_cross_entropy([b[:, offset:] for b in blocks],
                                        labels)


def attn_regions(dims: AttnDims, d: int, n_model: int,
                 prefix: str = "attn.") -> dict:
    """``{name: [region a position]}`` of an attention layer's weights
    ``prefix + "wq"`` ... ``"wo"`` split by heads (:func:`head_split`):
    position m's query heads' columns of ``wq`` and rows of ``wo``, its
    kv heads' columns of ``wk`` and ``wv``; empty where the attention is
    computed whole."""
    out: dict = {}
    rows, dh = slice(0, d), dims.dh
    for (q0, q1), (k0, k1) in head_split(dims, n_model) or ():
        q, k = slice(q0 * dh, q1 * dh), slice(k0 * dh, k1 * dh)
        for name, region in (("wq", (rows, q)), ("wk", (rows, k)),
                             ("wv", (rows, k)), ("wo", (q, rows))):
            out.setdefault(prefix + name, []).append(region)
    return out


def ffn_regions(d: int, f: int, n_model: int, prefix: str = "") -> dict:
    """``{name: [region a position]}`` of a SwiGLU FFN's ``prefix + "w1"``,
    ``"w3"``, ``"w2"`` split by hidden columns: position m's ``f / M``
    columns of ``w1`` and ``w3`` and those rows of ``w2``; empty at M = 1
    or where M does not divide ``f``."""
    out: dict = {}
    if n_model == 1 or f % n_model:
        return out
    rows = slice(0, d)
    for m in range(n_model):
        cols = slice(m * f // n_model, (m + 1) * f // n_model)
        for name, region in (("w1", (rows, cols)), ("w3", (rows, cols)),
                             ("w2", (cols, rows))):
            out.setdefault(prefix + name, []).append(region)
    return out


def model_regions(model: nn.Module, n_model: int, columns: dict) -> dict:
    """A model's ``split_regions``: each weight of ``columns`` (``{name:
    (d_in, d_out)}``, a projection of the model's own) whose ``d_out`` M
    divides, position m its columns ``[m d_out/M, (m+1) d_out/M)``, and
    every block's regions that names them (``split_regions``), under the
    block's name.  Empty at M = 1."""
    out: dict = {}
    for name, (rows, cols) in columns.items():
        if n_model > 1 and cols % n_model == 0:
            out[name] = [(slice(0, rows), slice(m * cols // n_model,
                                                (m + 1) * cols // n_model))
                         for m in range(n_model)]
    for name, blk in model.named_modules():
        if name and hasattr(blk, "split_regions"):
            for rel, regions in blk.split_regions(n_model).items():
                out[f"{name}.{rel}"] = regions
    return out


def head_split(dims: AttnDims, n_model: int):
    """The query heads and the kv heads each of ``n_model`` positions
    computes, ``[((q0, q1), (k0, k1))]`` in position order, or ``None``
    where the layer's attention is computed whole: a position takes
    ``h / M`` consecutive query heads and reads the kv heads they use,
    which needs M to divide h and the position's heads to hold whole GQA
    groups (M divides kv) or to lie inside one (the group holds them; its
    kv head is then read by several positions)."""
    h, kv, _ = dims
    if n_model == 1 or h % n_model:
        return None
    hm, g = h // n_model, h // kv
    if hm % g == 0:
        km = hm // g
        return [((m * hm, (m + 1) * hm), (m * km, (m + 1) * km))
                for m in range(n_model)]
    if g % hm == 0:
        return [((m * hm, (m + 1) * hm), (m * hm // g, m * hm // g + 1))
                for m in range(n_model)]
    return None


def _index(tree, i):
    """A cache tree with every tensor indexed at ``i`` along its first
    axis (views: in-place updates reach the stacked cache)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


class AttnBlock(nn.Module):
    """Pre-norm GQA attention, then a SwiGLU FFN or an MoE FFN, one layer
    (the JAX package's ``make_attn_block``); ``window > 0`` makes it a
    sliding-window layer."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device, *,
                 window: int = 0, moe: bool = False):
        super().__init__()
        d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
        self.cfg = cfg
        self.dims = AttnDims(h, kv, dh)
        self.eps = cfg.norm_eps
        self.window = window
        self.ln1 = param((d,), dtype, device)
        self.attn = attn_params(d, self.dims, dtype, device)
        self.ln2 = param((d,), dtype, device)
        if moe:
            e, f = cfg.n_experts, cfg.d_ff
            experts = {
                "router": param((d, e), torch.float32, device),
                "we1": param((e, d, f), dtype, device),
                "we3": param((e, d, f), dtype, device),
                "we2": param((e, f, d), dtype, device)}
            if cfg.name.startswith("llama4"):         # the shared expert
                experts.update(w1=param((d, f), dtype, device),
                               w3=param((d, f), dtype, device),
                               w2=param((f, d), dtype, device))
            self.moe = nn.ParameterDict(experts)
        else:
            self.moe = None
            self.w1 = param((d, cfg.d_ff), dtype, device)
            self.w3 = param((d, cfg.d_ff), dtype, device)
            self.w2 = param((cfg.d_ff, d), dtype, device)

    def projections(self) -> list[torch.Tensor]:
        """The weights drawn at ``d_in ** -0.5`` (the norms start at 0)."""
        ffn = (list(self.moe.values()) if self.moe is not None
               else [self.w1, self.w3, self.w2])
        return [*self.attn.values(), *ffn]

    def split_regions(self, n_model: int) -> dict:
        """``{name within the block: [region of the weight (slices) that
        each of n_model "model" positions computes with]}`` for the
        weights this block computes over "model": with the attention
        split (:func:`head_split`), position m's query heads' columns of
        ``attn.wq`` and rows of ``attn.wo``, and the columns of its kv
        heads in ``attn.wk`` and ``attn.wv``; with a dense FFN (llama4's
        shared expert) whose ``d_ff`` M divides, its ``d_ff / M`` hidden
        columns of ``w1`` and ``w3`` and rows of ``w2`` (``moe.w1`` ...);
        with MoE experts that M divides, its ``E / M`` experts of
        ``moe.we1``, ``moe.we3`` and ``moe.we2``, whole along d and
        d_ff.  Empty at M = 1; what M does not divide is computed whole
        (the router always)."""
        d, f, e = self.cfg.d_model, self.cfg.d_ff, self.cfg.n_experts
        out = attn_regions(self.dims, d, n_model)
        if self.moe is None or "w1" in self.moe:
            out.update(ffn_regions(d, f, n_model,
                                   "" if self.moe is None else "moe."))
        rows = slice(0, d)
        if self.moe is not None and n_model > 1 and e % n_model == 0:
            hidden = slice(0, f)
            for m in range(n_model):
                ex = slice(m * e // n_model, (m + 1) * e // n_model)
                for name, region in (("moe.we1", (ex, rows, hidden)),
                                     ("moe.we3", (ex, rows, hidden)),
                                     ("moe.we2", (ex, hidden, rows))):
                    out.setdefault(name, []).append(region)
        return out

    def forward(self, x: torch.Tensor, aux: torch.Tensor, ctx: dict
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """The forward over a whole (B, S, d) sequence -> (x, aux plus
        this layer's MoE load-balance loss); the reference's ``apply``
        (``nn.Module.apply`` keeps its own meaning).  Where
        ``ctx["model_split"]`` holds this block's per-position weights
        (:meth:`split_regions`), the attention and the FFN are computed
        over "model": the normed input goes to every position
        (``to_model``), each computes its heads (its hidden columns) and
        its f32 partial product by its rows of ``wo`` (``w2``), and the
        partials are added in mesh order (``from_model``); an MoE FFN's
        experts are computed expert-parallel and its shared expert by
        hidden columns; the norms and the residual stay on the data
        shard's device."""
        split, parts = model_parts(ctx, self)
        h = x + attend(self.attn, rms_norm(x, self.ln1, self.eps), self.dims,
                       ctx, split, parts, window=self.window)
        hn = rms_norm(h, self.ln2, self.eps)
        if self.moe is not None:
            return self._moe(split, parts, h, hn, aux)
        if holds(parts, "w1"):
            return h + swiglu_over_model(split, hn, parts, ""), aux
        return h + swiglu(hn, self.w1, self.w3, self.w2), aux

    def _moe(self, split, parts, h, hn, aux):
        """The MoE FFN's residual update and aux loss; over "model" where
        ``parts`` holds the experts (``moe.we1`` ...) or the shared
        expert's columns (``moe.w1`` ...)."""
        split_experts, split_shared = (holds(parts, n)
                                       for n in ("moe.we1", "moe.w1"))
        p = {n: w for n, w in self.moe.items()
             if not (split_experts and n.startswith("we")
                     or split_shared and n in ("w1", "w3", "w2"))}
        experts = ([{n: q["moe." + n] for n in ("we1", "we3", "we2")}
                    for q in parts] if split_experts else None)
        y, a = moe_ffn(p, hn, n_experts=self.cfg.n_experts,
                       top_k=self.cfg.experts_per_token,
                       capacity_factor=self.cfg.expert_capacity_factor,
                       split=split, experts=experts)
        if split_shared:
            y = y + swiglu_over_model(split, hn, parts, "moe.")
        return h + y, aux + a

    def decode(self, cache_l: dict, x: torch.Tensor, ctx: dict
               ) -> tuple[torch.Tensor, dict]:
        xn = rms_norm(x, self.ln1, self.eps)
        if self.window:
            a, cache_l = attention_decode_window(self.attn, cache_l, xn,
                                                 self.dims, ctx, self.window)
        elif ctx["cache_kind"] == "clustered":
            a, cache_l = attention_decode_clustered(self.attn, cache_l, xn,
                                                    self.dims, ctx)
        else:
            a, cache_l = attention_decode(self.attn, cache_l, xn, self.dims,
                                          ctx)
        h = x + a
        hn = rms_norm(h, self.ln2, self.eps)
        if self.moe is not None:
            y = moe_ffn_decode(self.moe, hn, n_experts=self.cfg.n_experts,
                               top_k=self.cfg.experts_per_token)
        else:
            y = swiglu(hn, self.w1, self.w3, self.w2)
        return h + y, cache_l

    def init_cache(self, lead, b: int, shape: ShapeConfig, kind: str,
                   dtype: torch.dtype, device) -> dict:
        """Zeroed caches of ``lead`` such layers (an int or a tuple of
        stacking axes): a ring of ``min(window, seq_len)`` slots for a
        window layer, else the ``kind`` cache."""
        if self.window:
            return init_window_cache(lead, b, min(self.window, shape.seq_len),
                                     self.dims, dtype, device)
        if kind == "clustered":
            nc = shape.seq_len // shape.cluster_compression
            return init_clustered_cache(lead, b, nc, shape.cluster_window,
                                        self.dims, dtype, device)
        if kind == "full":
            return init_kv_cache(lead, b, shape.seq_len, self.dims, dtype,
                                 device)
        raise ValueError(f"unknown cache kind {kind!r}; known: {CACHE_KINDS}")


class GemmaSuper(nn.Module):
    """gemma3's superblock: ``local_per_global`` sliding-window layers
    (``local``), then one global layer (``global``)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device):
        super().__init__()
        self.local = nn.ModuleList(
            AttnBlock(cfg, dtype, device, window=cfg.window)
            for _ in range(cfg.local_per_global))
        self.add_module("global", AttnBlock(cfg, dtype, device))

    @property
    def glob(self) -> AttnBlock:
        return self._modules["global"]

    def layers(self) -> list[AttnBlock]:
        return [*self.local, self.glob]

    def projections(self) -> list[torch.Tensor]:
        return [w for blk in self.layers() for w in blk.projections()]

    def forward(self, x, aux, ctx):
        for blk in self.layers():
            x, aux = blk(x, aux, ctx)
        return x, aux

    def decode(self, cache_s: dict, x, ctx):
        for j, blk in enumerate(self.local):
            x, _ = blk.decode(_index(cache_s["local"], j), x, ctx)
        x, _ = self.glob.decode(cache_s["global"], x, ctx)
        return x, cache_s

    def init_cache(self, n_super, b, shape, kind, dtype, device) -> dict:
        lpg = len(self.local)
        return {"local": self.local[0].init_cache((n_super, lpg), b, shape,
                                                  "window", dtype, device),
                "global": self.glob.init_cache(n_super, b, shape, kind,
                                               dtype, device)}


class XLSTMSuper(nn.Module):
    """xlstm's superblock: ``mlstm_per_slstm`` mLSTM blocks (``mlstm``),
    then one sLSTM block (``slstm``)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device):
        super().__init__()
        d, h, eps = cfg.d_model, cfg.n_heads, cfg.norm_eps
        self.mlstm = nn.ModuleList(MLSTMBlock(d, h, eps, dtype, device)
                                   for _ in range(cfg.mlstm_per_slstm))
        self.slstm = SLSTMBlock(d, h, eps, dtype, device)

    def projections(self) -> list[torch.Tensor]:
        return [w for blk in [*self.mlstm, self.slstm]
                for w in blk.projections()]

    def forward(self, x, aux, ctx):
        for blk in self.mlstm:
            x = blk(x, ctx)
        return self.slstm(x, ctx), aux

    def decode(self, cache_s: dict, x, ctx):
        for j, blk in enumerate(self.mlstm):
            x, _ = blk.decode(_index(cache_s["mlstm"], j), x, ctx)
        x, _ = self.slstm.decode(cache_s["slstm"], x, ctx)
        return x, cache_s

    def init_cache(self, n_super, b, shape, kind, dtype, device) -> dict:
        """O(1) state whatever the shape and kind."""
        return {"mlstm": self.mlstm[0].init_cache(
                    (n_super, len(self.mlstm)), b, device),
                "slstm": self.slstm.init_cache(n_super, b, device)}


class ZambaSuper(nn.Module):
    """zamba2's superblock: ``mamba_per_attn`` Mamba2 blocks (``mamba``),
    then the model's one attention block, whose weights every superblock
    shares.  The superblock holds that block without registering it (it
    is the model's ``shared``), so its parameters appear once."""

    def __init__(self, cfg: ArchConfig, shared: AttnBlock,
                 dtype: torch.dtype, device):
        super().__init__()
        self.mamba = nn.ModuleList(
            Mamba2Block(cfg.d_model, cfg.ssm_state, cfg.norm_eps, dtype,
                        device) for _ in range(cfg.mamba_per_attn))
        self.__dict__["shared"] = shared

    def projections(self) -> list[torch.Tensor]:
        return [w for blk in self.mamba for w in blk.projections()]

    def forward(self, x, aux, ctx):
        for blk in self.mamba:
            x = blk(x, ctx)
        return self.shared(x, aux, ctx)

    def decode(self, cache_s: dict, x, ctx):
        for j, blk in enumerate(self.mamba):
            x, _ = blk.decode(_index(cache_s["mamba"], j), x, ctx)
        x, _ = self.shared.decode(cache_s["attn"], x, ctx)
        return x, cache_s

    def init_cache(self, n_super, b, shape, kind, dtype, device) -> dict:
        return {"mamba": self.mamba[0].init_cache(
                    (n_super, len(self.mamba)), b, device),
                "attn": self.shared.init_cache(n_super, b, shape, kind,
                                               dtype, device)}


def _superblocks(cfg: ArchConfig) -> int:
    """Superblocks of a patterned config (the layers of one step:
    ``local_per_global + 1``, ``mlstm_per_slstm + 1`` or
    ``mamba_per_attn``); raises where ``n_layers`` is below one step, as
    the reference does."""
    per = (cfg.local_per_global + 1 if cfg.local_per_global
           else cfg.mlstm_per_slstm + 1 if cfg.family == "ssm"
           else cfg.mamba_per_attn)
    n_super = cfg.n_layers // per
    if n_super < 1:
        raise ValueError(
            f"{cfg.name}: group 'super' has {n_super} superblocks — "
            f"n_layers={cfg.n_layers} is smaller than the pattern size")
    return n_super


class DecoderLM(nn.Module):
    """Decoder-only LM on ``device`` (``None``: the CUDA device): the
    ``blocks`` group of :class:`AttnBlock` layers, or the ``super`` group
    of gemma's, xlstm's or zamba2's superblocks (zamba2's with the
    ``shared`` attention block); with ``n_patches`` the VLM backbone,
    whose input starts with projected patch embeddings.  Weights are zero
    (Mamba2's ``D`` one) until :meth:`init_params` draws them or a state
    dict is loaded."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        d = cfg.d_model
        self.embed = param((cfg.padded_vocab, d), self.dtype, dev)
        self.final_ln = param((d,), self.dtype, dev)
        if not cfg.tie_embeddings:
            self.head = param((d, cfg.padded_vocab), self.dtype, dev)
        if cfg.n_patches:
            self.patch_proj = param((d, d), self.dtype, dev)
        if cfg.local_per_global:
            superblock = functools.partial(GemmaSuper, cfg)
        elif cfg.family == "ssm":
            superblock = functools.partial(XLSTMSuper, cfg)
        elif cfg.family == "hybrid":
            self.shared = AttnBlock(cfg, self.dtype, dev)
            superblock = functools.partial(ZambaSuper, cfg, self.shared)
        else:
            superblock = None
        if superblock is not None:
            self.group = "super"
            layers = [superblock(self.dtype, dev)
                      for _ in range(_superblocks(cfg))]
        else:
            self.group = "blocks"
            layers = [AttnBlock(cfg, self.dtype, dev,
                                moe=cfg.family == "moe")
                      for _ in range(cfg.n_layers)]
        self.add_module(self.group, nn.ModuleList(layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def layers(self) -> nn.ModuleList:
        """The group's layers (superblocks for gemma), in order."""
        return self._modules[self.group]

    def attn_blocks(self) -> list[AttnBlock]:
        """Every attention layer, in order (zamba2's one shared block
        once)."""
        if self.cfg.family == "hybrid":
            return [self.shared]
        return [blk for layer in self.layers()
                for blk in (layer.layers() if isinstance(layer, GemmaSuper)
                            else [layer] if isinstance(layer, AttnBlock)
                            else [])]

    # -- params ------------------------------------------------------------
    def draws(self) -> list:
        """(parameter, scale) of every drawn weight in draw order
        (:func:`weight_draws`): embeddings, head, zamba2's shared block,
        the layers, the patch projection."""
        projections = [] if self.cfg.tie_embeddings else [self.head]
        if self.cfg.family == "hybrid":
            projections += self.shared.projections()
        projections += [w for layer in self.layers()
                        for w in layer.projections()]
        if self.cfg.n_patches:
            projections.append(self.patch_proj)
        return weight_draws(self.embed, projections)

    def init_params(self, seed: "int | torch.Generator" = 0) -> "DecoderLM":
        """Draw every weight at the JAX package's scales (embeddings 0.02,
        projections ``d_in ** -0.5``, the experts', the recurrent blocks'
        and the conv's too, with d_in the next-to-last axis; norms 0;
        Mamba2's ``A_log`` 0, ``D`` 1, ``dt_bias`` 0, never drawn), each
        tensor from its own generator seeded from ``seed``, in the order
        of :meth:`draws`; returns ``self``."""
        draw_weights(self.draws(), seed)
        return self

    # -- context -------------------------------------------------------------
    def make_ctx(self, positions: torch.Tensor, *, q_chunk: int = 2048,
                 cache_kind: str = "full", pos: Optional[int] = None
                 ) -> dict:
        """The per-call context: RoPE tables at ``positions``, the forward's
        query chunk, the recurrent blocks' chunk (``ssm_chunk`` 256, as
        the reference's), and for a decode step the cache kind and the
        write position ``pos``."""
        cfg = self.cfg
        ctx = {"rope": rope_tables(positions, cfg.dh, cfg.rope_theta),
               "q_chunk": q_chunk, "ssm_chunk": 256,
               "cache_kind": cache_kind}
        if pos is not None:
            ctx["pos"] = int(pos)
        return ctx

    # -- forward -----------------------------------------------------------
    def embed_in(self, batch: dict, ctx: Optional[dict] = None
                 ) -> torch.Tensor:
        """The token embeddings (B, S, d), after the projected
        ``batch["patches"]`` (B, n_patches, d) for a VLM.  Where
        ``ctx["model_split"]`` holds this model's columns of
        ``patch_proj``, each "model" position projects the patches by its
        columns (:func:`over_columns`) and the first position puts them
        together (``concat_model``)."""
        x = self.embed[batch["tokens"].long()].to(self.dtype)
        if self.cfg.n_patches:
            split, parts = model_parts(ctx or {}, self)
            if holds(parts, "patch_proj"):
                patches = split.concat_model(over_columns(
                    split, batch["patches"],
                    [p["patch_proj"] for p in parts]), -1)
            else:
                patches = dot(batch["patches"].to(self.dtype),
                              self.patch_proj)
            x = torch.cat([patches, x], dim=1)
        return x

    def run_groups(self, x: torch.Tensor, ctx: dict, *, remat: bool = True
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Every layer over (B, S, d) -> (x, the MoE load-balance loss summed
        over the layers, f32).  ``remat`` recomputes each layer's
        activations in the backward pass instead of keeping them (only
        where a gradient is being recorded: serving runs the layers
        plainly).  With ``ctx["gather"]`` (a sharded train step's) each
        layer computes with the weights it gathers, inside the
        checkpointed call (:func:`gathered_call`)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        gather = ctx.get("gather")
        remat = remat and torch.is_grad_enabled() and (
            gather is not None or x.requires_grad
            or any(p.requires_grad for p in self.parameters()))
        for i, layer in enumerate(self.layers()):
            call = layer if gather is None else functools.partial(
                gathered_call, layer, gather, f"{self.group}.{i}")
            if remat:
                x, aux = checkpoint(call, x, aux, ctx, use_reentrant=False)
            else:
                x, aux = call(x, aux, ctx)
        return x, aux

    def forward(self, batch: dict, ctx: Optional[dict] = None, *,
                remat: bool = True, last_only: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """``batch``: ``tokens`` (B, S) and, for a VLM, ``patches``; ``ctx``
        from :meth:`make_ctx` (default: positions 0 .. S + n_patches - 1,
        ``q_chunk`` 2048).  -> (f32 logits (B, S', Vp), aux), with S' = 1
        at ``last_only`` (serving's next-token logits: the full logits are
        never formed)."""
        if ctx is None:
            s = batch["tokens"].shape[1] + self.cfg.n_patches
            ctx = self.make_ctx(torch.arange(s, device=self.device))
        x, aux = self.run_groups(self.embed_in(batch), ctx, remat=remat)
        if last_only:
            x = x[:, -1:]
        return self.head_out(x), aux

    def loss(self, batch: dict, ctx: Optional[dict] = None, *,
             remat: bool = True, aux_weight: float = 0.01) -> torch.Tensor:
        """Mean next-token NLL against ``batch["labels"]`` (B, S) over the
        text positions (the patches' are left out), plus ``aux_weight``
        times the MoE load-balance loss."""
        logits, aux = self.forward(batch, ctx, remat=remat)
        return self._text_loss(logits, batch["labels"], aux, aux_weight)

    def loss_embedded(self, x: torch.Tensor, rest: dict, ctx: dict, *,
                      remat: bool = True, aux_weight: float = 0.01
                      ) -> torch.Tensor:
        """:meth:`loss` from inputs already embedded (``x`` from
        :meth:`embed_in`), so the trainer gathers the embeddings once a
        step, outside the gradient; ``rest`` holds the batch's other
        leaves (``labels``)."""
        x, aux = self.run_groups(x, ctx, remat=remat)
        split, parts = model_parts(ctx, self)
        if not holds(parts, "head"):
            return self._text_loss(self.head_out(x), rest["labels"], aux,
                                   aux_weight)
        return (vocab_parallel_loss(split, parts, x, self.final_ln,
                                    self.cfg.norm_eps, rest["labels"],
                                    self.cfg.n_patches)
                + aux_weight * aux)

    def split_regions(self, n_model: int) -> dict:
        """``{parameter name: [region each of n_model "model" positions
        computes with]}`` (:func:`model_regions`): every block's that
        names regions (an attention block's,
        :meth:`AttnBlock.split_regions`; an mLSTM's, an sLSTM's and a
        Mamba2's, :mod:`~repro_torch.models.ssm`); for an untied head
        whose padded vocabulary M divides, position m's ``Vp / M``
        columns of ``head`` (the vocab-parallel loss); for a VLM whose
        ``d_model`` M divides, its ``d / M`` columns of ``patch_proj``
        (:meth:`embed_in`).  Everything else (the norms, the embedding, a
        tied head, the MoE router, the mLSTM's ``up1``) is computed whole
        on the data shard's device.  Empty at M = 1."""
        cfg, d = self.cfg, self.cfg.d_model
        columns = {} if cfg.tie_embeddings else {"head": (d, cfg.padded_vocab)}
        if cfg.n_patches:
            columns["patch_proj"] = (d, d)
        return model_regions(self, n_model, columns)

    def _text_loss(self, logits, labels, aux, aux_weight):
        if self.cfg.n_patches:
            logits = logits[:, self.cfg.n_patches:]
        return cross_entropy(logits, labels) + aux_weight * aux

    # -- decode ------------------------------------------------------------
    def init_caches(self, b: int, shape: ShapeConfig, kind: str) -> dict:
        """Zeroed decode caches for batch ``b`` at ``shape``: ``"full"``
        (capacity ``shape.seq_len``) or ``"clustered"``
        (``seq_len // cluster_compression`` centroids beside a
        ``cluster_window`` ring); gemma's local layers always hold a ring of
        ``min(window, seq_len)`` slots, and the recurrent blocks an O(1)
        f32 state whatever the shape (zamba2's shared attention takes the
        ``kind`` cache)."""
        if kind not in CACHE_KINDS:
            raise ValueError(f"unknown cache kind {kind!r}; known: "
                             f"{CACHE_KINDS}")
        layers = self.layers()
        return {self.group: layers[0].init_cache(
            len(layers), b, shape, kind, self.dtype, self.device)}

    def head_out(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and the vocabulary projection (:func:`vocab_logits`;
        by the embedding's transpose where they are tied)."""
        w = self.embed.T if self.cfg.tie_embeddings else self.head
        return vocab_logits(x, self.final_ln, w, self.cfg.norm_eps)

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, caches: dict, pos: int, *,
                    cache_kind: str = "full") -> tuple[torch.Tensor, dict]:
        """tokens: (B, 1) integer ids; ``pos`` the write position.  ->
        (logits (B, 1, Vp) f32, the caches, updated in place)."""
        # a device-side fill: a copy from host memory would wait for the
        # queued steps, so the host could not run ahead of the card
        positions = torch.full((1,), pos, device=self.device)
        ctx = self.make_ctx(positions, cache_kind=cache_kind, pos=pos)
        x = self.embed[tokens.long()]
        stack = caches[self.group]
        for i, layer in enumerate(self.layers()):
            x, _ = layer.decode(_index(stack, i), x, ctx)
        return self.head_out(x), caches
