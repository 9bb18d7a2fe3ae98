"""GQA attention of the port (the counterpart of
:mod:`repro.models.attention`): the chunked training/prefill ``attention``
(causal, sliding-window or cross), and decode against a full KV cache, a
sliding-window ring, or the paper's clustered KV cache (k-means centroids
of the old keys and values beside an exact recent window), with the
offline compression that builds the centroids.

Caches keep the JAX package's layouts, (B, kv, slots, dh) per layer behind
the stacking axes of their group, and are updated **in place**: a decode
step writes its token's key and value into the layer's slot instead of
returning a new cache, which saves a copy of the cache per step.  The
functions still return the cache, as the reference's do.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import torch

from repro_torch.kernels.ref import NEG

from .layers import apply_rope, dot


class AttnDims(NamedTuple):
    n_heads: int
    n_kv: int
    dh: int


def _lead(n_layers) -> tuple:
    """A cache's stacking axes: ``n_layers`` as an int or a tuple (gemma's
    (n_super, local_per_global))."""
    return (n_layers,) if isinstance(n_layers, int) else tuple(n_layers)


def _qkv(p: Mapping[str, torch.Tensor], x: torch.Tensor, dims: AttnDims,
         cos: torch.Tensor, sin: torch.Tensor, use_rope: bool = True):
    b, s = x.shape[:2]
    h, kv, dh = dims
    q = dot(x, p["wq"]).reshape(b, s, h, dh)
    k = dot(x, p["wk"]).reshape(b, s, kv, dh)
    v = dot(x, p["wv"]).reshape(b, s, kv, dh)
    if use_rope:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


# ---------------------------------------------------------------------------
# Training / prefill: chunked full (or sliding-window) attention
# ---------------------------------------------------------------------------

def _largest_divisor(s: int, chunk: int) -> int:
    """The largest divisor of ``s`` that is at most ``chunk``."""
    c = min(chunk, s)
    while s % c:
        c -= 1
    return c


def attention(p, x: torch.Tensor, dims: AttnDims, ctx: dict, *,
              window: int = 0, causal: bool = True, kv_override=None,
              use_rope: bool = True) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d): :func:`attend_projected` of x's
    projections by ``wq``, ``wk`` and ``wv`` (``wq`` alone with
    ``kv_override``), then the output projection ``wo``."""
    k, v = ((None, None) if kv_override is not None
            else (dot(x, p["wk"]), dot(x, p["wv"])))
    out = attend_projected(dot(x, p["wq"]), k, v, dims, ctx, window=window,
                           causal=causal, kv_override=kv_override,
                           use_rope=use_rope)
    return dot(out, p["wo"])


def attend_projected(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     dims: AttnDims, ctx: dict, *, window: int = 0,
                     causal: bool = True, kv_override=None,
                     use_rope: bool = True) -> torch.Tensor:
    """The queries (B, S, h dh), keys and values (B, S, kv dh) -> the
    heads' outputs (B, S, h dh) in their type.  ``kv_override=(k, v)``,
    each (B, Skv, kv, dh), attends to those keys and values instead
    (cross attention; ``k`` and ``v`` are then not read, and RoPE turns
    only the queries); ``window > 0`` masks keys ``window`` or more
    positions back.  The reference's arithmetic: logits in f32 from the
    activations' type, masked entries at ``NEG``, softmax in f32, the
    probabilities cast to the activations' type before the value product.
    Queries go in chunks of ``ctx["q_chunk"]`` (the largest divisor of S
    at most it), so one (chunk, Skv) score block is alive at a time; GQA
    is a grouped product, each kv head serving its ``h // kv`` query
    heads.  ``dims`` may be a "model" position's part of a layer (its
    query heads and the kv heads they read); the RoPE tables are read on
    the queries' device."""
    b, s, _ = q.shape
    h, kv, dh = dims
    g = h // kv
    scale = dh ** -0.5
    x = q                       # the activations' type and device
    q = q.reshape(b, s, h, dh)
    if kv_override is None:
        k = k.reshape(b, s, kv, dh)
        v = v.reshape(b, s, kv, dh)
    else:
        k, v = kv_override
    if use_rope:
        cos, sin = (t.to(x.device) for t in ctx["rope"])
        q = apply_rope(q, cos, sin)
        if kv_override is None:
            k = apply_rope(k, cos, sin)
    skv = k.shape[1]
    chunk = _largest_divisor(s, ctx.get("q_chunk", 2048))
    kf = k.float()
    vf = v.float()
    js = torch.arange(skv, device=x.device)
    out = torch.empty((b, s, h * dh), dtype=x.dtype, device=x.device)
    for qs in range(0, s, chunk):
        qc = q[:, qs:qs + chunk].reshape(b, chunk, kv, g, dh).float()
        logits = torch.einsum("bqkgd,bskd->bkgqs", qc, kf) * scale
        if causal:
            iq = qs + torch.arange(chunk, device=x.device)
            m = js[None, :] <= iq[:, None]
            if window:
                m &= (iq[:, None] - js[None, :]) < window
            logits = torch.where(m, logits, NEG)
        probs = torch.softmax(logits, dim=-1).to(x.dtype).float()
        del logits
        oc = torch.einsum("bkgqs,bskd->bqkgd", probs, vf)
        out[:, qs:qs + chunk] = oc.reshape(b, chunk, h * dh).to(x.dtype)
    return out


# ---------------------------------------------------------------------------
# Decode with a full KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(n_layers, b: int, capacity: int, dims: AttnDims,
                  dtype: torch.dtype, device) -> dict:
    kv, dh = dims.n_kv, dims.dh
    shape = _lead(n_layers) + (b, kv, capacity, dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(p, cache_l: dict, x: torch.Tensor, dims: AttnDims,
                     ctx: dict, use_rope: bool = True):
    """One-token decode.  cache_l: {'k', 'v'}: (B, kv, C, dh); ctx['pos']
    is the write position (the cache then holds ``pos + 1`` tokens)."""
    b = x.shape[0]
    h, _, dh = dims
    pos = ctx["pos"]
    cos, sin = ctx["rope"]
    q, k_new, v_new = _qkv(p, x, dims, cos, sin, use_rope)
    cache_l["k"][:, :, pos] = k_new[:, 0]
    cache_l["v"][:, :, pos] = v_new[:, 0]
    valid = torch.arange(cache_l["k"].shape[2], device=x.device) <= pos
    out = _cache_attend(q, cache_l["k"], cache_l["v"], valid)
    return dot(out.reshape(b, 1, h * dh), p["wo"]), cache_l


def _cache_attend(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, h, dh); kc/vc: (B, kv, C, dh); valid: (C,) bool.  Logits
    and the value sum in f32, the result in the cache's type."""
    b, _, h, dh = q.shape
    kv = kc.shape[1]
    qg = q.reshape(b, kv, h // kv, dh).float()
    logits = torch.einsum("bkgd,bksd->bkgs", qg, kc.float()) * dh ** -0.5
    logits = torch.where(valid, logits, NEG)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", probs.to(vc.dtype).float(),
                       vc.float()).to(vc.dtype)
    return out.reshape(b, 1, h, dh)


# ---------------------------------------------------------------------------
# Sliding-window decode (ring buffer)
# ---------------------------------------------------------------------------

def window_valid_mask(slot_pos: torch.Tensor, pos, window: int
                      ) -> torch.Tensor:
    """Liveness of ring-buffer slots: written (>= 0), not from the future,
    and within the last ``window`` positions of ``pos`` (the position of
    the most recently written token).  Shared by the window and clustered
    decodes and the clustered-cache refresh
    (:mod:`repro_torch.stream.kv`)."""
    return (slot_pos >= 0) & (slot_pos <= pos) & (pos - slot_pos < window)


def init_window_cache(n_layers, b: int, window: int, dims: AttnDims,
                      dtype: torch.dtype, device) -> dict:
    """A ring of ``window`` slots per layer: k/v (..., B, kv, W, dh) and
    each slot's position ``slot_pos`` (..., W), -1 while unwritten."""
    lead = _lead(n_layers)
    z = init_kv_cache(lead, b, window, dims, dtype, device)
    z["slot_pos"] = torch.full(lead + (window,), -1, dtype=torch.int32,
                               device=device)
    return z


def attention_decode_window(p, cache_l: dict, x: torch.Tensor,
                            dims: AttnDims, ctx: dict, window: int):
    """One-token decode over a sliding window of ``window`` positions:
    the token goes to slot ``pos % W`` of the layer's ring (W =
    ``min(window, seq_len)`` slots, so ``pos % W == pos % window`` at
    every position of the shape), and the query attends to the live slots
    (:func:`window_valid_mask`)."""
    b = x.shape[0]
    h, _, dh = dims
    pos = ctx["pos"]
    cos, sin = ctx["rope"]
    q, k_new, v_new = _qkv(p, x, dims, cos, sin)
    slot = pos % cache_l["k"].shape[2]
    cache_l["k"][:, :, slot] = k_new[:, 0]
    cache_l["v"][:, :, slot] = v_new[:, 0]
    cache_l["slot_pos"][slot] = pos
    valid = window_valid_mask(cache_l["slot_pos"], pos, window)
    out = _cache_attend(q, cache_l["k"], cache_l["v"], valid)
    return dot(out.reshape(b, 1, h * dh), p["wo"]), cache_l


# ---------------------------------------------------------------------------
# Clustered-KV decode — the paper's technique as an attention operand
# ---------------------------------------------------------------------------

def init_clustered_cache(n_layers, b: int, n_centroids: int,
                         window: int, dims: AttnDims, dtype: torch.dtype,
                         device) -> dict:
    lead = _lead(n_layers)
    kv = dims.n_kv
    cent = init_kv_cache(lead, b, n_centroids, dims, dtype, device)
    ring = init_window_cache(lead, b, window, dims, dtype, device)
    return {
        "kc": cent["k"], "vc": cent["v"],
        "counts": torch.zeros(lead + (b, kv, n_centroids),
                              dtype=torch.float32, device=device),
        "wk": ring["k"], "wv": ring["v"], "slot_pos": ring["slot_pos"],
    }


def attention_decode_clustered(p, cache_l: dict, x: torch.Tensor,
                               dims: AttnDims, ctx: dict):
    """Decode against [k-means centroids of the old cache ‖ exact recent
    window].  The centroid half is the cluster-attention kernel
    (:func:`repro_torch.kernels.cluster_attn_partial`), which returns the
    unnormalised softmax state (acc, m, l) with the log(count) bias; the
    window half is a plain product over the W slots, merged into that state
    by log-sum-exp — the reference's merged softmax over both parts."""
    from repro_torch.kernels.cluster_attn import cluster_attn_partial
    b = x.shape[0]
    h, kv, dh = dims
    g = h // kv
    scale = dh ** -0.5
    pos = ctx["pos"]
    cos, sin = ctx["rope"]
    window = cache_l["wk"].shape[2]
    q, k_new, v_new = _qkv(p, x, dims, cos, sin)

    # window ring-buffer update
    slot = pos % window
    cache_l["wk"][:, :, slot] = k_new[:, 0]
    cache_l["wv"][:, :, slot] = v_new[:, 0]
    cache_l["slot_pos"][slot] = pos
    w_valid = window_valid_mask(cache_l["slot_pos"], pos, window)

    # exact-window logits
    qg = q.reshape(b, kv, g, dh).float()
    lw = torch.einsum("bkgd,bksd->bkgs", qg, cache_l["wk"].float()) * scale
    lw = torch.where(w_valid, lw, NEG)

    # centroid half: the kernel's online-softmax state
    acc, mc, lc = cluster_attn_partial(q.reshape(b, h, dh), cache_l["kc"],
                                       cache_l["vc"], cache_l["counts"],
                                       scale)

    # merged softmax over [centroids ‖ window]
    m = torch.maximum(mc, lw.amax(-1))                       # (B, kv, g)
    alpha = torch.exp(mc - m)
    pw = torch.exp(lw - m[..., None])
    denom = lc * alpha + pw.sum(-1)
    ow = torch.einsum("bkgs,bksd->bkgd", pw, cache_l["wv"].float())
    out = ((acc * alpha[..., None] + ow) / denom[..., None]).to(x.dtype)
    return dot(out.reshape(b, 1, h * dh), p["wo"]), cache_l


def compress_kv_cache(k: torch.Tensor, v: torch.Tensor, *, chunk: int,
                      compression: int, iters: int = 8,
                      seed: "int | torch.Generator" = 0):
    """Build the clustered cache from a full (B, kv, S, dh) cache — the
    paper pipeline applied to keys: contiguous ``chunk``-sized subclusters,
    k-means on the keys of each (all chunks are lanes of one batched
    k-means, kmeans++ seeded from ``seed``), value centroids the
    assignment-weighted means.  Returns (kc, vc, counts) with
    ``S // compression`` centroids per (batch, kv head)."""
    from repro_torch.core.device import make_generator
    from repro_torch.core.kmeans import kmeans_batched, update_centers
    from repro_torch.core.spec import StopSpec

    b, kv, s, dh = k.shape
    n_chunks = s // chunk
    kl = max(1, chunk // compression)
    kk = k.reshape(b * kv * n_chunks, chunk, dh).float()
    vv = v.reshape(b * kv * n_chunks, chunk, dh).float()
    ones = torch.ones(kk.shape[:2], device=k.device)
    res = kmeans_batched(kk, kl, weights=ones,
                         generator=make_generator(seed, k.device),
                         init="kmeans++", stop=StopSpec(max_iters=iters))
    vmean, _ = update_centers(vv, ones, res.assignment, kl,
                              torch.zeros((kk.shape[0], kl, dh),
                                          device=k.device))
    kc = res.centers.reshape(b, kv, n_chunks * kl, dh).to(k.dtype)
    vc = vmean.reshape(b, kv, n_chunks * kl, dh).to(v.dtype)
    counts = res.counts.reshape(b, kv, n_chunks * kl)
    return kc, vc, counts
