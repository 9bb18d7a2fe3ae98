"""Serving engine of the port: prefill + decode with periodic clustered-
cache recompression (the paper's pipeline applied online); the counterpart
of :mod:`repro.serve.engine`.

Decode runs against [centroid cache ‖ exact window]; the centroid half is
the cluster-attention kernel (``kernels/csrc/cluster_attn.cu``).  Every
``recompress_every`` tokens the window is folded into the centroids by
:func:`repro_torch.stream.kv.refresh_layer_cache` — one warm-started
weighted k-means over [old centroids ‖ window keys] for all layers at
once, run by the Lloyd kernel.  The window is then marked empty and
refills; the cache stays O(S_0/c + W) while the centroids track the whole
history.

The engine serves any model :func:`~repro_torch.models.build_model`
returns (a :class:`~repro_torch.models.DecoderLM` or, for whisper, an
:class:`~repro_torch.models.EncDecLM`, holding its weights:
``build_model(cfg)`` then ``init_params(seed)`` or ``load_state_dict``), on
the device the model lives on.  Whisper decodes on the full cache, and
its cross-attention caches stay zero, as the reference's engine leaves
them.  Decode caches are updated in place; a refresh folds only the
clustered caches (gemma's global layers, not its local rings; zamba2's
shared attention, not its Mamba2 states).  The prompt is fed token by
token, as the reference's engine feeds it.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ArchConfig, ShapeConfig
from repro_torch.core.backend import get_backend
from repro_torch.core.device import derive_seed, make_generator
from repro_torch.core.spec import ClusterSpec, StopSpec
from repro_torch.models.attention import compress_kv_cache
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.lm import DecoderLM
from repro_torch.models.registry import cache_kind
from repro_torch.stream.kv import refresh_layer_cache
from repro_torch.telemetry import NULL, get_run_logger


@dataclasses.dataclass
class ServeConfig:
    max_tokens: int = 32
    recompress_every: int = 0       # 0 = never (window ring handles recency)
    recompress_iters: Optional[int] = None
                                    # deprecated alias: fixed Lloyd budget per
                                    # refresh (use recompress_stop or
                                    # recompress_spec); unset, the refresh
                                    # runs StopSpec(max_iters=4)
    recompress_stop: Optional[StopSpec] = None
                                    # stopping policy per refresh
    temperature: float = 0.0        # 0 = greedy
    kmeans_backend: str = "auto"    # LloydBackend of the refresh k-means
                                    # (repro_torch.core.backend)
    recompress_spec: "ClusterSpec | None" = None
                                    # a ClusterSpec whose merge/execution
                                    # sections supply the refresh stopping
                                    # policy + backend; overrides
                                    # recompress_iters / recompress_stop /
                                    # kmeans_backend when set
    telemetry: str = "off"          # RunLogger name (repro_torch.telemetry):
                                    # tokens/s per generate + recompress
                                    # timers


def resolve_recompress(scfg: ServeConfig) -> tuple[StopSpec, str]:
    """Resolve the refresh stopping policy and backend name from a
    :class:`ServeConfig`.

    Precedence: ``recompress_spec`` (its merge section *is* the refresh) >
    ``recompress_stop`` > the deprecated ``recompress_iters`` alias >
    ``StopSpec(max_iters=4)``.  ``recompress_iters`` beside a spec is
    ignored with a :class:`DeprecationWarning`; beside ``recompress_stop``
    it raises."""
    rspec = scfg.recompress_spec
    if rspec is not None:
        if scfg.recompress_iters is not None:
            warnings.warn(
                "ServeConfig.recompress_iters is ignored when "
                "recompress_spec is set — the spec's merge section is the "
                "canonical refresh policy (recompress_iters is a deprecated "
                "alias; drop it or encode it as recompress_spec.merge.stop)",
                DeprecationWarning, stacklevel=2)
        return rspec.merge.effective_stop, rspec.execution.backend
    if scfg.recompress_stop is not None:
        if scfg.recompress_iters is not None:
            raise ValueError(
                "ServeConfig: pass either recompress_stop or the deprecated "
                "recompress_iters alias, not both")
        return scfg.recompress_stop, scfg.kmeans_backend
    if scfg.recompress_iters is not None:
        warnings.warn(
            "ServeConfig.recompress_iters is deprecated: use "
            "recompress_stop=StopSpec(max_iters=...) (or a recompress_spec)",
            DeprecationWarning, stacklevel=2)
        return StopSpec(max_iters=scfg.recompress_iters), scfg.kmeans_backend
    return StopSpec(max_iters=4), scfg.kmeans_backend


class ServeEngine:
    """Batched generation from a :class:`DecoderLM` or an
    :class:`EncDecLM` (``params``: the model holding the weights, built
    for ``cfg``) at ``shape``, whose cache kind follows
    :func:`~repro_torch.models.cache_kind`."""

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig,
                 params: "DecoderLM | EncDecLM",
                 scfg: Optional[ServeConfig] = None, *, logger=None):
        if (not isinstance(params, (DecoderLM, EncDecLM))
                or params.cfg != cfg):
            raise TypeError("ServeEngine: params must be the DecoderLM or "
                            f"EncDecLM built for {cfg.name} "
                            f"(build_model(cfg))")
        self.cfg, self.shape = cfg, shape
        self.model = params
        self.device = params.device
        self.scfg = scfg or ServeConfig()
        self.kind = cache_kind(cfg, shape)
        every = self.scfg.recompress_every
        if (self.kind == "clustered" and every > 0
                and every > shape.cluster_window):
            # the ring would overwrite tokens before a refresh ever folds
            # them into the centroids — they would vanish from the cache
            raise ValueError(
                f"recompress_every={every} exceeds cluster_window="
                f"{shape.cluster_window}: tokens would be evicted unfolded")
        self.refresh_stop, backend_name = resolve_recompress(self.scfg)
        self.refresh_backend = get_backend(backend_name, device=self.device)
        self._n_generate_calls = 0
        self.logger = get_run_logger(logger if logger is not None
                                     else self.scfg.telemetry)
        self._tok_rate = self.logger.rate("decode_rate", units="tokens",
                                          window=16)

    def _decode(self, caches: dict, tokens: torch.Tensor, pos: int):
        return self.model.decode_step(tokens, caches, pos,
                                      cache_kind=self.kind)

    def _refresh_tree(self, c, last: int):
        """Refresh every clustered sub-cache of a cache dict (a dict that
        holds ``kc`` is one stacked clustered cache): the flat layout
        ``{"blocks": {kc, ...}}``, gemma's ``{"super": {"local": ...,
        "global": {kc, ...}}}`` and zamba2's ``{"super": {"mamba": ...,
        "attn": {kc, ...}}}``, whose rings and states pass unchanged."""
        if isinstance(c, dict):
            if "kc" in c:
                return refresh_layer_cache(c, last, stop=self.refresh_stop,
                                           backend=self.refresh_backend)
            return {k: self._refresh_tree(v, last) for k, v in c.items()}
        return c

    def _maybe_recompress(self, caches: dict, pos: int) -> dict:
        """Fold each clustered group's window into its centroids when the
        position hits the recompression cadence (no-op otherwise)."""
        every = self.scfg.recompress_every
        if (self.kind != "clustered" or every <= 0 or pos == 0
                or pos % every != 0):
            return caches
        with self.logger.timer("recompress", pos=pos):
            return self._refresh_tree(caches, pos - 1)

    # -- prefill -----------------------------------------------------------
    def prefill(self, tokens: torch.Tensor):
        """Feeds the prompt (B, S) through decode steps one position at a
        time, as the reference's engine does.  -> (caches, logits of the
        last position, S)."""
        b, s = tokens.shape
        caches = self.model.init_caches(b, self.shape, self.kind)
        logits = None
        for i in range(s):
            logits, caches = self._decode(caches, tokens[:, i:i + 1], i)
            caches = self._maybe_recompress(caches, i + 1)
        return caches, logits, s

    # -- decode loop ---------------------------------------------------------
    def generate(self, tokens, max_tokens: Optional[int] = None,
                 seed: "int | torch.Generator | None" = None) -> np.ndarray:
        """Generate ``max_tokens`` tokens after the (B, S) prompt ``tokens``
        -> (B, max_tokens) int32.  Greedy at ``temperature == 0``; else
        sampled from a generator seeded by ``seed``, or, without one, from
        a fresh stream per call (the call counter folded into seed 0), so
        repeated calls are reproducible as a sequence without sampling the
        same tokens."""
        max_tokens = max_tokens or self.scfg.max_tokens
        tokens = torch.as_tensor(tokens, device=self.device).long()
        gen = None
        if self.scfg.temperature > 0:
            if seed is None:
                self._n_generate_calls += 1
                seed = derive_seed(0, self._n_generate_calls)
            gen = make_generator(seed, self.device)
        caches, logits, pos = self.prefill(tokens)
        out = []
        b = tokens.shape[0]
        t_loop = time.perf_counter()
        for _ in range(max_tokens):
            last = logits[:, -1].float()
            if gen is not None:
                probs = torch.softmax(last / self.scfg.temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)
            else:
                nxt = last.argmax(-1, keepdim=True)
            out.append(nxt)
            logits, caches = self._decode(caches, nxt, pos)
            pos += 1
            caches = self._maybe_recompress(caches, pos)
            if self.logger is not NULL:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                now = time.perf_counter()
                self._tok_rate.tick(b, dur=now - t_loop, pos=pos)
                t_loop = now
        return torch.cat(out, 1).to(torch.int32).cpu().numpy()


def build_clustered_cache_from_full(k: torch.Tensor, v: torch.Tensor,
                                    shape: ShapeConfig, *, iters: int = 8):
    """Offline compression path: full (B, kv, S, dh) -> clustered cache
    tensors (kc, vc, counts) via the paper pipeline (contiguous equal
    chunks + per-chunk k-means)."""
    c = shape.cluster_compression
    chunk = min(k.shape[2], max(4 * c, 64))
    return compress_kv_cache(k, v, chunk=chunk, compression=c, iters=iters)
