"""Online sampled clustering: the paper's compression loop, run forever.

The port's counterpart of :mod:`repro.stream.engine`.  A data stream gets
the batch pipeline's two levels incrementally:

  1. each chunk is partitioned and summarised by the shared ``chunk_fold``
     stage (the paper's "device part"), on the chunk's own feature scale;
  2. the weighted local centers are folded into a bounded, exponentially
     decayed **coreset buffer** (the heaviest ``buffer_size`` entries
     survive);
  3. the k global centers are refreshed by a warm-started weighted k-means
     over the coreset (``init`` = the previous centers), after centers
     whose coreset support fell to zero are reseeded from the heaviest
     badly covered coreset points.

``StreamState`` is a NamedTuple of tensors plus an integer seed, and
``update`` returns a new state (the old one is untouched).  Each update
splits the state's seed into a local, a merge and a next seed, as the
reference splits its key.  Nothing in an update reads a value back from
the device unless a logger is on.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import NamedTuple, Optional

import torch

from repro_torch.core.backend import BackendSpec, LloydBackend, get_backend
from repro_torch.core.device import (derive_seed, make_generator,
                                     resolve_device, seed_of)
from repro_torch.core.kmeans import kmeans_batched, pairwise_sqdist
from repro_torch.core.metrics import sse as sse_fn
from repro_torch.core.pipeline import SSE_BLOCK, chunk_fold, reduce_pool
from repro_torch.core.spec import ClusterSpec, LevelSpec, StopSpec
from repro_torch.core.subcluster import feature_scale, unscale

# child streams of a state's seed per update (the reference splits its key
# in three: local, merge, next)
_LOCAL, _MERGE, _NEXT = 0, 1, 2


class StreamState(NamedTuple):
    """The clusterer's state (fixed shapes)."""
    centers: torch.Tensor     # (k, d) current global centers, input space
    coreset: torch.Tensor     # (buffer_size, d) weighted representatives
    coreset_w: torch.Tensor   # (buffer_size,) decayed weights; 0 = empty
    n_seen: torch.Tensor      # () float32: raw points ingested so far
    step: torch.Tensor        # () int32: update counter
    key: int                  # seed of the next update's random streams


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Hyper-parameters of the streaming engine."""
    k: int
    n_sub: int = 8                 # partitions per chunk (paper's P)
    compression: int = 5           # paper's c: N-point partition -> N/c reps
    scheme: str = "equal"          # "equal" (Algo 1) | "unequal" (Algo 2)
    capacity_factor: float = 2.0   # Algo 2 capacity bound
    local_iters: int = 8           # Lloyd iters per partition
    merge_iters: int = 8           # warm-started Lloyd iters per update
    buffer_size: int = 1024        # coreset slots
    decay: float = 0.97            # per-update weight multiplier
    reseed_threshold: float = 1e-6  # coreset support below this = dead
    init_mode: str = "kmeans++"    # local-stage init
    backend: str = "auto"          # LloydBackend name
    telemetry: str = "off"         # RunLogger name: per-tick points/s
    levels: tuple = ()             # tuple[LevelSpec, ...]: reduce levels
    #                                compressing the coreset before merges
    local_stop: Optional[StopSpec] = None   # overrides local_iters when set
    merge_stop: Optional[StopSpec] = None   # overrides merge_iters when set

    @classmethod
    def from_spec(cls, spec: ClusterSpec, **overrides) -> "StreamConfig":
        """The streaming hyper-parameters of a
        :class:`~repro_torch.core.spec.ClusterSpec`: the partition and
        local sections configure the chunk summary, the merge section the
        coreset merge.  ``buffer_size``, ``decay`` and ``reseed_threshold``
        keep their defaults unless overridden."""
        base = dict(
            k=spec.merge.k,
            n_sub=spec.partition.n_sub,
            compression=spec.local.compression,
            scheme=spec.partition.scheme,
            capacity_factor=spec.partition.capacity_factor,
            local_iters=spec.local.iters,
            merge_iters=spec.merge.iters,
            init_mode=spec.local.init,
            backend=spec.execution.backend,
            telemetry=spec.execution.telemetry,
            levels=spec.levels,
            local_stop=spec.local.stop,
            merge_stop=spec.merge.stop,
        )
        base.update(overrides)
        return cls(**base)


def summarize_chunk(chunk: torch.Tensor, cfg: StreamConfig,
                    generator: torch.Generator,
                    backend: BackendSpec = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk -> (weighted local centers, weights): the paper's local stage.
    The chunk is scaled on its own min/max (its partition landmarks are
    chunk-local, as a batch fit scales on its input), folded through
    :func:`repro_torch.core.pipeline.chunk_fold`, and its centers come back
    in input space."""
    xs, params = feature_scale(chunk)
    lv = LevelSpec(n_sub=cfg.n_sub, compression=cfg.compression,
                   iters=cfg.local_iters, init=cfg.init_mode,
                   scheme=cfg.scheme, capacity_factor=cfg.capacity_factor,
                   stop=cfg.local_stop)
    centers, weights, _, _ = chunk_fold(
        xs, lv, generator,
        backend=backend if backend is not None else cfg.backend)
    return unscale(centers, params), weights


def fold_coreset(coreset: torch.Tensor, coreset_w: torch.Tensor,
                 new_pts: torch.Tensor, new_w: torch.Tensor, decay: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decay the buffer, append the fresh representatives, and keep the
    ``buffer_size`` heaviest entries.  Equal weights (empty slots, dead
    centers) keep their order, lower position first, as ``jax.lax.top_k``
    does: a stable descending sort, not ``torch.topk``."""
    buffer = coreset.shape[0]
    all_pts = torch.cat([coreset, new_pts])
    all_w = torch.cat([coreset_w * decay, new_w])
    top_w, top_i = torch.sort(all_w, descending=True, stable=True)
    return all_pts[top_i[:buffer]], top_w[:buffer]


def reseed_dead_centers(centers: torch.Tensor, coreset: torch.Tensor,
                        coreset_w: torch.Tensor,
                        threshold: float) -> torch.Tensor:
    """Replace centers with coreset support at most ``threshold`` by greedy
    farthest-point picks over the coreset, scored by ``weight * min_dist``
    (heavy, badly covered representatives first).  Live centers are
    untouched; the greedy loop spreads simultaneous reseeds over distinct
    regions.  The loop is k steps of device operations with no host read,
    center i in step i, as the reference's ``fori_loop``."""
    k = centers.shape[0]
    d2 = pairwise_sqdist(coreset, centers)          # one matrix, both uses
    support = torch.zeros(k, dtype=coreset_w.dtype,
                          device=coreset.device).index_add_(
        0, d2.argmin(1), coreset_w)
    dead = support <= threshold
    big = torch.finfo(coreset.dtype).max
    min_d = torch.where(dead[None, :], big, d2).amin(1)
    min_d = torch.where(dead.all(), torch.ones_like(min_d), min_d)  # none live
    out = centers.clone()
    for i in range(k):
        pick = coreset.index_select(
            0, torch.argmax(coreset_w * min_d).view(1))[0]
        new_c = torch.where(dead[i], pick, out[i])
        out[i] = new_c
        min_d = torch.minimum(min_d, ((coreset - new_c) ** 2).sum(-1))
    return out


def fold_and_merge(state: StreamState, new_pts: torch.Tensor,
                   new_w: torch.Tensor, n_new_points: int,
                   cfg: StreamConfig, seed: int,
                   backend: BackendSpec = None) -> StreamState:
    """The global half of an update: coreset fold, reseed, warm-started
    merge.  With ``cfg.levels`` the merge's input is first compressed
    through the reduce tree (:func:`reduce_pool`, level i from child
    ``1 + i`` of ``seed``); the coreset itself keeps its resolution."""
    be = backend if backend is not None else cfg.backend
    dev = state.centers.device
    coreset, coreset_w = fold_coreset(state.coreset, state.coreset_w,
                                      new_pts, new_w, cfg.decay)
    warm = reseed_dead_centers(state.centers, coreset, coreset_w,
                               cfg.reseed_threshold)
    pool, pool_w = coreset, coreset_w
    for i, lvl in enumerate(cfg.levels):
        pool, pool_w, _ = reduce_pool(
            pool, pool_w, lvl, make_generator(derive_seed(seed, 1 + i), dev),
            backend=be)
    merge_stop = (cfg.merge_stop if cfg.merge_stop is not None
                  else StopSpec(max_iters=cfg.merge_iters))
    merged = kmeans_batched(pool[None], cfg.k, weights=pool_w[None],
                            generator=make_generator(seed, dev),
                            init=warm[None], backend=be, stop=merge_stop)
    return StreamState(
        centers=merged.centers[0],
        coreset=coreset,
        coreset_w=coreset_w,
        n_seen=state.n_seen + float(n_new_points),
        step=state.step + 1,
        key=state.key,
    )


class StreamingClusterer:
    """Online sampled-k-means engine over chunks, on ``device`` (``None``:
    the CUDA device).

    >>> sc = StreamingClusterer(StreamConfig(k=8), device="cpu")
    >>> state = sc.init(dim=2)
    >>> for chunk in chunks:                    # (chunk_size, 2) each
    ...     state = sc.update(state, chunk)
    >>> assignment, total_sse = sc.query(state, x)

    ``init`` starts from all-zero centers and an empty coreset; the first
    ``update`` finds the unsupported centers and reseeds them from the
    chunk's representatives, so there is no separate warm-up path.
    """

    def __init__(self, cfg: StreamConfig | ClusterSpec, *,
                 backend: BackendSpec = None, logger=None,
                 device: "torch.device | str | None" = None):
        from repro_torch.telemetry import NULL, get_run_logger
        if isinstance(cfg, ClusterSpec):
            cfg = StreamConfig.from_spec(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.logger = get_run_logger(logger if logger is not None
                                     else cfg.telemetry)
        if any(lvl.scheme == "unequal" for lvl in cfg.levels):
            # the state has no n_dropped channel: an unequal level's
            # capacity clamp would shave merge-input mass on every update
            warnings.warn(
                "StreamingClusterer: unequal-scheme reduce levels can clamp "
                "overflow pool entries out of each merge input unreported — "
                "prefer equal-scheme levels (or raise capacity_factor)",
                stacklevel=2)
        # resolved once, so update and query share one backend
        self.backend: LloydBackend = get_backend(
            backend if backend is not None else cfg.backend,
            device=self.device)
        self._meter = (self.logger.rate("stream_tick", units="points")
                       if self.logger is not NULL else None)

    # -- state ------------------------------------------------------------
    def init(self, dim: int, seed: "int | torch.Generator" = 0,
             dtype=torch.float32) -> StreamState:
        cfg, dev = self.cfg, self.device
        return StreamState(
            centers=torch.zeros((cfg.k, dim), dtype=dtype, device=dev),
            coreset=torch.zeros((cfg.buffer_size, dim), dtype=dtype,
                                device=dev),
            coreset_w=torch.zeros((cfg.buffer_size,), dtype=dtype,
                                  device=dev),
            n_seen=torch.zeros((), dtype=torch.float32, device=dev),
            step=torch.zeros((), dtype=torch.int32, device=dev),
            key=seed_of(seed),
        )

    # -- update / query ---------------------------------------------------
    def update(self, state: StreamState, chunk) -> StreamState:
        """Fold one (m, d) chunk into ``state``; returns the new state.
        With a logger, a ``stream_tick`` rate (points/s, the device
        synchronised) per update."""
        t0 = time.perf_counter()
        chunk = torch.as_tensor(chunk, device=self.device)
        seed = state.key
        lc, lw = summarize_chunk(
            chunk, self.cfg,
            make_generator(derive_seed(seed, _LOCAL), self.device),
            self.backend)
        new = fold_and_merge(state, lc, lw, int(chunk.shape[0]), self.cfg,
                             derive_seed(seed, _MERGE), self.backend)
        new = new._replace(key=derive_seed(seed, _NEXT))
        if self._meter is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._meter.tick(int(chunk.shape[0]),
                             dur=time.perf_counter() - t0,
                             step=int(new.step))
        return new

    def query(self, state: StreamState, x
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """Assign points to the current centers: (assignment, total
        SSE)."""
        x = torch.as_tensor(x, device=self.device)
        idx, _ = self.backend.assign_points(x, state.centers,
                                            block=SSE_BLOCK)
        return idx, sse_fn(x, state.centers, block=SSE_BLOCK)
