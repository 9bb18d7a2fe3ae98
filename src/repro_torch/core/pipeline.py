"""The paper's end-to-end method: partition -> local k-means -> merge
k-means, the port's counterpart of :mod:`repro.core.pipeline` (single
mode).

The method is factored into the same stage functions:

  ``chunk_fold``   partition one (feature-scaled) block of points and run
                   the batched local k-means on it — the paper's "device
                   part": one lane per subcluster, one kernel launch per
                   Lloyd iteration for all of them;
  ``reduce_pool``  one level of the hierarchical reduce tree over a
                   weighted center pool;
  ``merge_pool``   the merge ("host part") k-means over a weighted pool,
                   its restarts batched as lanes;
  ``scale_pass``   streaming per-attribute min/max (the feature-scale
                   parameters without a resident tensor);
  ``sse_pass``     chunked exact SSE of a source against fitted centers.

:func:`fit_from_spec` composes them over one resident tensor;
:func:`fit_chunked` composes the same stages over a
:class:`repro_torch.data.source.DataSource`, so the dataset only ever
exists chunk by chunk on the device (``mode="chunked"``, the out-of-core
executor); :mod:`repro_torch.stream.engine` folds them incrementally.
``sampled_kmeans`` / ``standard_kmeans`` are the thin adapters; the
multi-device executors of :mod:`repro_torch.core.distributed` reuse the same
stages per shard.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import NamedTuple, Optional

import torch

from .backend import BackendSpec, LloydBackend, get_backend
from .device import derive_seed, make_generator, resolve_device, seed_of
from .kmeans import KMeansResult, kmeans_batched
from .metrics import sse as sse_fn
from .spec import ClusterSpec, LevelSpec, MergeSpec, StopSpec
from .subcluster import (Partition, feature_scale, gather_partitions,
                         get_partitioner, unscale)

_now = time.perf_counter

# row block of the final SSE: a (block, k) distance tile at a time, so the
# full (N, k) matrix never exists
SSE_BLOCK = 65536

# child streams of a fit's seed (the JAX package splits its key in two and
# folds ``1 + i`` into the local key for reduce level i)
_LOCAL, _GLOBAL = 0, 1
# per-chunk stream of the out-of-core executor: chunk 0 reuses the local
# stream itself (the one-chunk parity pin with fit_from_spec); chunk i > 0
# draws from child ``_CHUNK_KEY_OFFSET + i``, apart from the reduce levels'
# children ``1 + level``
_CHUNK_KEY_OFFSET = 1_000_003
# the bounded accumulator's flush j draws from child
# (``_FLUSH_KEY_OFFSET + shard``, j), apart from the chunks' and levels'
_FLUSH_KEY_OFFSET = 7_000_003
# shard i > 0 of a mesh path draws its local stream from child
# ``_SHARD_KEY_OFFSET + i`` of the fit's (core/distributed.py::shard_seed);
# shard 0 draws the one-device path's
_SHARD_KEY_OFFSET = 5_000_011


class SampledClusteringResult(NamedTuple):
    centers: torch.Tensor        # (k, d) final centers, in the *input* space
    sse: torch.Tensor            # () SSE of the input points vs final centers
    local_centers: torch.Tensor  # (pool, d) the representatives the merge saw
    local_weights: torch.Tensor  # (pool,) member counts (0 = dead slot)
    n_dropped: torch.Tensor      # () capacity overflow, in original points


def local_stage(
    parts: torch.Tensor,         # (P, cap, d)
    part_w: torch.Tensor,        # (P, cap)
    k_local: int,
    *,
    generator: torch.Generator,
    init: str = "kmeans++",
    backend: BackendSpec = None,
    stop: Optional[StopSpec] = None,
) -> KMeansResult:
    """Per-partition k-means — the paper's "device part", where the CUDA
    original ran one thread block per subcluster.  Here the partitions are
    the batch axis of one k-means, so one kernel launch per Lloyd iteration
    serves all P of them.  With ``stop.tol > 0`` each partition is a masked
    lane (converged partitions freeze); the result's ``n_iter`` is the
    per-partition ``(P,)`` true count."""
    return kmeans_batched(parts, k_local, weights=part_w,
                          generator=generator, init=init, backend=backend,
                          stop=stop or StopSpec())


def chunk_fold(xs: torch.Tensor, lv: LevelSpec, generator: torch.Generator,
               *, backend: BackendSpec = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """Partition one (already feature-scaled) block of points and summarise
    it with the local stage: ``(m, d)`` points -> ``(n_sub * k_local, d)``
    weighted centers + ``(n_sub * k_local,)`` member counts + ``()``
    dropped-point count (Algorithm 2 overflow) + ``()`` Lloyd iterations
    executed, summed over the partitions."""
    part: Partition = get_partitioner(lv.scheme)(xs, lv.n_sub,
                                                 lv.capacity_factor)
    parts, part_w = gather_partitions(xs, part)
    k_local = max(1, parts.shape[1] // lv.compression)
    local = local_stage(parts, part_w, k_local, generator=generator,
                        init=lv.init, backend=backend,
                        stop=lv.effective_stop)
    d = xs.shape[-1]
    return (local.centers.reshape(lv.n_sub * k_local, d),
            local.counts.reshape(lv.n_sub * k_local),
            part.n_dropped, local.n_iter.sum())


def merge_pool(pool: torch.Tensor, pool_w: torch.Tensor, merge: MergeSpec,
               generator: torch.Generator, *,
               backend: BackendSpec = None) -> KMeansResult:
    """The merge ("host part") k-means over a weighted representative pool.

    ``merge.weighted`` weights each representative by its member count;
    otherwise every live (count > 0) representative votes equally, exactly
    as the paper merges.  The restarts run as lanes of one batch (sharing
    the pool) and the lowest-SSE one wins.  Returns unbatched results."""
    merge_w = pool_w if merge.weighted else (pool_w > 0).to(pool.dtype)
    res = kmeans_batched(pool[None], merge.k, weights=merge_w[None],
                         generator=generator, init=merge.init,
                         backend=backend, restarts=merge.restarts,
                         stop=merge.effective_stop)
    return KMeansResult(*(t[0] for t in res))


def reduce_pool(pool: torch.Tensor, pool_w: torch.Tensor, level: LevelSpec,
                generator: torch.Generator, backend: BackendSpec = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One level of the hierarchical reduce tree: re-partition a weighted
    center pool and run the (weighted) local stage on it.

    ``(n, d)`` pool + ``(n,)`` mass -> ``(n', d)`` pool + ``(n',)`` mass +
    ``()`` dropped mass (0 under the ``equal`` scheme; the ``unequal``
    scheme's capacity can drop entries, each standing for ``pool_w``
    original points)."""
    part = get_partitioner(level.scheme)(pool, level.n_sub,
                                         level.capacity_factor)
    parts, part_w = gather_partitions(pool, part, weights=pool_w)
    w_dropped = pool_w.float().sum() - part_w.float().sum()
    k_local = max(1, parts.shape[1] // level.compression)
    local = local_stage(parts, part_w, k_local, generator=generator,
                        init=level.init, backend=backend,
                        stop=level.effective_stop)
    d = pool.shape[-1]
    return (local.centers.reshape(level.n_sub * k_local, d),
            local.counts.reshape(level.n_sub * k_local),
            w_dropped.clamp_min(0.0))


def _log_stage_iters(log, stage: str, iters_run: int,
                     iters_budget: int) -> None:
    """Telemetry of the convergence contract: Lloyd iterations a stage
    executed vs its ``max_iters`` budget (host-side; callers guard with
    ``log is not NULL`` so unlogged runs never sync on the device)."""
    log.event("stage_iters", stage=stage, iters_run=iters_run,
              iters_budget=iters_budget,
              iters_saved=max(0, iters_budget - iters_run))


def fit_from_spec(x, spec: ClusterSpec,
                  seed: "int | torch.Generator" = 0, *,
                  backend: BackendSpec = None, logger=None,
                  device: "torch.device | str | None" = None
                  ) -> SampledClusteringResult:
    """Run the full pipeline declared by ``spec`` on one device: partition
    -> local k-means -> (optional reduce levels over the weighted center
    pool, ``spec.levels``) -> merge -> SSE of the input points.

    ``x`` is an (N, d) array-like, moved to ``device`` (``None``: the CUDA
    device; a missing one raises).  ``seed`` (an int or a
    ``torch.Generator``) takes the place of the JAX package's ``key``:
    the local stage, each reduce level and the merge draw from child
    streams derived from it.  ``backend`` overrides
    ``spec.execution.backend``; ``logger`` overrides
    ``spec.execution.telemetry``.  Telemetry is host-side: a logged fit is
    bit-for-bit the unlogged fit."""
    from repro_torch.telemetry import NULL, get_run_logger
    log = get_run_logger(logger if logger is not None
                         else spec.execution.telemetry)
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    base_seed = seed_of(seed)
    seed_local = derive_seed(base_seed, _LOCAL)
    be = get_backend(backend if backend is not None
                     else spec.execution.backend, device=dev)

    t_start = _now()
    d = x.shape[-1]
    if spec.scale:
        xs, params = feature_scale(x)
    else:
        xs, params = x, None

    base = spec.level_schedule()[0]
    with log.timer("fold", rows=int(x.shape[0])):
        local_centers, local_counts, n_dropped, fold_iters = chunk_fold(
            xs, base, make_generator(seed_local, dev), backend=be)
    if log is not NULL:
        _log_stage_iters(log, "fold", int(fold_iters),
                         base.effective_stop.max_iters * base.n_sub)

    # hierarchical reduce tree (a no-op for the paper's flat pipeline)
    for i, lvl in enumerate(spec.levels):
        with log.timer("reduce_level", level=i,
                       pool_in=int(local_centers.shape[0])):
            local_centers, local_counts, w_dropped = reduce_pool(
                local_centers, local_counts, lvl,
                make_generator(derive_seed(seed_local, 1 + i), dev),
                backend=be)
        n_dropped = n_dropped + torch.round(w_dropped).to(n_dropped.dtype)

    with log.timer("merge", pool=int(local_centers.shape[0]),
                   k=spec.merge.k):
        merged = merge_pool(local_centers, local_counts, spec.merge,
                            make_generator(derive_seed(base_seed, _GLOBAL),
                                           dev), backend=be)
    if log is not NULL:
        _log_stage_iters(log, "merge", int(merged.n_iter),
                         spec.merge.effective_stop.max_iters)

    centers = merged.centers
    if spec.scale:
        centers = unscale(centers, params)
        local_centers = unscale(local_centers, params)
    with log.timer("sse"):
        total_sse = sse_fn(x, centers, block=SSE_BLOCK)
    if log is not NULL:
        wall = _now() - t_start
        log.event("fit_from_spec", n=int(x.shape[0]), d=d, k=spec.merge.k,
                  levels=spec.n_levels, backend=be.name, wall_s=wall,
                  points_per_sec=int(x.shape[0]) / max(wall, 1e-9))
    return SampledClusteringResult(centers, total_sse, local_centers,
                                   local_counts, n_dropped)


# ---------------------------------------------------------------------------
# The out-of-core chunked executor (mode="chunked")
# ---------------------------------------------------------------------------

def minmax_pass(source, chunk_points: int, *, prefetch: int = 2,
                device: "torch.device | str | None" = None
                ) -> tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Running per-attribute ``(min, max)`` over a source's chunks on
    ``device`` (``None``: the CUDA device) — ``(None, None)`` when the
    source yields no rows.  Min and max are exact and order-independent."""
    from repro_torch.data.source import prefetch_to_device
    lo = hi = None
    for chunk in prefetch_to_device(source.chunks(chunk_points), prefetch,
                                    device=device):
        if chunk.shape[0] == 0:
            continue
        clo, chi = chunk.amin(0), chunk.amax(0)
        lo = clo if lo is None else torch.minimum(lo, clo)
        hi = chi if hi is None else torch.maximum(hi, chi)
    return lo, hi


def scale_pass(source, chunk_points: int, *, prefetch: int = 2,
               eps: float = 1e-9,
               device: "torch.device | str | None" = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming feature-scale parameters: one pass of running min/max over
    the source's chunks instead of a resident :func:`feature_scale`.
    Returns the same ``(lo, span)`` pair (span clamped at ``eps``), equal
    bit for bit to :func:`feature_scale`'s for any chunking."""
    lo, hi = minmax_pass(source, chunk_points, prefetch=prefetch,
                         device=device)
    if lo is None:
        raise ValueError("scale_pass: the source yielded no chunks")
    return lo, (hi - lo).clamp_min(eps)


def sse_pass(source, centers: torch.Tensor, chunk_points: int, *,
             prefetch: int = 2) -> torch.Tensor:
    """Chunked exact SSE on the centers' device: the final-accuracy pass of
    the out-of-core executor.  Memory stays O(chunk_points · k); a
    one-chunk traversal is the very ``sse_fn`` call of
    :func:`fit_from_spec`."""
    from repro_torch.data.source import prefetch_to_device
    total = None
    for chunk in prefetch_to_device(source.chunks(chunk_points), prefetch,
                                    device=centers.device):
        s = sse_fn(chunk, centers, block=SSE_BLOCK)
        total = s if total is None else total + s
    if total is None:
        raise ValueError("sse_pass: the source yielded no chunks")
    return total


class ChunkStats(NamedTuple):
    """Out-of-core accounting of one :func:`fit_chunked` run: what shows
    that the dataset never sat in one place."""
    n_points: int          # rows folded through the pipeline
    n_chunks: int          # chunks the fold pass consumed
    max_chunk_points: int  # largest single resident chunk (rows)
    pool_size: int         # representative pool rows the merge stage saw
    prefetch: int          # chunks in flight at once (host → device)
    passes: int            # data passes: fold (+ scale) (+ exact SSE)
    peak_pool_rows: int = 0  # most pool rows alive during the fold: bounded
    #                          by the flushing accumulator, not O(n_chunks)


class _PoolAccumulator:
    """Bounded accumulator of the fold pass's per-chunk pools.

    Without reduce levels every chunk pool survives to the final
    concatenation.  With ``spec.levels`` the pending chunk pools are folded
    early through ``levels[0]`` (the :func:`reduce_pool` of the final
    chain) once :data:`~repro_torch.core.spec.CHUNK_FOLD_BUFFER` of them
    are pending, so the peak pool is O(level pool), not O(n_chunks · chunk
    pool).  ``finalize`` returns the concatenated remainder, to which the
    caller applies the full level chain, so a run that never flushes is
    what an unbuffered executor gives.  Flush j draws from child
    ``(_FLUSH_KEY_OFFSET + shard, j)`` of the local stream.  Rows are
    counted from shapes: no host sync."""

    def __init__(self, levels, seed_local: int, device: torch.device, *,
                 shard: int = 0, backend: BackendSpec = None, log=None):
        from repro_torch.core.spec import CHUNK_FOLD_BUFFER
        from repro_torch.telemetry import NULL
        self._level = levels[0] if levels else None
        self._buffer = CHUNK_FOLD_BUFFER
        self._seed_local = seed_local
        self._shard = shard
        self._device = device
        self._backend = backend
        self._log = log if log is not None else NULL
        self._pools: list = []
        self._ws: list = []
        self._rows = 0
        self.peak_rows = 0
        self.n_flushes = 0
        self.w_dropped: Optional[torch.Tensor] = None  # flushes' dropped mass

    def add(self, centers: torch.Tensor, counts: torch.Tensor) -> None:
        self._pools.append(centers)
        self._ws.append(counts)
        self._rows += int(centers.shape[0])
        self.peak_rows = max(self.peak_rows, self._rows)
        # len - (1 if flushed) = pending chunk pools beyond the folded head
        if (self._level is not None
                and len(self._pools) - (1 if self.n_flushes else 0)
                >= self._buffer):
            self._flush()

    def _concat(self) -> tuple[torch.Tensor, torch.Tensor]:
        if len(self._pools) == 1:
            return self._pools[0], self._ws[0]
        return torch.cat(self._pools), torch.cat(self._ws)

    def _flush(self) -> None:
        pool, pool_w = self._concat()
        gen = make_generator(derive_seed(
            self._seed_local, _FLUSH_KEY_OFFSET + self._shard,
            self.n_flushes), self._device)
        with self._log.timer("pool_flush", flush=self.n_flushes,
                             rows_in=int(pool.shape[0])):
            pool, pool_w, wd = reduce_pool(pool, pool_w, self._level, gen,
                                           backend=self._backend)
        self.w_dropped = wd if self.w_dropped is None else self.w_dropped + wd
        self._pools, self._ws = [pool], [pool_w]
        self._rows = int(pool.shape[0])
        self.peak_rows = max(self.peak_rows, self._rows)
        self.n_flushes += 1

    def finalize(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Concatenated (pool, weights) of the folded head and the pending
        chunk pools: what the final level chain and the merge consume."""
        if not self._pools:
            raise ValueError("fold accumulator: no chunk pools were added")
        return self._concat()


def _fold_scaled_chunk(chunk: torch.Tensor, params, lv: LevelSpec,
                       generator: torch.Generator, backend: BackendSpec
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """:func:`chunk_fold` of one chunk scaled by the *global* parameters
    ``(lo, span)`` (``None``: unscaled), by the arithmetic of
    :func:`feature_scale`."""
    if params is not None:
        lo, span = params
        chunk = (chunk - lo) / span
    return chunk_fold(chunk, lv, generator, backend=backend)


class FoldResult(NamedTuple):
    """What :func:`fold_pass` leaves: the accumulated pool and its
    accounting.  ``n_dropped`` and ``fold_iters`` stay on the device."""
    pool: torch.Tensor           # (pool, d) scaled representatives
    pool_w: torch.Tensor         # (pool,) their mass
    n_dropped: torch.Tensor      # () Algorithm 2 drops + flushes' drops
    fold_iters: torch.Tensor     # () Lloyd iterations run, all chunks
    fold_budget: int             # the sum of their max_iters budgets
    n_points: int
    n_chunks: int
    max_chunk_points: int
    peak_pool_rows: int


class ShardFold:
    """One source shard's fold state on its device: the bounded pool
    accumulator and the counts (``n_dropped`` and the Lloyd iterations stay
    on the device; rows and chunks are counted from shapes).
    :func:`fold_pass` runs one; the sharded executor one per mesh entry.

    Chunk j of shard s draws from the local stream ``seed_local`` itself
    for s = j = 0 and from its child ``(s + 1) * _CHUNK_KEY_OFFSET + j``
    otherwise, so shard 0 draws the one-shard fold's streams.  A chunk
    smaller than ``n_sub`` clamps its partition count to its rows."""

    def __init__(self, spec: ClusterSpec, params, seed_local: int,
                 device: torch.device, backend: LloydBackend, *,
                 shard: int = 0, log=None):
        self._base = spec.level_schedule()[0]
        self._params = params
        self._seed_local = seed_local
        self._shard = shard
        self._device = device
        self._backend = backend
        self.acc = _PoolAccumulator(spec.levels, seed_local, device,
                                    shard=shard, backend=backend, log=log)
        self.n_dropped = torch.zeros((), dtype=torch.int64, device=device)
        self.fold_iters = torch.zeros((), dtype=torch.int64, device=device)
        self.fold_budget = self.n_points = self.n_chunks = 0
        self.max_chunk_points = 0

    def add(self, j: int, chunk: torch.Tensor) -> int:
        """Fold chunk ``j`` of this shard's stream; returns its rows."""
        m = int(chunk.shape[0])
        if m == 0:
            return 0
        base = self._base
        lv = (base if m >= base.n_sub
              else dataclasses.replace(base, n_sub=max(1, m)))
        cs = (self._seed_local if self._shard == 0 and j == 0
              else derive_seed(self._seed_local,
                               (self._shard + 1) * _CHUNK_KEY_OFFSET + j))
        c, w, nd, iters = _fold_scaled_chunk(
            chunk, self._params, lv, make_generator(cs, self._device),
            self._backend)
        self.acc.add(c, w)
        self.n_dropped = self.n_dropped + nd
        self.fold_iters = self.fold_iters + iters
        self.fold_budget += lv.effective_stop.max_iters * lv.n_sub
        self.n_points += m
        self.n_chunks += 1
        self.max_chunk_points = max(self.max_chunk_points, m)
        return m

    def result(self) -> "FoldResult":
        """The accumulated pool (the head folded through ``levels[0]``
        plus the pending chunk pools) and the accounting."""
        pool, pool_w = self.acc.finalize()
        n_dropped = self.n_dropped
        if self.acc.w_dropped is not None:   # flushes clamp overflow mass
            n_dropped = n_dropped + torch.round(self.acc.w_dropped).to(
                n_dropped.dtype)
        return FoldResult(pool, pool_w, n_dropped, self.fold_iters,
                          self.fold_budget, self.n_points, self.n_chunks,
                          self.max_chunk_points, self.acc.peak_rows)


def fold_pass(source, spec: ClusterSpec, params, seed_local: int, *,
              backend: BackendSpec = None, logger=None,
              device: "torch.device | str | None" = None) -> FoldResult:
    """The out-of-core executor's fold: each chunk of ``source`` is scaled
    by ``params`` (``(lo, span)`` or ``None``), partitioned and summarised
    by :func:`chunk_fold`, and its pool goes into the bounded accumulator
    (:class:`ShardFold`: chunk 0 draws from the local stream ``seed_local``
    itself, chunk i > 0 from its child ``_CHUNK_KEY_OFFSET + i``).  Nothing
    is read back from the device unless a logger is on."""
    from repro_torch.data.source import prefetch_to_device
    from repro_torch.telemetry import get_run_logger
    log = get_run_logger(logger)
    dev = resolve_device(device)
    fold = ShardFold(spec, params, seed_local, dev,
                     get_backend(backend, device=dev), log=log)
    fold_rate = log.rate("fold_rate", units="points")
    for i, chunk in enumerate(prefetch_to_device(
            source.chunks(spec.chunk.chunk_points), spec.chunk.prefetch,
            device=dev)):
        m = fold.add(i, chunk)
        if m:
            fold_rate.tick(m, chunk=i, rows=m)
    if fold.n_chunks == 0:
        raise ValueError("fit_chunked: the source yielded no points")
    return fold.result()


def fit_chunked(source, spec: ClusterSpec,
                seed: "int | torch.Generator" = 0, *,
                backend: BackendSpec = None, logger=None,
                device: "torch.device | str | None" = None
                ) -> tuple[SampledClusteringResult, ChunkStats]:
    """Run the spec's pipeline **out of core** over a
    :class:`repro_torch.data.source.DataSource` (an (n, d) array wraps into
    an ``ArraySource``) on ``device`` (``None``: the CUDA device): the
    dataset exists on the device ``spec.chunk.chunk_points`` rows at a time
    (``spec.chunk.prefetch`` chunks in flight).

    Passes over the data, each chunked through the pinned prefetcher:

      1. :func:`scale_pass`: the global feature-scale parameters (skipped
         when ``spec.scale`` is off);
      2. :func:`fold_pass`: each chunk scaled, partitioned and summarised,
         the pools accumulated (folded early through ``levels[0]`` every
         ``CHUNK_FOLD_BUFFER`` pending pools when the spec has levels);
      3. ``spec.levels`` reduce the accumulated pool and
         :func:`merge_pool` gives the k centers, as in
         :func:`fit_from_spec`;
      4. :func:`sse_pass` (``spec.chunk.sse="exact"``), or the pool's
         weighted SSE (``"pool"``, no extra pass).

    A source that fits in one chunk gives :func:`fit_from_spec`'s result
    bit for bit under the same seed.  Returns ``(result, ChunkStats)``.
    Telemetry (per-stage timers, a per-chunk ``fold_rate`` meter, a summary
    event) is host-side: a logged fit is the unlogged fit bit for bit."""
    from repro_torch.data.source import as_source
    from repro_torch.telemetry import NULL, get_run_logger, peak_rss_mb
    log = get_run_logger(logger if logger is not None
                         else spec.execution.telemetry)
    source = as_source(source)
    dev = resolve_device(device)
    base_seed = seed_of(seed)
    seed_local = derive_seed(base_seed, _LOCAL)
    be = get_backend(backend if backend is not None
                     else spec.execution.backend, device=dev)
    cp, depth = spec.chunk.chunk_points, spec.chunk.prefetch

    t_start = _now()
    passes = 1
    params = None
    if spec.scale:
        with log.timer("scale_pass"):
            params = scale_pass(source, cp, prefetch=depth, device=dev)
        passes += 1
    with log.timer("fold"):
        fold = fold_pass(source, spec, params, seed_local, backend=be,
                         logger=log, device=dev)
    pool, pool_w, n_dropped = fold.pool, fold.pool_w, fold.n_dropped

    for j, lvl in enumerate(spec.levels):
        with log.timer("reduce_level", level=j, pool_in=int(pool.shape[0])):
            pool, pool_w, w_dropped = reduce_pool(
                pool, pool_w, lvl,
                make_generator(derive_seed(seed_local, 1 + j), dev),
                backend=be)
        n_dropped = n_dropped + torch.round(w_dropped).to(n_dropped.dtype)

    with log.timer("merge", pool=int(pool.shape[0]), k=spec.merge.k):
        merged = merge_pool(pool, pool_w, spec.merge,
                            make_generator(derive_seed(base_seed, _GLOBAL),
                                           dev), backend=be)
    if log is not NULL:
        _log_stage_iters(log, "fold", int(fold.fold_iters), fold.fold_budget)
        _log_stage_iters(log, "merge", int(merged.n_iter),
                         spec.merge.effective_stop.max_iters)

    centers, local_centers = merged.centers, pool
    if spec.scale:
        centers = unscale(centers, params)
        local_centers = unscale(local_centers, params)
    if spec.chunk.sse == "exact":
        with log.timer("sse_pass"):
            total_sse = sse_pass(source, centers, cp, prefetch=depth)
        passes += 1
    else:   # "pool": weighted SSE of the representatives, no extra pass
        with log.timer("sse_pool"):
            total_sse = sse_fn(local_centers, centers, weights=pool_w,
                               block=SSE_BLOCK)

    result = SampledClusteringResult(centers, total_sse, local_centers,
                                     pool_w, n_dropped)
    stats = ChunkStats(n_points=fold.n_points, n_chunks=fold.n_chunks,
                       max_chunk_points=fold.max_chunk_points,
                       pool_size=int(pool.shape[0]), prefetch=depth,
                       passes=passes, peak_pool_rows=fold.peak_pool_rows)
    if log is not NULL:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)   # wall time means "result ready"
        wall = _now() - t_start
        log.event("fit_chunked", k=spec.merge.k, levels=spec.n_levels,
                  backend=be.name, wall_s=wall,
                  points_per_sec=fold.n_points / max(wall, 1e-9),
                  peak_rss_mb=peak_rss_mb(), **stats._asdict())
    return result, stats


_SPEC_KWARGS = ("scheme", "n_sub", "compression", "local_iters",
                "global_iters", "init", "weighted_merge", "capacity_factor",
                "scale", "backend", "restarts")


def sampled_kmeans(
    x,
    k: int,
    *,
    spec: Optional[ClusterSpec] = None,
    seed: "int | torch.Generator" = 0,
    device: "torch.device | str | None" = None,
    **kwargs,
) -> SampledClusteringResult:
    """Two-level sampled clustering (the paper's full method) on
    ``device`` (``None``: the CUDA device).

    Thin adapter over :func:`fit_from_spec`: pass ``spec=`` (preferred) or
    the historical flat kwargs (``scheme=``, ``n_sub=``, ``compression=``,
    ... — deprecated spellings that build the same spec internally)."""
    if spec is not None:
        if kwargs:
            raise TypeError(
                f"sampled_kmeans: pass either spec= or flat kwargs, not "
                f"both (got {sorted(kwargs)})")
        if spec.merge.k != k:
            raise ValueError(
                f"sampled_kmeans(k={k}) disagrees with spec.merge.k="
                f"{spec.merge.k}")
    else:
        unknown = set(kwargs) - set(_SPEC_KWARGS)
        if unknown:
            raise TypeError(
                f"sampled_kmeans: unknown kwargs {sorted(unknown)}")
        if kwargs:
            warnings.warn(
                "sampled_kmeans(scheme=, n_sub=, compression=, ...) flat "
                "kwargs are deprecated: build a ClusterSpec (see "
                "repro_torch.core.spec) and pass spec= — or use the "
                "repro_torch.api.SampledKMeans facade",
                DeprecationWarning, stacklevel=2)
        spec = ClusterSpec.make(k, **kwargs)
    return fit_from_spec(x, spec, seed, device=device)


def standard_kmeans(
    x, k: int, *, iters: int = 25, seed: "int | torch.Generator" = 0,
    init: str = "kmeans++", scale: bool = True,
    backend: BackendSpec = None, restarts: int = 4,
    spec: Optional[ClusterSpec] = None,
    device: "torch.device | str | None" = None,
) -> SampledClusteringResult:
    """The baseline the paper compares against (plain Lloyd on all points)
    on ``device`` (``None``: the CUDA device), wrapped in the same result
    type.  With ``spec=`` the merge and execution sections supply (stop,
    init, restarts, backend, scale)."""
    stop = StopSpec(max_iters=iters)
    if spec is not None:
        if spec.merge.k != k:
            raise ValueError(
                f"standard_kmeans(k={k}) disagrees with spec.merge.k="
                f"{spec.merge.k}")
        stop = spec.merge.effective_stop
        init, restarts = spec.merge.init, spec.merge.restarts
        backend, scale = spec.execution.backend, spec.scale
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    xs, params = feature_scale(x) if scale else (x, None)
    res = kmeans_batched(
        xs[None], k, weights=torch.ones((1, x.shape[0]), dtype=x.dtype,
                                        device=dev),
        generator=make_generator(seed, dev), init=init,
        backend=get_backend(backend, device=dev), restarts=restarts,
        stop=stop)
    centers = unscale(res.centers[0], params) if scale else res.centers[0]
    return SampledClusteringResult(
        centers, sse_fn(x, centers, block=SSE_BLOCK), centers, res.counts[0],
        torch.zeros((), dtype=torch.int64, device=dev))
