"""`SampledKMeans` — the estimator facade over the paper's pipeline, with a
plan/execute split; the port's counterpart of :mod:`repro.api`.

    from repro_torch.api import SampledKMeans
    from repro_torch.core import ClusterSpec, MergeSpec, PartitionSpec
    from repro_torch.launch.mesh import make_mesh

    spec = ClusterSpec(merge=MergeSpec(k=40),
                       partition=PartitionSpec(scheme="equal", n_sub=16))
    est = SampledKMeans(spec).fit(x)     # on the CUDA device
    est = SampledKMeans(spec, mesh=make_mesh((4,), ("data",))).fit(x)
    #                                    # over four cards, 4 x 16 partitions
    labels = est.predict(x)
    for chunk in stream:                 # or: incremental
        est.partial_fit(chunk)

:func:`plan` resolves a spec ONCE (execution mode, Lloyd backend, registry
lookups) into an :class:`ExecutionPlan`; :func:`execute` runs it.  Modes:

  ``single``     the one-device pipeline (``core.pipeline.fit_from_spec``)
  ``shard_map``  the pipeline over a device mesh
                 (``core.distributed.make_distributed_sampled_kmeans``) —
                 pass ``mesh=`` (:mod:`repro_torch.launch.mesh`)
  ``chunked``    the out-of-core executor (``core.pipeline.fit_chunked``)
                 over a :class:`~repro_torch.data.source.DataSource`
  ``chunked_dist``  out of core and over a mesh
                 (``core.distributed.fit_chunked_dist``): one source shard
                 per mesh entry, the pools merged across the mesh
  ``stream``     the incremental coreset engine (``stream.engine``); ``fit``
                 feeds the data chunk by chunk, ``partial_fit`` is one update
  ``auto``       ``chunked_dist`` for a mesh and a non-resident source,
                 ``shard_map`` for a mesh and resident data, ``chunked`` for
                 a non-resident source, else ``single``

``fit`` under ``single`` is ``sampled_kmeans(x, spec=spec)`` bit for bit
under the same seed, and a ``chunked`` fit of a source that fits in one
chunk is the same fit; the mesh modes are their direct entry points'
fits.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.backend import (CudaTunedBackend, LloydBackend,
                                      get_backend)
from repro_torch.core.device import resolve_device
from repro_torch.core.kmeans import get_init, pairwise_sqdist
from repro_torch.core.metrics import map_row_blocks, min_sqdist
from repro_torch.core.pipeline import (ChunkStats, SampledClusteringResult,
                                       fit_chunked, fit_from_spec, sse_pass)
from repro_torch.core.spec import ClusterSpec
from repro_torch.core.subcluster import get_partitioner
from repro_torch.data.source import ArraySource, DataSource, as_source
from repro_torch.launch.mesh import Mesh, check_mesh
from repro_torch.telemetry import NULL, RunLogger, get_run_logger

# default row-block of the predict-side surfaces (transform/score): the
# working set stays O(block · k) however large the query set is
PREDICT_BLOCK = 16384


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """A resolved spec: concrete mode, device, one backend instance,
    validated registry entries.  ``schedule`` is the reduce-tree level
    schedule (base stage + ``spec.levels``).  Build with :func:`plan`, run
    with :func:`execute`."""
    spec: ClusterSpec
    mode: str                      # "single" | "shard_map" | "chunked" |
    #                                "chunked_dist" | "stream"
    backend: LloydBackend          # resolved once, shared by every stage
    device: torch.device
    mesh: Optional[Mesh] = None
    data_shape: Optional[tuple] = None
    schedule: tuple = ()           # tuple[LevelSpec, ...], base level first
    logger: RunLogger = NULL       # resolved spec.execution.telemetry

    @property
    def k(self) -> int:
        return self.spec.merge.k

    @property
    def n_levels(self) -> int:
        return len(self.schedule)


def _home(device, mesh) -> torch.device:
    """The device of a plan or estimator: ``device``; else the first mesh
    entry; else the CUDA device (a missing one raises)."""
    if mesh is not None:
        check_mesh(mesh)
        if device is None:
            device = mesh.devices.flat[0]
    return resolve_device(device)


def plan(spec: ClusterSpec, data_shape: Optional[tuple] = None, *,
         mesh: Optional[Mesh] = None,
         device: "torch.device | str | None" = None,
         source: Optional[DataSource] = None,
         logger: "RunLogger | str | None" = None) -> ExecutionPlan:
    """Resolve a declarative spec into an executable plan on ``device``
    (``None``: the first entry of ``mesh``, or the CUDA device; a missing
    one raises).

    Validates every registry name (partitioner, init schemes, backend) up
    front and picks the execution mode: an explicit
    ``spec.execution.mode`` wins; ``"auto"`` is ``"chunked_dist"`` for a
    mesh and a non-resident :class:`DataSource` (anything but an
    ``ArraySource``), ``"shard_map"`` for a mesh otherwise, ``"chunked"``
    for a non-resident source alone, else ``"single"``.  ``data_shape``
    lets the planner reject schedules whose final pool is below ``k``,
    shard_map rows that do not divide over the mesh, and chunked_dist runs
    with fewer chunks than shards; for a ``single`` fit on ``cuda_tuned``
    it also pre-warms the tuner's cache at every Lloyd shape the fit
    launches (:meth:`ClusterSpec.lloyd_shapes`)."""
    get_partitioner(spec.partition.scheme)
    get_init(spec.local.init)
    get_init(spec.merge.init)
    for lvl in spec.levels:
        get_partitioner(lvl.scheme)
        get_init(lvl.init)
    dev = _home(device, mesh)
    backend = get_backend(spec.execution.backend, device=dev)
    run_logger = get_run_logger(logger if logger is not None
                                else spec.execution.telemetry)
    mode = spec.execution.mode
    if mode == "auto":
        non_resident = (source is not None
                        and not isinstance(source, ArraySource))
        if mesh is not None:
            mode = "chunked_dist" if non_resident else "shard_map"
        else:
            mode = "chunked" if non_resident else "single"
    n = (int(data_shape[0]) if data_shape is not None and len(data_shape)
         else None)
    axis = spec.execution.mesh_axis
    if mode in ("shard_map", "chunked_dist") and mesh is None:
        raise ValueError(f"plan: mode={mode!r} needs a mesh= (see "
                         f"repro_torch.launch.mesh.make_mesh)")
    if mode == "shard_map":
        if axis not in mesh.axis_names:
            raise ValueError(f"plan: mesh has no {axis!r} axis "
                             f"(axes: {mesh.axis_names})")
        if n is not None and n % mesh.shape[axis]:
            raise ValueError(f"plan: {n} rows do not divide over "
                             f"{mesh.shape[axis]} devices along {axis!r}")
    if mode == "chunked_dist":
        if tuple(mesh.axis_names) != (axis,):
            raise ValueError(
                f"plan: mode='chunked_dist' needs a 1-D mesh over the "
                f"{axis!r} axis (spec.execution.mesh_axis), got axes "
                f"{mesh.axis_names}")
        if n:
            n_dev = mesh.shape[axis]
            n_chunks = -(-n // spec.chunk.chunk_points)
            if n_chunks < n_dev:
                raise ValueError(
                    f"plan: {n} rows make only {n_chunks} chunks of "
                    f"{spec.chunk.chunk_points} — not enough to feed "
                    f"{n_dev} devices one shard each (shrink chunk_points "
                    f"or the mesh)")
            sched = spec.chunked_dist_pool_schedule(n, n_dev)
            if sched[-1] < spec.merge.k:
                raise ValueError(
                    f"plan: the sharded chunk schedule leaves only "
                    f"{sched[-1]} representatives for a k={spec.merge.k} "
                    f"merge — use larger chunks, drop a level, or lower "
                    f"its compression (per-shard + global schedule: "
                    f"{sched})")
    if mode == "chunked" and n:
        sched = spec.chunked_pool_schedule(n)
        if sched[-1] < spec.merge.k:
            raise ValueError(
                f"plan: the chunked schedule leaves only {sched[-1]} "
                f"representatives for a k={spec.merge.k} merge — use larger "
                f"chunks, drop a level, or lower its compression (chunked "
                f"pool schedule: {sched})")
    if mode == "single" and n is not None:
        sched = spec.pool_schedule(n)
        if sched[-1] < spec.merge.k:
            raise ValueError(
                f"plan: the reduce tree leaves only {sched[-1]} "
                f"representatives for a k={spec.merge.k} merge — drop a "
                f"level or lower its compression (pool schedule: {sched})")
    if (isinstance(backend, CudaTunedBackend) and mode == "single" and n
            and len(data_shape) >= 2):
        # the tuned backend reads each launch's parameters from the tuner's
        # cache: pull the fit's Lloyd shapes through its layers into the
        # in-process LRU here, once, so no launch of the fit resolves them
        from repro_torch.kernels import autotune
        for b, m, k in spec.lloyd_shapes(n):
            autotune.prewarm("lloyd", b=b, m=m, d=int(data_shape[1]), k=k,
                             device=dev)
    return ExecutionPlan(spec=spec, mode=mode, backend=backend, device=dev,
                         mesh=mesh, data_shape=data_shape,
                         schedule=spec.level_schedule(), logger=run_logger)


def execute(pl: ExecutionPlan, x, seed: "int | torch.Generator" = 0, *,
            return_stats: bool = False):
    """Run a plan on ``x``: an (N, d) array-like (moved to the plan's
    device) or a :class:`DataSource`.  ``single`` and ``shard_map`` fit a
    resident array (an ``ArraySource`` unwraps; another source is
    rejected); ``chunked`` folds a source chunk by chunk
    (:func:`fit_chunked`), ``chunked_dist`` one source shard per mesh
    entry (:func:`~repro_torch.core.distributed.fit_chunked_dist`);
    ``stream`` folds an array as one chunk, a source chunk by chunk, and
    scores a source with one :func:`sse_pass`.
    ``spec.execution.donate`` is accepted and has no effect.

    Returns a :class:`SampledClusteringResult`; with ``return_stats=True``
    ``(result, ChunkStats | ChunkDistStats | None)``, the out-of-core
    accounting of a ``chunked`` or ``chunked_dist`` run."""
    if pl.mode == "chunked":
        res, stats = fit_chunked(as_source(x), pl.spec, seed,
                                 backend=pl.backend, logger=pl.logger,
                                 device=pl.device)
        return (res, stats) if return_stats else res
    if pl.mode == "chunked_dist":
        from repro_torch.core.distributed import fit_chunked_dist
        res, stats = fit_chunked_dist(as_source(x), pl.spec, pl.mesh, seed,
                                      backend=pl.backend, logger=pl.logger)
        return (res, stats) if return_stats else res
    if return_stats:
        return execute(pl, x, seed), None
    if isinstance(x, DataSource) and pl.mode != "stream":
        if not isinstance(x, ArraySource):
            raise ValueError(
                f"execute: mode={pl.mode!r} needs a resident array, but the "
                f"input is a {type(x).__name__} — use mode='chunked' (or "
                f"'auto') for out-of-core sources")
        x = x.array
    if pl.mode == "single":
        return fit_from_spec(x, pl.spec, seed, backend=pl.backend,
                             logger=pl.logger, device=pl.device)
    if pl.mode == "shard_map":
        from repro_torch.core.distributed import (
            make_distributed_sampled_kmeans)
        res = make_distributed_sampled_kmeans(
            pl.mesh, spec=pl.spec, backend=pl.backend,
            logger=pl.logger)(x, seed)
        return SampledClusteringResult(
            centers=res.centers, sse=res.sse, local_centers=res.local_centers,
            local_weights=res.local_weights,
            n_dropped=torch.zeros((), dtype=torch.int64,
                                  device=res.centers.device))
    if pl.mode == "stream":
        from repro_torch.stream.engine import StreamConfig, StreamingClusterer
        sc = StreamingClusterer(StreamConfig.from_spec(pl.spec),
                                backend=pl.backend, logger=pl.logger,
                                device=pl.device)
        if isinstance(x, DataSource):
            state = None
            for chunk in x.chunks(pl.spec.chunk.chunk_points):
                chunk = torch.as_tensor(chunk, device=pl.device)
                if state is None:
                    state = sc.init(dim=chunk.shape[-1], seed=seed,
                                    dtype=chunk.dtype)
                state = sc.update(state, chunk)
            if state is None:
                raise ValueError("execute: the source yielded no chunks")
            total = sse_pass(x, state.centers, pl.spec.chunk.chunk_points,
                             prefetch=pl.spec.chunk.prefetch)
        else:
            x = torch.as_tensor(x, device=pl.device)
            state = sc.init(dim=x.shape[-1], seed=seed, dtype=x.dtype)
            state = sc.update(state, x)
            _, total = sc.query(state, x)
        return SampledClusteringResult(
            centers=state.centers, sse=total, local_centers=state.coreset,
            local_weights=state.coreset_w,
            n_dropped=torch.zeros((), dtype=torch.int64, device=pl.device))
    raise ValueError(f"unknown plan mode {pl.mode!r}")


class SampledKMeans:
    """Estimator-style facade (sklearn-like: ``fit`` populates
    ``centers_``, ``sse_``, ``result_``, and ``chunk_stats_`` for a
    chunked fit; ``partial_fit`` keeps a live stream state).

    Parameters
    ----------
    spec:    the declarative job (or an int — shorthand for
             ``ClusterSpec.make(k)``)
    mesh:    a :class:`repro_torch.launch.mesh.Mesh`; enables and steers
             the ``shard_map`` and ``chunked_dist`` modes
    device:  where everything else runs and the results live; ``None``
             means the first mesh entry, or without a mesh the CUDA
             device, and a missing one raises ``RuntimeError`` (pass
             ``"cpu"`` for the plain PyTorch versions)
    buffer_size, decay: the stream engine's knobs for ``partial_fit`` (and
             ``fit`` under ``mode="stream"``)
    logger:  a :class:`repro_torch.telemetry.RunLogger` or registry name;
             overrides ``spec.execution.telemetry``
    """

    def __init__(self, spec: ClusterSpec | int, *,
                 mesh: Optional[Mesh] = None,
                 device: "torch.device | str | None" = None,
                 buffer_size: int = 1024, decay: float = 0.97,
                 logger: "RunLogger | str | None" = None):
        if isinstance(spec, int):
            spec = ClusterSpec.make(spec)
        self.spec = spec
        self.mesh = mesh
        self.device = _home(device, mesh)
        self.logger = get_run_logger(logger if logger is not None
                                     else spec.execution.telemetry)
        self._stream_overrides = dict(buffer_size=buffer_size, decay=decay)
        self._clusterer = None      # the StreamingClusterer of partial_fit
        self._stream_state = None
        self.result_: Optional[SampledClusteringResult] = None
        self.centers_: Optional[torch.Tensor] = None
        self.sse_: Optional[torch.Tensor] = None
        self.chunk_stats_: Optional[ChunkStats] = None

    # -- planning ---------------------------------------------------------
    def plan(self, data_shape: Optional[tuple] = None, *,
             source: Optional[DataSource] = None) -> ExecutionPlan:
        return plan(self.spec, data_shape, mesh=self.mesh,
                    device=self.device, source=source, logger=self.logger)

    @property
    def backend(self) -> LloydBackend:
        return self.plan().backend

    # -- fit --------------------------------------------------------------
    def fit(self, x, seed: "int | torch.Generator" = 0) -> "SampledKMeans":
        """One-shot fit of ``x`` on the estimator's device (or mesh): an
        (n, d) array-like (any mode) or a :class:`DataSource` (out of core;
        ``auto`` resolves a non-resident source to ``chunked``, or to
        ``chunked_dist`` when the estimator has a mesh).  Always starts
        fresh: a live ``partial_fit`` stream is discarded."""
        if isinstance(x, DataSource):
            src, pl = x, self.plan(x.shape, source=x)
        else:
            x = torch.as_tensor(x, device=self.device)
            src, pl = None, self.plan(tuple(x.shape))
        self._reset_stream()
        self.chunk_stats_ = None
        if pl.mode == "stream":
            # through partial_fit, which honours the stream-only knobs
            if src is None:
                return self.partial_fit(x, seed)
            for chunk in src.chunks(self.spec.chunk.chunk_points):
                self.partial_fit(chunk, seed)
            if self.centers_ is None:
                raise ValueError("fit: the source yielded no chunks")
            # unlike partial_fit, a finished fit reports its quality
            self.sse_ = sse_pass(src, self.centers_,
                                 self.spec.chunk.chunk_points,
                                 prefetch=self.spec.chunk.prefetch)
            return self
        self.result_, self.chunk_stats_ = execute(pl, x, seed,
                                                  return_stats=True)
        self.centers_ = self.result_.centers
        self.sse_ = self.result_.sse
        return self

    def fit_predict(self, x, seed: "int | torch.Generator" = 0
                    ) -> torch.Tensor:
        return self.fit(x, seed).predict(x)

    # -- incremental fit --------------------------------------------------
    def _reset_stream(self):
        self._clusterer = None
        self._stream_state = None

    def partial_fit(self, chunk, seed: "int | torch.Generator" = 0
                    ) -> "SampledKMeans":
        """Fold one (m, d) chunk through the streaming engine
        (:class:`repro_torch.stream.StreamingClusterer`).  The first call
        starts the stream state from ``seed``; later calls ignore it.
        ``sse_`` is left unset (stale) until the next ``fit``."""
        from repro_torch.stream.engine import StreamConfig, StreamingClusterer
        chunk = torch.as_tensor(chunk, device=self.device)
        if self._clusterer is None:
            cfg = StreamConfig.from_spec(self.spec, **self._stream_overrides)
            self._clusterer = StreamingClusterer(cfg, logger=self.logger,
                                                 device=self.device)
            self._stream_state = self._clusterer.init(
                dim=chunk.shape[-1], seed=seed, dtype=chunk.dtype)
        self._stream_state = self._clusterer.update(self._stream_state,
                                                    chunk)
        self.centers_ = self._stream_state.centers
        self.sse_ = None
        return self

    @property
    def stream_state(self):
        return self._stream_state

    # -- inference --------------------------------------------------------
    def _check_fitted(self):
        if self.centers_ is None:
            raise RuntimeError("SampledKMeans: call fit/partial_fit first")

    def predict(self, x, *, block: int | None = PREDICT_BLOCK
                ) -> torch.Tensor:
        """Nearest-center id per point (int32), through the planned
        backend.  The plain version goes ``block`` rows at a time
        (O(block · k) working set); the CUDA kernel never forms the
        (n, k) matrix and takes all rows in one launch.  The labels are
        the same either way.  ``x`` may be a :class:`DataSource`, assigned
        chunk by chunk (only the (n,) labels are ever whole)."""
        self._check_fitted()
        be = self.plan().backend
        if isinstance(x, DataSource):
            from repro_torch.data.source import prefetch_to_device
            parts = [be.assign_points(c, self.centers_, block=block)[0]
                     for c in prefetch_to_device(
                         x.chunks(self.spec.chunk.chunk_points),
                         self.spec.chunk.prefetch, device=self.device)]
            if not parts:
                raise ValueError("predict: the source yielded no chunks")
            return parts[0] if len(parts) == 1 else torch.cat(parts)
        x = torch.as_tensor(x, device=self.device)
        idx, _ = be.assign_points(x, self.centers_, block=block)
        return idx

    def transform(self, x, *, block: int = PREDICT_BLOCK) -> torch.Tensor:
        """(m, k) squared distances to the fitted centers, computed
        ``block`` rows at a time."""
        self._check_fitted()
        x = torch.as_tensor(x, device=self.device)
        return map_row_blocks(
            x, lambda b: pairwise_sqdist(b, self.centers_), block)

    def score(self, x, *, block: int = PREDICT_BLOCK) -> torch.Tensor:
        """Negative SSE of ``x`` under the fitted centers (larger is
        better), ``block`` rows at a time."""
        self._check_fitted()
        x = torch.as_tensor(x, device=self.device)
        return -min_sqdist(x, self.centers_, block=block).sum()

    def __repr__(self):
        fitted = "fitted" if self.centers_ is not None else "unfitted"
        return (f"<SampledKMeans k={self.spec.merge.k} "
                f"mode={self.spec.execution.mode} device={self.device} "
                f"{fitted}>")
