"""`SampledKMeans` — the estimator facade over the paper's pipeline, with a
plan/execute split; the port's counterpart of :mod:`repro.api`.

    from repro_torch.api import SampledKMeans
    from repro_torch.core import ClusterSpec, MergeSpec, PartitionSpec

    spec = ClusterSpec(merge=MergeSpec(k=40),
                       partition=PartitionSpec(scheme="equal", n_sub=16))
    est = SampledKMeans(spec).fit(x)     # on the CUDA device
    labels = est.predict(x)

:func:`plan` resolves a spec ONCE (execution mode, Lloyd backend, registry
lookups) into an :class:`ExecutionPlan`; :func:`execute` runs it.  The port
runs ``mode="single"`` (and ``"auto"``, which resolves to it for a
resident array).  ``shard_map``, ``stream``, ``chunked`` and
``chunked_dist`` raise ``NotImplementedError`` until their slices land
(ROADMAP.md §1), as does ``partial_fit``.  ``fit`` under ``single`` is
``sampled_kmeans(x, spec=spec)`` bit for bit under the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.backend import LloydBackend, get_backend
from repro_torch.core.device import resolve_device
from repro_torch.core.kmeans import get_init, pairwise_sqdist
from repro_torch.core.metrics import map_row_blocks, min_sqdist
from repro_torch.core.pipeline import SampledClusteringResult, fit_from_spec
from repro_torch.core.spec import ClusterSpec
from repro_torch.core.subcluster import get_partitioner
from repro_torch.telemetry import NULL, RunLogger, get_run_logger

# default row-block of the predict-side surfaces (transform/score): the
# working set stays O(block · k) however large the query set is
PREDICT_BLOCK = 16384

_UNPORTED_MODES = ("shard_map", "stream", "chunked", "chunked_dist")


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """A resolved spec: concrete mode, device, one backend instance,
    validated registry entries.  ``schedule`` is the reduce-tree level
    schedule (base stage + ``spec.levels``).  Build with :func:`plan`, run
    with :func:`execute`."""
    spec: ClusterSpec
    mode: str                      # "single"
    backend: LloydBackend          # resolved once, shared by every stage
    device: torch.device
    data_shape: Optional[tuple] = None
    schedule: tuple = ()           # tuple[LevelSpec, ...], base level first
    logger: RunLogger = NULL       # resolved spec.execution.telemetry

    @property
    def k(self) -> int:
        return self.spec.merge.k

    @property
    def n_levels(self) -> int:
        return len(self.schedule)


def plan(spec: ClusterSpec, data_shape: Optional[tuple] = None, *,
         device: "torch.device | str | None" = None,
         logger: "RunLogger | str | None" = None) -> ExecutionPlan:
    """Resolve a declarative spec into an executable plan on ``device``
    (``None``: the CUDA device; a missing one raises).

    Validates every registry name (partitioner, init schemes, backend) up
    front and picks the execution mode: ``"auto"`` is ``"single"`` for the
    port's resident tensors; the unported modes raise.  ``data_shape``
    lets the planner reject schedules whose final pool is below ``k``."""
    get_partitioner(spec.partition.scheme)
    get_init(spec.local.init)
    get_init(spec.merge.init)
    for lvl in spec.levels:
        get_partitioner(lvl.scheme)
        get_init(lvl.init)
    dev = resolve_device(device)
    backend = get_backend(spec.execution.backend, device=dev)
    run_logger = get_run_logger(logger if logger is not None
                                else spec.execution.telemetry)
    mode = spec.execution.mode
    if mode == "auto":
        mode = "single"
    if mode in _UNPORTED_MODES:
        raise NotImplementedError(
            f"repro_torch: execution mode {mode!r} is not ported yet; the "
            f"port runs mode='single' (see ROADMAP.md §1 for the queue)")
    if (data_shape is not None and len(data_shape) >= 1
            and spec.pool_schedule(int(data_shape[0]))[-1] < spec.merge.k):
        raise ValueError(
            f"plan: the reduce tree leaves only "
            f"{spec.pool_schedule(int(data_shape[0]))[-1]} representatives "
            f"for a k={spec.merge.k} merge — drop a level or lower its "
            f"compression (pool schedule: "
            f"{spec.pool_schedule(int(data_shape[0]))})")
    return ExecutionPlan(spec=spec, mode=mode, backend=backend, device=dev,
                         data_shape=data_shape,
                         schedule=spec.level_schedule(), logger=run_logger)


def execute(pl: ExecutionPlan, x,
            seed: "int | torch.Generator" = 0) -> SampledClusteringResult:
    """Run a plan on ``x``, an (N, d) array-like (moved to the plan's
    device).  ``spec.execution.donate`` is accepted and has no effect."""
    return fit_from_spec(x, pl.spec, seed, backend=pl.backend,
                         logger=pl.logger, device=pl.device)


class SampledKMeans:
    """Estimator-style facade (sklearn-like: ``fit`` populates
    ``centers_``, ``sse_``, ``result_``).

    Parameters
    ----------
    spec:    the declarative job (or an int — shorthand for
             ``ClusterSpec.make(k)``)
    device:  where everything runs; ``None`` means the CUDA device, and a
             missing one raises ``RuntimeError`` (pass ``"cpu"`` for the
             plain PyTorch versions)
    logger:  a :class:`repro_torch.telemetry.RunLogger` or registry name;
             overrides ``spec.execution.telemetry``
    """

    def __init__(self, spec: ClusterSpec | int, *,
                 device: "torch.device | str | None" = None,
                 logger: "RunLogger | str | None" = None):
        if isinstance(spec, int):
            spec = ClusterSpec.make(spec)
        self.spec = spec
        self.device = resolve_device(device)
        self.logger = get_run_logger(logger if logger is not None
                                     else spec.execution.telemetry)
        self.result_: Optional[SampledClusteringResult] = None
        self.centers_: Optional[torch.Tensor] = None
        self.sse_: Optional[torch.Tensor] = None

    # -- planning ---------------------------------------------------------
    def plan(self, data_shape: Optional[tuple] = None) -> ExecutionPlan:
        return plan(self.spec, data_shape, device=self.device,
                    logger=self.logger)

    @property
    def backend(self) -> LloydBackend:
        return self.plan().backend

    # -- fit --------------------------------------------------------------
    def fit(self, x, seed: "int | torch.Generator" = 0) -> "SampledKMeans":
        """One-shot fit of an (n, d) array-like on the estimator's
        device."""
        x = torch.as_tensor(x, device=self.device)
        self.result_ = execute(self.plan(tuple(x.shape)), x, seed)
        self.centers_ = self.result_.centers
        self.sse_ = self.result_.sse
        return self

    def fit_predict(self, x, seed: "int | torch.Generator" = 0
                    ) -> torch.Tensor:
        return self.fit(x, seed).predict(x)

    def partial_fit(self, chunk, seed: "int | torch.Generator" = 0):
        raise NotImplementedError(
            "repro_torch: partial_fit needs the streaming engine, which is "
            "not ported yet (see ROADMAP.md §1)")

    # -- inference --------------------------------------------------------
    def _check_fitted(self):
        if self.centers_ is None:
            raise RuntimeError("SampledKMeans: call fit first")

    def predict(self, x, *, block: int | None = PREDICT_BLOCK
                ) -> torch.Tensor:
        """Nearest-center id per point (int32), through the planned
        backend.  The plain version goes ``block`` rows at a time
        (O(block · k) working set); the CUDA kernel never forms the
        (n, k) matrix and takes all rows in one launch.  The labels are
        the same either way."""
        self._check_fitted()
        x = torch.as_tensor(x, device=self.device)
        idx, _ = self.plan().backend.assign_points(x, self.centers_,
                                                   block=block)
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
