"""Declarative clustering specification — ONE vocabulary for every surface.

The PyTorch port's copy of :mod:`repro.core.spec`: the same frozen
dataclasses, the same JSON form and the same ``stable_hash``, so a spec
written for the JAX package loads here unchanged and keys the same
perf-trajectory series.  Only the backend type differs (a
:class:`repro_torch.core.backend.LloydBackend`).

The paper's method is one algorithm (partition -> local k-means -> merge).
A :class:`ClusterSpec` names each stage once, with composable frozen
dataclasses:

    spec = ClusterSpec(
        partition=PartitionSpec(scheme="equal", n_sub=64),
        local=LocalSpec(compression=5, iters=10, init="kmeans++"),
        merge=MergeSpec(k=1000, iters=25, weighted=False, init="kmeans||"),
        execution=ExecutionSpec(backend="auto", mode="auto"),
    )

Specs are hashable, serializable (``to_dict``/``from_dict`` round-trip
through plain JSON), and *declarative*: names like ``partition.scheme``,
``local.init`` and ``execution.backend`` are resolved against the
partitioner / init / LloydBackend registries only when a plan is built
(:func:`repro_torch.api.plan`), so user-registered entries work everywhere.

``ClusterSpec.make`` accepts the historical flat kwarg vocabulary and is
what the thin ``sampled_kmeans(...)`` adapter builds internally.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

from .backend import BackendSpec, LloydBackend

_MODES = ("auto", "single", "shard_map", "stream", "chunked",
          "chunked_dist")
_MERGE_PATHS = ("replicated", "distributed")
_SSE_POLICIES = ("exact", "pool")

# Out-of-core fold accumulator bound: once this many per-chunk pools are
# pending and the spec has reduce levels, the executor folds them through
# levels[0] into a single bounded pool instead of holding every chunk's
# pool until the final concatenate.  A module constant (not a ChunkSpec
# field) so serialized specs and their stable_hash stay unchanged.
CHUNK_FOLD_BUFFER = 8

_STOP_METRICS = ("rel_sse", "center_shift")


@dataclasses.dataclass(frozen=True)
class StopSpec:
    """Convergence-driven stopping policy for a Lloyd loop.

    Every Lloyd loop in the stack (local stage, reduce levels, merge,
    stream fold/merge, KV recompression, PQ codebooks, gradient
    quantization) accepts one of these instead of a bare trip count:

    * ``max_iters`` — hard iteration ceiling (the old ``iters``).
    * ``tol`` — convergence tolerance.  ``tol=0`` (the default) disables
      the convergence test entirely and runs the fixed-trip path (no
      data-dependent trip count, no stragglers, no host sync).  ``tol>0``
      switches the loop to a data-dependent exit.
    * ``metric`` — what ``tol`` tests: ``"rel_sse"`` stops when the
      relative SSE improvement ``(prev - sse) / prev`` of one Lloyd step
      falls to ``tol`` or below; ``"center_shift"`` stops when the
      largest per-center Euclidean move does.
    * ``min_iters`` — convergence cannot fire before this many
      iterations have run (the ceiling still applies).
    * ``patience`` — the metric must hit the tolerance on this many
      *consecutive* iterations before the loop exits (guards against a
      single flat step on plateaued objectives).
    * ``minibatch`` — ``>0`` switches the loop to mini-batch Lloyd
      (Sculley-style): each iteration samples this many rows
      (weight-proportionally) and applies a running cumulative-count
      learning-rate center update instead of a full pass.  Meant for the
      big merge stage over huge representative pools.

    In the batched local stage (one lane per partition) a ``tol>0`` loop
    is masked per lane: converged partitions freeze (``torch.where`` keeps
    their carry) and the batched loop exits once every lane is done.
    ``minibatch > 0`` is not ported to :mod:`repro_torch` yet (ROADMAP.md).
    """
    max_iters: int = 25
    tol: float = 0.0
    metric: str = "rel_sse"
    min_iters: int = 1
    patience: int = 1
    minibatch: int = 0

    def __post_init__(self):
        if self.max_iters < 0:
            raise ValueError(
                f"StopSpec: max_iters must be >= 0, got {self.max_iters}")
        if self.tol < 0:
            raise ValueError(f"StopSpec: tol must be >= 0, got {self.tol}")
        if self.metric not in _STOP_METRICS:
            raise ValueError(
                f"unknown stop metric {self.metric!r}; known: "
                f"{_STOP_METRICS}")
        if self.min_iters < 0:
            raise ValueError(
                f"StopSpec: min_iters must be >= 0, got {self.min_iters}")
        if self.patience < 1:
            raise ValueError(
                f"StopSpec: patience must be >= 1, got {self.patience}")
        if self.minibatch < 0:
            raise ValueError(
                f"StopSpec: minibatch must be >= 0, got {self.minibatch}")


def _effective_stop(sub) -> "StopSpec":
    """The stopping policy of a sub-spec carrying legacy ``iters`` plus an
    optional ``stop`` override: ``stop`` wins when set, else the static
    fixed-trip policy ``StopSpec(max_iters=iters)`` (bit-for-bit the
    pre-StopSpec behavior)."""
    return sub.stop if sub.stop is not None else StopSpec(
        max_iters=sub.iters)


def _level_out(n: int, lv: "LevelSpec") -> int:
    """Pool rows produced by one reduce level over ``n`` pool rows — the
    exact accounting of :func:`repro_torch.core.pipeline.reduce_pool`."""
    cap = -(-n // lv.n_sub)  # ceil — Algorithm 1's slot count
    if lv.scheme == "unequal":
        cap = min(int(cap * lv.capacity_factor), n)
    return lv.n_sub * max(1, cap // lv.compression)


@dataclasses.dataclass(frozen=True)
class PartitionSpec:
    """How the point set is split into subclusters (paper Algorithms 1/2).

    ``scheme`` resolves against :func:`repro_torch.core.subcluster.get_partitioner`
    (built-ins: ``"equal"``, ``"unequal"``); ``n_sub`` is the partition count
    (per device under shard_map); ``capacity_factor`` bounds Algorithm 2's
    data-dependent partition sizes, MoE-router style.
    """
    scheme: str = "equal"
    n_sub: int = 8
    capacity_factor: float = 2.0


@dataclasses.dataclass(frozen=True)
class LocalSpec:
    """The per-partition ("device part") k-means.

    ``compression`` is the paper's ``c`` (an N-point partition is summarised
    by N//c local centers); ``init`` resolves against
    :func:`repro_torch.core.kmeans.get_init`.  ``iters`` is the legacy fixed trip
    count — a deprecated alias for ``stop.max_iters``; when ``stop`` is set
    it is canonical and ``iters`` is ignored.
    """
    compression: int = 5
    iters: int = 10
    init: str = "kmeans++"
    stop: Optional[StopSpec] = None

    @property
    def effective_stop(self) -> StopSpec:
        return _effective_stop(self)


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    """One extra level of the hierarchical reduce tree.

    Once the pool of weighted local centers is itself "a large dataset"
    (``P_total * k_local`` representatives at pod scale), the paper's own
    argument recurses: re-partition the *pool*, run the weighted local
    stage on it, and hand the merge an ever smaller pool.  A
    :class:`ClusterSpec` holds a tuple of these in ``levels`` — each entry
    shrinks the current pool by roughly ``compression`` before the merge
    stage runs.  ``scheme`` resolves against the partitioner registry and
    ``init`` against the init registry, exactly like the base stage.
    """
    n_sub: int = 8
    compression: int = 4
    iters: int = 8
    init: str = "kmeans++"
    scheme: str = "equal"
    capacity_factor: float = 2.0
    stop: Optional[StopSpec] = None

    @property
    def effective_stop(self) -> StopSpec:
        return _effective_stop(self)


@dataclasses.dataclass(frozen=True)
class ChunkSpec:
    """How the out-of-core executor (``mode="chunked"``) schedules data.

    ``chunk_points`` is the fixed chunk row count the executor feeds the
    jitted per-chunk fold (one ragged tail chunk at most; a
    ``chunk_points >= n_points`` run is a single chunk — the bit-for-bit
    parity case with the single-device pipeline).  ``prefetch`` is the
    host→device double-buffer depth (how many chunks may be resident /
    in flight at once).  ``sse`` picks the final-accuracy policy:
    ``"exact"`` makes one more chunked pass over the data through the
    backend's assignment (the paper's SSE, bounded memory), ``"pool"``
    scores only the weighted representative pool (no extra data pass —
    an upper-bound style estimate).
    """
    chunk_points: int = 65536
    prefetch: int = 2
    sse: str = "exact"

    def __post_init__(self):
        if self.chunk_points < 1:
            raise ValueError(
                f"ChunkSpec: chunk_points must be >= 1, got "
                f"{self.chunk_points}")
        if self.prefetch < 1:
            raise ValueError(
                f"ChunkSpec: prefetch must be >= 1, got {self.prefetch}")
        if self.sse not in _SSE_POLICIES:
            raise ValueError(
                f"unknown chunk sse policy {self.sse!r}; known: "
                f"{_SSE_POLICIES}")


@dataclasses.dataclass(frozen=True)
class MergeSpec:
    """The merge ("host part") k-means over the sampled representatives.

    ``k`` is the global cluster count; ``weighted=True`` weights each local
    center by its member count (beyond-paper refinement); ``restarts`` is
    the multi-seed lowest-SSE guard.  ``iters`` is the legacy fixed trip
    count — a deprecated alias for ``stop.max_iters``; ``stop`` (including
    the mini-batch option) is canonical when set.
    """
    k: int
    iters: int = 25
    weighted: bool = False
    restarts: int = 4
    init: str = "kmeans++"
    stop: Optional[StopSpec] = None

    @property
    def effective_stop(self) -> StopSpec:
        return _effective_stop(self)


@dataclasses.dataclass(frozen=True)
class ExecutionSpec:
    """Where and how the plan runs.

    ``backend`` names a :class:`repro_torch.core.backend.LloydBackend`
    (``"auto"`` consults ``REPRO_KMEANS_BACKEND``, then picks
    ``cuda_fused`` for CUDA tensors and ``torch`` for CPU tensors).
    ``mode`` picks the engine; the port runs ``"single"`` (and ``"auto"``,
    which resolves to it for a resident array).  ``"shard_map"``,
    ``"stream"``, ``"chunked"`` and ``"chunked_dist"`` are valid names that
    the port's planner rejects until their slices land (ROADMAP.md §1).
    ``mesh_axis`` and ``merge_path`` belong to those modes.  ``donate`` is
    accepted and has no effect in the port.  ``telemetry`` names a
    :func:`repro_torch.telemetry.get_run_logger` entry (``"off"``,
    ``"memory"``, ``"jsonl[:path]"``, or user-registered), resolved at plan
    time like ``backend``.
    """
    backend: BackendSpec = "auto"
    mode: str = "auto"
    mesh_axis: str = "data"
    donate: bool = False
    merge_path: str = "replicated"
    telemetry: str = "off"

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(
                f"unknown execution mode {self.mode!r}; known: {_MODES}")
        if self.merge_path not in _MERGE_PATHS:
            raise ValueError(
                f"unknown merge path {self.merge_path!r}; known: "
                f"{_MERGE_PATHS}")


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """The full declarative job: partition -> local [-> levels...] -> merge
    + execution.

    ``scale=True`` applies the paper's min-max feature scaling around the
    whole pipeline (centers are mapped back to input space).  ``levels``
    holds the *extra* reduce-tree stages (:class:`LevelSpec`) run on the
    weighted center pool between the base local stage and the merge; the
    default ``()`` is today's two-level pipeline, bit-for-bit ("levels=1"
    in reduce-tree counting — :meth:`n_levels` is ``1 + len(levels)``).
    """
    merge: MergeSpec
    partition: PartitionSpec = PartitionSpec()
    local: LocalSpec = LocalSpec()
    execution: ExecutionSpec = ExecutionSpec()
    scale: bool = True
    levels: tuple = ()          # tuple[LevelSpec, ...] — extra reduce levels
    chunk: ChunkSpec = ChunkSpec()  # out-of-core schedule (mode="chunked")

    def __post_init__(self):
        # keep the spec hashable when levels arrives as a list
        object.__setattr__(self, "levels", tuple(self.levels))

    # -- flat-kwargs bridge (the legacy vocabulary) -----------------------
    @classmethod
    def make(cls, k: int, *, scheme: str = "equal", n_sub: int = 8,
             compression: int = 5, local_iters: int = 10,
             global_iters: int = 25, init: str = "kmeans++",
             merge_init: Optional[str] = None, weighted_merge: bool = False,
             capacity_factor: float = 2.0, scale: bool = True,
             backend: BackendSpec = None, restarts: int = 4,
             mode: str = "auto", mesh_axis: str = "data",
             donate: bool = False,
             levels: "int | tuple" = (),
             chunk_points: Optional[int] = None,
             tol: float = 0.0,
             minibatch: int = 0) -> "ClusterSpec":
        """Build a spec from the historical flat kwarg vocabulary (what
        ``sampled_kmeans`` took before specs existed).  ``init`` seeds both
        stages unless ``merge_init`` overrides the merge stage.  ``levels``
        takes a tuple of :class:`LevelSpec` or an int total level count
        (``levels=n`` appends ``n - 1`` default reduce levels).
        ``chunk_points`` sizes the out-of-core chunk schedule (other
        :class:`ChunkSpec` knobs keep their defaults).  ``tol`` > 0 turns
        on convergence-driven early exit (``StopSpec`` with the stage's
        iteration budget as ``max_iters``) for the local and merge stages;
        ``minibatch`` > 0 additionally makes the merge stage mini-batch.
        The default ``tol=0, minibatch=0`` attaches no StopSpec at all —
        serialization and ``stable_hash`` are unchanged from before
        StopSpec existed."""
        if isinstance(levels, int):
            if levels < 1:
                raise ValueError(f"levels={levels}: the reduce tree has at "
                                 f"least the base local stage (levels >= 1)")
            levels = tuple(LevelSpec() for _ in range(levels - 1))
        local_stop = (StopSpec(max_iters=local_iters, tol=tol)
                      if tol > 0 else None)
        merge_stop = (StopSpec(max_iters=global_iters, tol=tol,
                               minibatch=minibatch)
                      if tol > 0 or minibatch > 0 else None)
        return cls(
            chunk=(ChunkSpec(chunk_points=chunk_points)
                   if chunk_points is not None else ChunkSpec()),
            partition=PartitionSpec(scheme=scheme, n_sub=n_sub,
                                    capacity_factor=capacity_factor),
            local=LocalSpec(compression=compression, iters=local_iters,
                            init=init, stop=local_stop),
            merge=MergeSpec(k=k, iters=global_iters, weighted=weighted_merge,
                            restarts=restarts, init=merge_init or init,
                            stop=merge_stop),
            execution=ExecutionSpec(backend=backend if backend is not None
                                    else "auto", mode=mode,
                                    mesh_axis=mesh_axis, donate=donate),
            scale=scale,
            levels=levels,
        )

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> dict:
        """Nested plain-python dict, JSON-serializable.  A backend given as
        an instance is recorded by its registry name."""
        d = dataclasses.asdict(self)
        be = self.execution.backend
        if isinstance(be, LloydBackend):
            d["execution"]["backend"] = be.name
        d["levels"] = [dict(lv) for lv in d["levels"]]  # JSON-friendly list
        # an unset stopping policy is omitted entirely, so specs that never
        # mention StopSpec serialize (and stable_hash) exactly as before it
        # existed — committed benchmark baselines keyed by spec_hash survive
        for sub in [d["local"], d["merge"], *d["levels"]]:
            if sub.get("stop") is None:
                sub.pop("stop", None)
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ClusterSpec":
        """Inverse of :meth:`to_dict`; unknown keys raise (catch config
        typos instead of silently ignoring them)."""
        d = dict(d)

        def parse_stop(sub: dict, where: str) -> dict:
            """Inflate a serialized ``stop`` entry back into a StopSpec
            (``None`` passes through; unknown stop keys raise)."""
            stop = sub.get("stop")
            if stop is None or isinstance(stop, StopSpec):
                return sub
            stop = dict(stop)
            known = {f.name for f in dataclasses.fields(StopSpec)}
            unknown = set(stop) - known
            if unknown:
                raise ValueError(
                    f"ClusterSpec.from_dict: unknown {where}.stop keys "
                    f"{sorted(unknown)}; known: {sorted(known)}")
            return dict(sub, stop=StopSpec(**stop))

        parts = {
            "merge": (MergeSpec, d.pop("merge")),
            "partition": (PartitionSpec, d.pop("partition", {})),
            "local": (LocalSpec, d.pop("local", {})),
            "execution": (ExecutionSpec, d.pop("execution", {})),
            "chunk": (ChunkSpec, d.pop("chunk", {})),
        }
        kwargs = {}
        for field, (klass, sub) in parts.items():
            sub = dict(sub)
            known = {f.name for f in dataclasses.fields(klass)}
            unknown = set(sub) - known
            if unknown:
                raise ValueError(
                    f"ClusterSpec.from_dict: unknown {field} keys "
                    f"{sorted(unknown)}; known: {sorted(known)}")
            if field in ("merge", "local"):
                sub = parse_stop(sub, field)
            kwargs[field] = klass(**sub)
        known_lv = {f.name for f in dataclasses.fields(LevelSpec)}
        levels = []
        for i, lv in enumerate(d.pop("levels", ())):
            lv = dict(lv)
            unknown = set(lv) - known_lv
            if unknown:
                raise ValueError(
                    f"ClusterSpec.from_dict: unknown levels[{i}] keys "
                    f"{sorted(unknown)}; known: {sorted(known_lv)}")
            levels.append(LevelSpec(**parse_stop(lv, f"levels[{i}]")))
        scale = d.pop("scale", True)
        if d:
            raise ValueError(
                f"ClusterSpec.from_dict: unknown top-level keys {sorted(d)}")
        return cls(scale=scale, levels=tuple(levels), **kwargs)

    def stable_hash(self) -> str:
        """Short content hash of the *algorithmic* sections (partition,
        local, levels, merge, chunk, scale) — the execution section
        (mode/backend/telemetry/...) is excluded because it changes *where*
        the job runs, not *what* it computes.  This is the first component
        of the perf-trajectory key ``(spec_hash, mode, backend)``
        (``benchmarks/trajectory.py``): same algorithm on two engines lands
        on two series that share a hash."""
        import hashlib
        import json as _json
        d = self.to_dict()
        d.pop("execution", None)
        blob = _json.dumps(d, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:12]

    # -- convenience ------------------------------------------------------
    @property
    def k(self) -> int:
        return self.merge.k

    @property
    def n_levels(self) -> int:
        """Reduce-tree depth: the base local stage plus the extra levels."""
        return 1 + len(self.levels)

    def level_schedule(self) -> tuple:
        """The full reduce schedule, base stage first: the partition/local
        sections expressed as a :class:`LevelSpec` followed by the extra
        ``levels``.  This is what the planner resolves once and every
        executor (single, shard_map, stream) walks."""
        base = LevelSpec(n_sub=self.partition.n_sub,
                         compression=self.local.compression,
                         iters=self.local.iters, init=self.local.init,
                         scheme=self.partition.scheme,
                         capacity_factor=self.partition.capacity_factor,
                         stop=self.local.stop)
        return (base,) + self.levels

    def pool_schedule(self, n_points: int) -> tuple:
        """Representative-pool size after each level of the reduce tree for
        an ``n_points`` input (single-device accounting; under shard_map
        ``n_points`` is the per-device shard and each level shrinks every
        device's pool independently).  ``pool_schedule(n)[-1]`` is what the
        merge stage sees."""
        sizes, n = [], n_points
        for lv in self.level_schedule():
            cap = -(-n // lv.n_sub)  # ceil — Algorithm 1's slot count
            if lv.scheme == "unequal":
                # Algorithm 2 bounds partitions at ceil(M/P)*capacity_factor
                cap = min(int(cap * lv.capacity_factor), n)
            n = lv.n_sub * max(1, cap // lv.compression)
            sizes.append(n)
        return tuple(sizes)

    def chunked_pool_schedule(self, n_points: int) -> tuple:
        """Pool accounting for the out-of-core executor: every chunk of
        ``chunk.chunk_points`` rows contributes its own base-stage pool
        (the executor clamps ``n_sub`` to the chunk size, so a ragged tail
        never creates empty mandatory partitions), chunk pools accumulate
        — folded through ``levels[0]`` every :data:`CHUNK_FOLD_BUFFER`
        pending chunks when the spec has reduce levels, so the host peak
        stays O(level pool) — and the extra ``levels`` then shrink the
        final accumulated pool exactly as in :meth:`pool_schedule`.
        ``chunked_pool_schedule(n)[0]`` is the accumulated pool entering
        the level chain and ``[-1]`` is what the merge stage sees — the
        planner rejects chunked plans where it falls below ``merge.k``.
        This simulates the JAX package's ``fit_chunked`` bounded
        accumulator row-exactly (``ChunkStats.pool_size`` is pinned to
        ``[-1]`` by the regression tests)."""
        base = self.level_schedule()[0]

        def chunk_pool(m: int) -> int:
            n_sub = max(1, min(base.n_sub, m))
            cap = -(-m // n_sub)
            if base.scheme == "unequal":
                cap = min(int(cap * base.capacity_factor), m)
            return n_sub * max(1, cap // base.compression)

        n_full, tail = divmod(int(n_points), self.chunk.chunk_points)
        chunk_pools = [chunk_pool(self.chunk.chunk_points)] * n_full
        if tail:
            chunk_pools.append(chunk_pool(tail))

        acc, pending_rows, pending = 0, 0, 0
        for rows in chunk_pools:
            pending_rows += rows
            pending += 1
            if self.levels and pending >= CHUNK_FOLD_BUFFER:
                acc = _level_out(acc + pending_rows, self.levels[0])
                pending_rows = pending = 0
        sizes = [acc + pending_rows]
        for lv in self.levels:
            sizes.append(_level_out(sizes[-1], lv))
        return tuple(sizes)

    def chunked_dist_pool_schedule(self, n_points: int,
                                   n_devices: int) -> tuple:
        """Pool accounting for the sharded out-of-core executor
        (``mode="chunked_dist"``): each of the ``n_devices`` shards runs
        the full per-device :meth:`chunked_pool_schedule` over roughly
        ``n_points // n_devices`` rows, then the final per-device pools
        concatenate for the merge.  Returns the per-shard schedule with
        the global concatenated pool appended — ``[-1]`` is what the merge
        stage sees; the planner rejects plans where it falls below
        ``merge.k``.  (Shard row counts differ by at most one chunk; the
        floor-division estimate is the conservative per-shard floor.)"""
        if n_devices < 1:
            raise ValueError(
                f"chunked_dist_pool_schedule: n_devices must be >= 1, got "
                f"{n_devices}")
        per = self.chunked_pool_schedule(int(n_points) // n_devices)
        return per + (per[-1] * n_devices,)

    def replace(self, **kwargs) -> "ClusterSpec":
        """``dataclasses.replace`` that also reaches one level down:
        ``spec.replace(mode="stream", n_sub=16)`` touches the right
        sub-spec by field name.  Names that exist in more than one
        sub-spec (``iters``, ``init``, ``stop``) are ambiguous and raise
        — pass the
        sub-spec explicitly (``spec.replace(merge=...)``)."""
        top = {f.name for f in dataclasses.fields(ClusterSpec)}
        updates: dict[str, Any] = {}
        for name, value in kwargs.items():
            if name in top:
                updates[name] = value
                continue
            owners = [s for s in ("partition", "local", "merge", "execution",
                                  "chunk")
                      if name in {f.name for f in dataclasses.fields(
                          type(getattr(self, s)))}]
            if not owners:
                raise TypeError(f"ClusterSpec.replace: unknown field "
                                f"{name!r}")
            if len(owners) > 1:
                raise TypeError(
                    f"ClusterSpec.replace: {name!r} is ambiguous (lives in "
                    f"{' and '.join(owners)}); replace the sub-spec "
                    f"explicitly, e.g. spec.replace({owners[-1]}="
                    f"dataclasses.replace(spec.{owners[-1]}, {name}=...))")
            sub_name = owners[0]
            sub = updates.get(sub_name, getattr(self, sub_name))
            updates[sub_name] = dataclasses.replace(sub, **{name: value})
        return dataclasses.replace(self, **updates)
