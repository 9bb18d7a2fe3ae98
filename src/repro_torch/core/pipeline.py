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
                   its restarts batched as lanes.

:func:`fit_from_spec` composes them over one resident tensor;
``sampled_kmeans`` / ``standard_kmeans`` are the thin adapters.  The
out-of-core and distributed executors are not ported yet (ROADMAP.md §1).
"""
from __future__ import annotations

import time
import warnings
from typing import NamedTuple, Optional

import torch

from .backend import BackendSpec, get_backend
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
