"""Multi-device sampled clustering: the port's counterpart of
:mod:`repro.core.distributed`.

The JAX package runs one ``shard_map`` program over a JAX mesh.  The port
runs one controller over a :class:`~repro_torch.launch.mesh.Mesh` of
``torch.device``s: shard ``s`` (the ``s``-th mesh entry along the data
axis) queues its work on its own device, and the collectives are explicit
and run in a fixed order:

  ``all_gather(tiled=True)``  a concatenation in mesh order
                              (:func:`mesh_concat`);
  ``psum``                    a sum in mesh order, ``(s0 + s1) + s2 ...``
                              (:func:`mesh_sum`);
  ``pmin`` / ``pmax``         elementwise min / max (exact in any order).

So repeated fits are bit-identical, as everywhere in the port.  A
replicated stage (the merge, the greedy init, the merge's center updates)
runs once, on the first mesh device, and its result is copied once to each
distinct device that needs it (:func:`replicate`).  No shard's work waits
on the host, so on a mesh of distinct cards the devices overlap while the
host queues the next shard; a mesh that names one card several times runs
its shards one after another there, with the same results.

The paper's decomposition is the reference's: each shard partitions and
clusters its own rows (the local stage, then the collective-free reduce
levels of ``spec.levels``), and the merge either gathers every shard's
local centers and runs the merge k-means once (``merge_path="replicated"``,
the paper's host merge) or leaves them on their shards and exchanges only
the k centers' statistics each Lloyd round (``"distributed"``).

Random streams (the reference folds the device index into its key):
shard 0 draws what the one-device path draws from the fit's local stream,
so a one-shard run is that path bit for bit; shard ``s > 0`` draws from
child ``_SHARD_KEY_OFFSET + s`` of the local stream (:func:`shard_seed`).
The merge draws from the fit's global stream, the same on every shard.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch

from .backend import BackendSpec, LloydBackend, get_backend
from .device import derive_seed, make_generator, seed_of
from .kmeans import _centers_from_stats, _stop_update, kmeans_batched
from .metrics import sse as sse_fn
from .pipeline import (_GLOBAL, _LOCAL, _SHARD_KEY_OFFSET, SSE_BLOCK,
                       SampledClusteringResult, ShardFold, _log_stage_iters,
                       local_stage, merge_pool, minmax_pass, reduce_pool,
                       sse_pass)
from .spec import ClusterSpec, StopSpec
from .subcluster import gather_partitions, get_partitioner, unscale

_now = time.perf_counter


# ---------------------------------------------------------------------------
# The collectives, in mesh order
# ---------------------------------------------------------------------------

def on_device(dev: torch.device):
    """Queue the enclosed work on ``dev``: its CUDA context, or nothing to
    do for the CPU."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def replicate(t: torch.Tensor, devices) -> list:
    """``t`` on each of ``devices`` (aligned with them), copied once per
    distinct device: entries that repeat a device share one copy, and the
    device ``t`` is on gets ``t`` itself."""
    copies: dict = {}
    out = []
    for dev in devices:
        if dev not in copies:
            copies[dev] = t.to(dev)
        out.append(copies[dev])
    return out


def mesh_concat(parts, device: torch.device) -> torch.Tensor:
    """``all_gather(tiled=True)``: the shards' parts concatenated in mesh
    order on ``device``."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts])


def mesh_sum(parts, device: torch.device) -> torch.Tensor:
    """``psum``: the shards' parts added in mesh order on ``device``."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


class DistributedClusteringResult(NamedTuple):
    centers: torch.Tensor        # (k, d) in the *input* space
    local_centers: torch.Tensor  # (pool, d) the gathered representatives
    #                              the merge saw, input space (the last
    #                              reduce level's pool with levels)
    local_weights: torch.Tensor  # (pool,) their merge weights
    sse: torch.Tensor            # () global SSE, input space


def shard_seed(seed_local: int, shard: int) -> int:
    """The local stream of ``shard``: the fit's own for shard 0, child
    ``_SHARD_KEY_OFFSET + shard`` for the others (apart from the level and
    chunk children the one-device paths draw from it)."""
    return (seed_local if shard == 0
            else derive_seed(seed_local, _SHARD_KEY_OFFSET + shard))


def _global_feature_scale(blocks, devices, eps: float = 1e-9):
    """Feature scaling on the global min/max of every shard's rows (the
    reference's ``pmin``/``pmax``): the scaled blocks, each on its device,
    and ``(lo, span)`` on the first device."""
    dev0 = devices[0]
    lo = blocks[0].amin(0).to(dev0)
    hi = blocks[0].amax(0).to(dev0)
    for b in blocks[1:]:
        lo = torch.minimum(lo, b.amin(0).to(dev0))
        hi = torch.maximum(hi, b.amax(0).to(dev0))
    span = (hi - lo).clamp_min(eps)
    los, spans = replicate(lo, devices), replicate(span, devices)
    return ([(b - l) / s for b, l, s in zip(blocks, los, spans)],
            (lo, span))


def _stride_ids(n_local: int, n_cand: int) -> np.ndarray:
    """``round(linspace(0, n_local - 1, n_cand))`` in the reference's f32
    arithmetic (``start * (1 - t) + stop * t``, the end point exact,
    ties to even)."""
    if n_cand == 1:
        return np.zeros(1, np.int64)
    div = n_cand - 1
    t = np.arange(div, dtype=np.float32) / np.float32(div)
    pos = np.float32(n_local - 1) * t
    pos = np.concatenate([pos, np.float32([n_local - 1])])
    return np.round(pos).astype(np.int64)


def _distributed_merge(local_centers, local_w, k: int, stop: StopSpec,
                       seed: int, backend: LloydBackend, devices
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge-stage k-means with the *points* (the shards' local centers)
    left on their shards.

    The init is replicated: a candidate pool strided across each shard's
    centers (so it spans every partition) is gathered, and greedy
    farthest-point selection starts from the heaviest candidate.  When
    fewer than k live candidates add spread, a surplus pick is jittered by
    0.05 of the candidates' per-dimension spread (the draws are one
    ``(k, d)`` normal block from ``seed``, so no pick waits on the host).

    Each Lloyd round runs one ``backend.step`` per shard over its own
    centers and sums the (k·d + k + 1) statistics in mesh order; the
    center update is the single-device one.  ``tol = 0`` runs exactly
    ``max_iters`` rounds; ``tol > 0`` stops on the summed SSE, so every
    shard takes the same rounds (one host read per round decides the
    exit).  Returns ``(centers (k, d), n_iter)`` on the first device."""
    dev0 = devices[0]
    n_local = local_centers[0].shape[0]
    n_cand = min(n_local, max(2 * k, 8))
    ids = torch.from_numpy(_stride_ids(n_local, n_cand))
    cand = mesh_concat([c[ids.to(c.device)] for c in local_centers], dev0)
    cand_w = mesh_concat([w[ids.to(w.device)] for w in local_w], dev0)
    first = torch.argmax(cand_w)
    picks = [cand[first]]
    min_d = ((cand - cand[first]) ** 2).sum(-1)
    sigma = (0.05 * cand.float().std(0, correction=0) + 1e-6).to(cand.dtype)
    noise = sigma * torch.randn((k, cand.shape[-1]),
                                generator=make_generator(seed, dev0),
                                device=dev0, dtype=cand.dtype)
    live = cand_w > 0
    for i in range(1, k):
        score = torch.where(live, min_d, -1.0)
        nxt = torch.argmax(score)
        c = cand[nxt]
        c = torch.where(score[nxt] <= 0.0, c + noise[i], c)
        picks.append(c)
        min_d = torch.minimum(min_d, ((cand - c) ** 2).sum(-1))
    centers = torch.stack(picks)[None]                  # (1, k, d)

    preps = [backend.prepare(c[None], w[None])
             for c, w in zip(local_centers, local_w)]

    def round_stats(centers):
        stats = []
        for p, c, dev in zip(preps, replicate(centers, devices), devices):
            with on_device(dev):
                stats.append(backend.step(p, c))
        return ([s.sums for s in stats], [s.counts for s in stats],
                [s.sse for s in stats])

    if stop.tol <= 0:
        for _ in range(stop.max_iters):
            sums, counts, _ = round_stats(centers)
            centers = _centers_from_stats(mesh_sum(sums, dev0),
                                          mesh_sum(counts, dev0), centers)
        return centers[0], torch.tensor(stop.max_iters, dtype=torch.int32,
                                        device=dev0)

    i = torch.zeros(1, dtype=torch.int32, device=dev0)
    prev_sse = torch.full((1,), torch.inf, device=dev0)
    streak = torch.zeros(1, dtype=torch.int32, device=dev0)
    for _ in range(stop.max_iters):
        sums, counts, sses = round_stats(centers)
        sse = mesh_sum([s.float() for s in sses], dev0)
        new = _centers_from_stats(mesh_sum(sums, dev0),
                                  mesh_sum(counts, dev0), centers)
        streak, done = _stop_update(stop, sse=sse, prev_sse=prev_sse,
                                    new_centers=new, old_centers=centers,
                                    i=i, streak=streak)
        centers, prev_sse, i = new, sse, i + 1
        if bool(done.all()):
            break
    return centers[0], i[0]


def shard_rows(x: torch.Tensor, n_shards: int, what: str) -> list:
    """Contiguous row blocks in mesh order (``PartitionSpec(axis)``)."""
    m = int(x.shape[0])
    if m % n_shards:
        raise ValueError(f"{what}: {m} rows do not divide over "
                         f"{n_shards} shards")
    per = m // n_shards
    return [x[s * per:(s + 1) * per] for s in range(n_shards)]


def _sync(devices) -> None:
    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def make_distributed_sampled_kmeans(
    mesh,
    *,
    spec: ClusterSpec,
    merge: str = None,
    backend: BackendSpec = None,
    logger=None,
):
    """Build ``fn(x, seed=0) -> DistributedClusteringResult``: the paper's
    pipeline over the shards of ``mesh`` along ``spec.execution.mesh_axis``.
    ``x`` is an (M, d) array-like whose rows split into equal contiguous
    blocks in mesh order (M must divide); each block moves to its shard's
    device.  Centers, representatives and SSE come back in the input
    space, on the first shard's device, as
    :func:`~repro_torch.core.pipeline.fit_from_spec` gives them; a
    one-shard fit's centers, local centers and SSE are ``fit_from_spec``'s
    bit for bit (its ``local_weights`` are the merge's weights, 0/1 for an
    unweighted merge, as the reference returns them).

    Every stage option comes from ``spec`` (``spec.partition.n_sub``
    counts partitions *per shard*; ``spec.execution.merge_path`` is the
    merge strategy, which ``merge=`` overrides; ``spec.levels`` are the
    per-shard reduce levels).  The reference's flat keyword spelling
    (``k``, ``n_sub_per_device``, ...) is not ported: build a
    :class:`~repro_torch.core.spec.ClusterSpec`."""
    from repro_torch.launch.mesh import check_mesh
    check_mesh(mesh)
    k = spec.merge.k
    n_sub_per_device = spec.partition.n_sub
    capacity_factor = spec.partition.capacity_factor
    compression = spec.local.compression
    local_stop = spec.local.effective_stop
    global_stop = spec.merge.effective_stop
    weighted_merge = spec.merge.weighted
    backend = backend if backend is not None else spec.execution.backend
    init = spec.local.init
    merge_init = spec.merge.init
    restarts = spec.merge.restarts
    axis = spec.execution.mesh_axis
    merge = merge or spec.execution.merge_path
    if merge not in ("replicated", "distributed"):
        raise ValueError(f"unknown merge {merge!r}")
    levels = tuple(spec.levels)
    if any(lvl.scheme == "unequal" for lvl in levels):
        # the result has no n_dropped channel for a level's capacity clamp
        warnings.warn(
            "make_distributed_sampled_kmeans: unequal-scheme reduce levels "
            "can clamp overflow pool entries, and the distributed result "
            "has no n_dropped channel to report that mass — prefer "
            "equal-scheme levels (or raise capacity_factor)", stacklevel=2)
    devices = mesh.axis_devices(axis)
    dev0 = devices[0]
    be = get_backend(backend, device=dev0)
    partitioner = get_partitioner(spec.partition.scheme)

    def fit(x, seed: "int | torch.Generator" = 0
            ) -> DistributedClusteringResult:
        x = torch.as_tensor(x)
        raw = [b.to(dev) for b, dev in
               zip(shard_rows(x, len(devices), "shard_map fit"), devices)]
        base = seed_of(seed)
        seed_local = derive_seed(base, _LOCAL)
        scaled, params = _global_feature_scale(raw, devices)
        d = x.shape[-1]
        pools, merge_ws = [], []
        for s, (xs, dev) in enumerate(zip(scaled, devices)):
            with on_device(dev):
                seed_dev = shard_seed(seed_local, s)
                part = partitioner(xs, n_sub_per_device, capacity_factor)
                parts, part_w = gather_partitions(xs, part)
                k_local = max(1, parts.shape[1] // compression)
                local = local_stage(
                    parts, part_w, k_local,
                    generator=make_generator(seed_dev, dev),
                    init=init, backend=be, stop=local_stop)
                lc = local.centers.reshape(n_sub_per_device * k_local, d)
                lw = local.counts.reshape(n_sub_per_device * k_local)
                # the reduce tree, collective-free: this shard's pool only
                for i, lvl in enumerate(levels):
                    lc, lw, _ = reduce_pool(
                        lc, lw, lvl,
                        make_generator(derive_seed(seed_dev, 1 + i), dev),
                        backend=be)
                pools.append(lc)
                merge_ws.append(lw if weighted_merge
                                else (lw > 0).to(xs.dtype))

        seed_merge = derive_seed(base, _GLOBAL)
        all_c = mesh_concat(pools, dev0)
        all_w = mesh_concat(merge_ws, dev0)
        if merge == "replicated":
            # the paper's host merge over every shard's local centers, with
            # the single fit's restarts
            centers = kmeans_batched(
                all_c[None], k, weights=all_w[None],
                generator=make_generator(seed_merge, dev0), init=merge_init,
                backend=be, restarts=restarts, stop=global_stop).centers[0]
        else:
            centers, _ = _distributed_merge(pools, merge_ws, k, global_stop,
                                            seed_merge, be, devices)

        # scored in the input space: the scaled space under-reports wide
        # features
        centers = unscale(centers, params)
        all_c = unscale(all_c, params)
        parts_sse = []
        for xs, c, dev in zip(raw, replicate(centers, devices), devices):
            with on_device(dev):
                parts_sse.append(sse_fn(xs, c, block=SSE_BLOCK))
        return DistributedClusteringResult(centers, all_c, all_w,
                                           mesh_sum(parts_sse, dev0))

    from repro_torch.telemetry import NULL, get_run_logger
    log = get_run_logger(
        logger if logger is not None else spec.execution.telemetry)
    if log is NULL:
        return fit
    n_dev = len(devices)

    def logged(x, seed: "int | torch.Generator" = 0
               ) -> DistributedClusteringResult:
        with log.timer("fit_shard_map", n=int(x.shape[0]), k=k,
                       merge_path=merge, levels=len(levels), devices=n_dev):
            res = fit(x, seed)
            _sync(devices)
        log.event("dist_fit", n=int(x.shape[0]), k=k, merge_path=merge,
                  devices=n_dev, pool=int(res.local_centers.shape[0]),
                  sse=float(res.sse))
        return res

    return logged


# ---------------------------------------------------------------------------
# The sharded out-of-core executor (mode="chunked_dist")
# ---------------------------------------------------------------------------

class ChunkDistStats(NamedTuple):
    """Accounting of one :func:`fit_chunked_dist` run: the sharded
    counterpart of :class:`~repro_torch.core.pipeline.ChunkStats`, with
    per-device breakdowns that show that every shard pulled its own share
    and the dataset never sat in one place."""
    n_points: int             # rows folded across all shards
    n_chunks: int             # chunks consumed across all shards
    max_chunk_points: int     # largest single resident chunk (rows)
    pool_size: int            # concatenated pool rows the merge saw
    prefetch: int             # per-device chunks in flight (host → device)
    passes: int               # data passes: fold (+ scale) (+ exact SSE)
    n_devices: int            # mesh entries = source shards
    per_device_points: tuple  # rows folded by each shard
    per_device_chunks: tuple  # chunks consumed by each shard
    peak_pool_rows: int       # most pool rows alive on any one shard


def merge_pool_distributed(pools, pool_ws, spec: ClusterSpec, mesh,
                           seed: "int | torch.Generator", *,
                           backend: BackendSpec = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard weighted center pools with each pool left on its
    shard: only the k centers' statistics combine each Lloyd round
    (:func:`_distributed_merge`, the ``merge_path="distributed"`` merge of
    the resident fit).

    ``pools``/``pool_ws`` are per-shard ``(p_i, d)`` / ``(p_i,)`` arrays or
    tensors in mesh order, one per mesh entry.  Ragged pools are padded to
    the widest with zero-weight rows, which carry no weight into the greedy
    picks or the Lloyd rounds.  Returns ``(centers (k, d), n_iter)`` on the
    first mesh device, in the pools' space (the caller unscales)."""
    devices = list(mesh.devices.flat)
    be = get_backend(backend if backend is not None
                     else spec.execution.backend, device=devices[0])
    if len(pools) != len(devices):
        raise ValueError(f"merge_pool_distributed: {len(pools)} pools for a "
                         f"{len(devices)}-device mesh")
    p_max = max(int(p.shape[0]) for p in pools)
    cs, ws = [], []
    for c, w, dev in zip(pools, pool_ws, devices):
        c = torch.as_tensor(c).to(dev)
        w = torch.as_tensor(w).to(dev)
        pad = p_max - c.shape[0]
        if pad:
            c = torch.cat([c, c.new_zeros((pad, c.shape[1]))])
            w = torch.cat([w, w.new_zeros((pad,))])
        cs.append(c)
        ws.append(w if spec.merge.weighted else (w > 0).to(c.dtype))
    return _distributed_merge(cs, ws, spec.merge.k, spec.merge.effective_stop,
                              seed_of(seed), be, devices)


def fit_chunked_dist(source, spec: ClusterSpec, mesh,
                     seed: "int | torch.Generator" = 0, *,
                     backend: BackendSpec = None, logger=None
                     ) -> tuple[SampledClusteringResult, ChunkDistStats]:
    """Run the spec's pipeline **out of core and over a mesh**
    (``mode="chunked_dist"``): the source splits into one
    ``source.shard(i, n)`` per mesh entry, each shard's chunks are
    prefetched onto its own device and folded there, each shard reduces its
    pool through ``spec.levels`` on its own, and only the final pools meet
    in the merge.

    Chunks are dispatched round-robin, one per shard per sweep; nothing in
    a shard's fold waits on the host, so on distinct cards one device
    computes while the next one's chunk is queued.  The feature-scale
    min/max combine on the host (exact in any order); the dropped counts
    add on the first device; exact SSE partials add on the host in mesh
    order.  The ``"replicated"`` merge path runs
    :func:`~repro_torch.core.pipeline.merge_pool` over the gathered pools
    (which keeps the one-shard run :func:`fit_chunked` bit for bit); the
    ``"distributed"`` path runs :func:`merge_pool_distributed`.

    Streams: shard 0 draws exactly :func:`fit_chunked`'s (chunk 0 the
    local stream itself, chunk j child ``_CHUNK_KEY_OFFSET + j``, level j
    child ``1 + j``), so the one-shard run is ``fit_chunked`` by
    construction; shard i > 0 draws chunk j from child
    ``(i + 1) * _CHUNK_KEY_OFFSET + j`` and its levels from child ``1 + j``
    of its :func:`shard_seed`; each shard's flushes from its own
    ``(_FLUSH_KEY_OFFSET + i, flush)``.  The merge draws from the fit's
    global stream.

    A shard with no chunks contributes nothing (``plan`` rejects the
    configurations where that is known in advance).  Returns
    ``(SampledClusteringResult, ChunkDistStats)``; the result lives on the
    first mesh device."""
    from repro_torch.data.source import as_source, prefetch_to_device
    from repro_torch.launch.mesh import check_mesh
    from repro_torch.telemetry import NULL, get_run_logger, peak_rss_mb
    log = get_run_logger(logger if logger is not None
                         else spec.execution.telemetry)
    check_mesh(mesh)
    source = as_source(source)
    axis = spec.execution.mesh_axis
    if tuple(mesh.axis_names) != (axis,):
        raise ValueError(
            f"fit_chunked_dist: needs a 1-D mesh over axis {axis!r} "
            f"(spec.execution.mesh_axis), got axes {mesh.axis_names}")
    devices = list(mesh.devices.flat)
    dev0 = devices[0]
    n_dev = len(devices)
    base_seed = seed_of(seed)
    seed_local = derive_seed(base_seed, _LOCAL)
    be = get_backend(backend if backend is not None
                     else spec.execution.backend, device=dev0)
    shards = [source.shard(i, n_dev) for i in range(n_dev)]
    shard_seeds = [shard_seed(seed_local, i) for i in range(n_dev)]
    cp, depth = spec.chunk.chunk_points, spec.chunk.prefetch

    t_start = _now()
    passes = 1
    params = None
    if spec.scale:
        # per-shard running min/max, combined on the host: min and max are
        # exact, so this is the one-pass answer however the rows shard
        with log.timer("scale_pass", devices=n_dev):
            lo = hi = None
            for shard, dev in zip(shards, devices):
                slo, shi = minmax_pass(shard, cp, prefetch=depth, device=dev)
                if slo is None:
                    continue
                slo, shi = slo.cpu(), shi.cpu()
                lo = slo if lo is None else torch.minimum(lo, slo)
                hi = shi if hi is None else torch.maximum(hi, shi)
            if lo is None:
                raise ValueError(
                    "fit_chunked_dist: the source yielded no points")
            params = (lo, (hi - lo).clamp_min(1e-9))
        passes += 1
        log.event("pass_rss", stage="scale", peak_rss_mb=peak_rss_mb())
    shard_params = ([None] * n_dev if params is None else
                    list(zip(replicate(params[0], devices),
                             replicate(params[1], devices))))

    # per-shard fold state: bounded accumulators, counts kept on the device
    folds = [ShardFold(spec, shard_params[i], seed_local, dev, be, shard=i,
                       log=(log if log is not NULL else None))
             for i, dev in enumerate(devices)]
    fold_rate = log.rate("fold_rate", units="points")
    with log.timer("fold", devices=n_dev):
        its = [enumerate(prefetch_to_device(shard.chunks(cp), depth,
                                            device=dev))
               for shard, dev in zip(shards, devices)]
        live = list(range(n_dev))
        while live:
            # round-robin: one chunk per live shard per sweep
            for i in list(live):
                j, chunk = next(its[i], (None, None))
                if chunk is None:
                    live.remove(i)
                    continue
                with on_device(devices[i]):
                    m = folds[i].add(j, chunk)
                if m:
                    fold_rate.tick(m, device=i, chunk=j, rows=m)
    dev_chunks = [f.n_chunks for f in folds]
    n_points = sum(f.n_points for f in folds)
    if n_points == 0:
        raise ValueError("fit_chunked_dist: the source yielded no points")
    log.event("pass_rss", stage="fold", peak_rss_mb=peak_rss_mb())

    # each shard's collective-free reduce levels; then only the final pools
    # leave their devices
    pools, pool_ws, n_dropped = [], [], []
    for i, dev in enumerate(devices):
        if dev_chunks[i] == 0:
            continue            # an empty shard: nothing to reduce or merge
        with on_device(dev):
            pool_i, w_i, dropped, *_ = folds[i].result()
            for jl, lvl in enumerate(spec.levels):
                with log.timer("reduce_level", device=i, level=jl,
                               pool_in=int(pool_i.shape[0])):
                    pool_i, w_i, wd = reduce_pool(
                        pool_i, w_i, lvl,
                        make_generator(derive_seed(shard_seeds[i], 1 + jl),
                                       dev), backend=be)
                dropped = dropped + torch.round(wd).to(torch.int64)
        pools.append(pool_i)
        pool_ws.append(w_i)
        n_dropped.append(dropped)
    n_dropped = mesh_sum(n_dropped, dev0)
    pool = mesh_concat(pools, dev0)
    pool_w = mesh_concat(pool_ws, dev0)

    seed_global = derive_seed(base_seed, _GLOBAL)
    with log.timer("merge", pool=int(pool.shape[0]), k=spec.merge.k,
                   merge_path=spec.execution.merge_path):
        if spec.execution.merge_path == "distributed":
            # the pools stay on their shards; an empty shard rejoins the
            # mesh as one dead row on its own device
            merge_pools, merge_ws = list(pools), list(pool_ws)
            for i, dev in enumerate(devices):
                if not dev_chunks[i]:
                    merge_pools.insert(i, pool.new_zeros((1, pool.shape[1]),
                                                         device=dev))
                    merge_ws.insert(i, pool_w.new_zeros((1,), device=dev))
            centers, merge_iters = merge_pool_distributed(
                merge_pools, merge_ws, spec, mesh, seed_global, backend=be)
        else:
            merged = merge_pool(pool, pool_w, spec.merge,
                                make_generator(seed_global, dev0),
                                backend=be)
            centers, merge_iters = merged.centers, merged.n_iter
    if log is not NULL:
        _log_stage_iters(log, "fold", sum(int(f.fold_iters) for f in folds),
                         sum(f.fold_budget for f in folds))
        _log_stage_iters(log, "merge", int(merge_iters),
                         spec.merge.effective_stop.max_iters)

    local_centers = pool
    if params is not None:
        lo, span = params[0].to(dev0), params[1].to(dev0)
        centers = unscale(centers, (lo, span))
        local_centers = unscale(local_centers, (lo, span))
    if spec.chunk.sse == "exact":
        with log.timer("sse_pass", devices=n_dev):
            totals = []
            for i, (c, dev) in enumerate(zip(replicate(centers, devices),
                                             devices)):
                if dev_chunks[i]:
                    with on_device(dev):
                        totals.append(sse_pass(shards[i], c, cp,
                                               prefetch=depth))
            # one shard: its device total, fit_chunked's bit for bit; more:
            # the partials summed on the host in mesh order
            total_sse = (totals[0] if n_dev == 1 else torch.tensor(
                sum(float(s) for s in totals), dtype=torch.float32,
                device=dev0))
        passes += 1
        log.event("pass_rss", stage="sse", peak_rss_mb=peak_rss_mb())
    else:   # "pool": weighted SSE of the representatives, no extra pass
        with log.timer("sse_pool"):
            total_sse = sse_fn(local_centers, centers, weights=pool_w,
                               block=SSE_BLOCK)

    result = SampledClusteringResult(centers, total_sse, local_centers,
                                     pool_w, n_dropped)
    stats = ChunkDistStats(
        n_points=n_points, n_chunks=sum(dev_chunks),
        max_chunk_points=max(f.max_chunk_points for f in folds),
        pool_size=int(pool.shape[0]), prefetch=depth, passes=passes,
        n_devices=n_dev, per_device_points=tuple(f.n_points for f in folds),
        per_device_chunks=tuple(dev_chunks),
        peak_pool_rows=max(f.acc.peak_rows for f in folds))
    if log is not NULL:
        _sync(devices)          # wall time means "result ready"
        wall = _now() - t_start
        summary = stats._asdict()
        summary["per_device_points"] = list(stats.per_device_points)
        summary["per_device_chunks"] = list(stats.per_device_chunks)
        log.event("fit_chunked_dist", k=spec.merge.k, levels=spec.n_levels,
                  backend=be.name, merge_path=spec.execution.merge_path,
                  wall_s=wall, points_per_sec=n_points / max(wall, 1e-9),
                  peak_rss_mb=peak_rss_mb(), **summary)
    return result, stats
