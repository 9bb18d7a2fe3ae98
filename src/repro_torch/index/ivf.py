"""IVF/PQ index build and query: the paper's pipeline serving
nearest-neighbour search.  The port's counterpart of :mod:`repro.index.ivf`.

Build (:func:`build_index`) is two streaming passes over any
:class:`~repro_torch.data.source.DataSource`:

  1. **train** — the first ``spec.train_points`` rows (a chunking-invariant
     prefix) are collected and the coarse quantizer is fit through the
     ordinary ``plan()``/``execute()`` path of the contained
     ``ClusterSpec`` (the Lloyd kernel); the PQ codebooks then train on that
     sample's coarse residuals, all subspaces in one batched k-means.
  2. **encode** — every chunk is prefetched to the device, routed to its
     cell by the backend's assignment (the assignment kernel) and
     PQ-encoded; the host holds the training sample plus ``prefetch``
     chunks at most.  With a mesh, the source splits into one shard per
     mesh entry, each encoding on its own device (one chunk per live shard
     per round).

Inverted lists are padded dense tensors — ``(nlist, cap)`` slots with a
per-cell ``counts`` — so a query is: route to the ``nprobe`` nearest
cells, build one ADC lookup table per (query, cell), and scan the probed
cells' codes with :func:`repro_torch.kernels.scan.adc_scan_cuda` (the ADC
scan kernel on the card, its plain version on the CPU).  Empty slots and cells surface as ``+inf`` / id
``-1``.  Top-k keeps the JAX package's ``lax.top_k`` order: ascending
distance, equal distances in increasing candidate position.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.api import ExecutionPlan, execute, plan
from repro_torch.core.backend import LloydBackend
from repro_torch.core.device import derive_seed, resolve_device, seed_of
from repro_torch.core.distributed import mesh_concat, on_device, replicate
from repro_torch.core.kmeans import pairwise_sqdist
from repro_torch.data.source import DataSource, as_source, prefetch_to_device
from repro_torch.kernels.scan import adc_scan_cuda
from repro_torch.launch.mesh import Mesh, check_mesh
from repro_torch.telemetry import NULL, RunLogger, get_run_logger

from .pq import ENCODE_BLOCK, build_luts, encode_residuals, train_codebooks
from .spec import IndexSpec

# default query block: searches run this many queries at a time, so the
# gathered candidate codes stay O(q_block · nprobe · cap · m)
QUERY_BLOCK = 32

# child streams of a build's seed (the JAX package splits its key in two)
_COARSE, _PQ = 0, 1


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IndexPlan:
    """A validated index spec: the coarse quantizer's own
    :class:`~repro_torch.api.ExecutionPlan` (resolved registries, backend,
    device), plus the index-level facts the build needs."""
    spec: IndexSpec
    coarse: ExecutionPlan
    dim: Optional[int] = None
    n_points: Optional[int] = None
    mesh: Optional[Mesh] = None
    logger: RunLogger = NULL

    @property
    def nlist(self) -> int:
        return self.spec.nlist

    @property
    def backend(self) -> LloydBackend:
        return self.coarse.backend

    @property
    def device(self) -> torch.device:
        return self.coarse.device


def plan_index(spec: IndexSpec, data_shape: Optional[tuple] = None, *,
               mesh: Optional[Mesh] = None,
               source: Optional[DataSource] = None,
               device: "torch.device | str | None" = None,
               logger: "RunLogger | str | None" = None) -> IndexPlan:
    """Fail-fast validation for an :class:`IndexSpec`, on ``device``
    (``None``: the first entry of ``mesh``, or the CUDA device).  The
    coarse quantizer trains on that one device; ``mesh`` shards only the
    encode pass.  Checks:

      * ``nprobe <= nlist``;
      * ``train_points`` must cover both codebook training (``>= 2**bits``
        rows) and the coarse merge (``>= nlist``);
      * once the dimensionality is known (``data_shape`` or ``source.dim``),
        ``n_subspaces`` must divide ``d``;
      * the coarse ``ClusterSpec`` is planned against the training sample's
        shape through :func:`repro_torch.api.plan`.
    """
    if spec.nprobe > spec.nlist:
        raise ValueError(
            f"plan_index: nprobe={spec.nprobe} exceeds nlist={spec.nlist} — "
            f"a query cannot probe more cells than the index has")
    if spec.train_points < spec.pq.n_codes:
        raise ValueError(
            f"plan_index: train_points={spec.train_points} cannot train "
            f"{spec.pq.n_codes}-entry codebooks (bits={spec.pq.bits}); "
            f"need at least 2**bits rows")
    if spec.train_points < spec.nlist:
        raise ValueError(
            f"plan_index: train_points={spec.train_points} cannot place "
            f"nlist={spec.nlist} coarse centers; raise train_points or "
            f"lower nlist")
    d = None
    n = None
    if data_shape is not None:
        n = int(data_shape[0]) if data_shape[0] else None
        d = int(data_shape[1]) if len(data_shape) > 1 else None
    if d is None and source is not None:
        d = source.dim
    if n is None and source is not None:
        n = source.n_points
    if d is not None and d % spec.pq.n_subspaces:
        raise ValueError(
            f"plan_index: n_subspaces={spec.pq.n_subspaces} does not "
            f"divide d={d} — PQ needs equal subspace widths")
    if mesh is not None:
        check_mesh(mesh)
        if device is None:
            device = mesh.devices.flat[0]
    train_n = spec.train_points if n is None else min(n, spec.train_points)
    coarse_shape = (train_n, d) if d is not None else None
    cplan = plan(spec.coarse, coarse_shape, device=device, logger=logger)
    return IndexPlan(spec=spec, coarse=cplan, dim=d, n_points=n, mesh=mesh,
                     logger=cplan.logger)


# ---------------------------------------------------------------------------
# The index
# ---------------------------------------------------------------------------

class IndexBuildStats(NamedTuple):
    """Out-of-core accounting from one :func:`build_index` run."""
    n_points: int          # rows encoded into the inverted lists
    n_chunks: int          # chunks the encode pass consumed
    max_chunk_points: int  # largest single streamed chunk (rows)
    train_rows: int        # rows in the resident training sample
    max_resident_rows: int  # peak resident rows: max(train sample,
    #                         prefetch window of the encode stream)
    prefetch: int          # chunks in flight at once (host→device buffer)
    passes: int            # source passes: train prefix + encode
    n_shards: int = 1      # device shards the encode pass ran over


@dataclasses.dataclass
class IVFIndex:
    """A built IVF/PQ index: the coarse quantizer, the per-subspace
    codebooks, and padded dense inverted lists, all on one device.

    ``codes[cell, slot]`` holds the PQ code of the ``slot``-th member of
    ``cell`` (zeros beyond ``counts[cell]``), ``ids[cell, slot]`` its
    source row id (``-1`` beyond the count)."""
    spec: IndexSpec
    coarse_centers: torch.Tensor   # (nlist, d) f32
    codebooks: torch.Tensor        # (m, C, d/m) f32
    codes: torch.Tensor            # (nlist, cap, m) uint8
    ids: torch.Tensor              # (nlist, cap) int32, -1 = empty slot
    counts: torch.Tensor           # (nlist,) int32

    @property
    def nlist(self) -> int:
        return int(self.coarse_centers.shape[0])

    @property
    def dim(self) -> int:
        return int(self.coarse_centers.shape[1])

    @property
    def cap(self) -> int:
        """Inverted-list slot capacity (the largest cell's size)."""
        return int(self.codes.shape[1])

    @property
    def device(self) -> torch.device:
        return self.coarse_centers.device

    @property
    def n_points(self) -> int:
        return int(self.counts.sum())

    @property
    def n_nonempty(self) -> int:
        return int((self.counts > 0).sum())

    def search(self, queries, k: int = 10, *,
               nprobe: Optional[int] = None,
               q_block: int = QUERY_BLOCK,
               logger: "RunLogger | str | None" = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched ANN query — see :func:`search`."""
        return search(self, queries, k, nprobe=nprobe, q_block=q_block,
                      logger=logger)

    def __repr__(self):
        return (f"<IVFIndex nlist={self.nlist} d={self.dim} "
                f"m={self.spec.pq.n_subspaces} bits={self.spec.pq.bits} "
                f"n={self.n_points} cap={self.cap} device={self.device}>")


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------

def _prefix_sample(src: DataSource, n_rows: int, chunk_points: int):
    """The first ``n_rows`` rows of the source — the same rows whatever
    ``chunk_points`` the stream arrives in."""
    parts, have = [], 0
    for chunk in src.chunks(chunk_points):
        take = min(n_rows - have, chunk.shape[0])
        if take:
            parts.append(chunk[:take])
            have += take
        if have >= n_rows:
            break
    if not parts:
        raise ValueError("build_index: the source yielded no rows")
    if len(parts) == 1:
        return parts[0]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return np.concatenate(parts, axis=0)


def _encode_chunk(backend: LloydBackend, x: torch.Tensor,
                  centers: torch.Tensor, codebooks: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Route one chunk to its cells (the backend's assignment) and
    PQ-encode its residuals: ``(cells (n,) int32, codes (n, m) uint8)``."""
    x = x.float()
    idx, _ = backend.assign_points(x, centers, block=ENCODE_BLOCK)
    resid = x - centers[idx.long()]
    return idx, encode_residuals(resid, codebooks, block=ENCODE_BLOCK)


def _assemble_lists(cells: torch.Tensor, codes: torch.Tensor, nlist: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter stream-ordered (cells, codes) into padded dense inverted
    lists, members of a cell in stream order; returns ``(list_codes,
    list_ids, counts)``."""
    n, m = codes.shape
    dev = codes.device
    cells = cells.long()
    counts = torch.bincount(cells, minlength=nlist)
    cap = max(1, int(counts.max())) if n else 1
    list_codes = torch.zeros((nlist, cap, m), dtype=torch.uint8, device=dev)
    list_ids = torch.full((nlist, cap), -1, dtype=torch.int32, device=dev)
    if n:
        order = torch.sort(cells, stable=True).indices
        starts = torch.cumsum(counts, 0) - counts
        sorted_cells = cells[order]
        slots = torch.arange(n, device=dev) - starts[sorted_cells]
        list_codes[sorted_cells, slots] = codes[order]
        list_ids[sorted_cells, slots] = order.to(torch.int32)
    return list_codes, list_ids, counts.to(torch.int32)


def build_index(source, spec: IndexSpec,
                seed: "int | torch.Generator" = 0, *,
                mesh=None, device: "torch.device | str | None" = None,
                logger: "RunLogger | str | None" = None
                ) -> tuple[IVFIndex, IndexBuildStats]:
    """Build an IVF/PQ index from any array or
    :class:`~repro_torch.data.source.DataSource` on ``device`` (``None``:
    the CUDA device); see the module docstring for the two passes.
    ``seed`` takes the place of the JAX package's ``key``: the coarse fit
    and the codebook fits draw from child streams derived from it.
    Returns ``(index, IndexBuildStats)``.

    With ``mesh`` the encode pass splits the source into one shard per
    mesh entry (``source.shard(i, n)``), each prefetched onto and encoded
    on its own device with its own copy of the centers and codebooks;
    training is the unsharded build's.  Ids are assigned shard-major,
    which for contiguous row-range shards (``ArraySource``) is the
    source's row order, and the index is the unsharded build's bit for
    bit.  The index lives on ``device`` (``None``: the first mesh
    entry)."""
    src = as_source(source)
    iplan = plan_index(spec, src.shape, mesh=mesh, source=src,
                       device=device, logger=logger)
    log = iplan.logger
    dev = iplan.device
    base = seed_of(seed)
    chunk_points = spec.coarse.chunk.chunk_points
    prefetch = spec.coarse.chunk.prefetch

    with log.timer("index_build", nlist=spec.nlist,
                   n_subspaces=spec.pq.n_subspaces, bits=spec.pq.bits):
        # -- pass 1: train coarse quantizer + codebooks on the prefix ------
        with log.timer("index_train_sample", budget=spec.train_points):
            train = torch.as_tensor(
                _prefix_sample(src, spec.train_points, chunk_points),
                device=dev).float()
        # re-plan against the sample actually collected (sources with
        # unknown n_points may yield fewer rows than the budget)
        cplan = plan(spec.coarse, tuple(train.shape), device=dev,
                     logger=log)
        with log.timer("index_train_coarse", nlist=spec.nlist,
                       rows=int(train.shape[0])):
            centers = execute(cplan, train,
                              derive_seed(base, _COARSE)).centers.float()
        with log.timer("index_train_pq", n_subspaces=spec.pq.n_subspaces,
                       n_codes=spec.pq.n_codes):
            cells_t, _ = cplan.backend.assign_points(train, centers,
                                                     block=ENCODE_BLOCK)
            codebooks = train_codebooks(train - centers[cells_t.long()],
                                        spec.pq, derive_seed(base, _PQ),
                                        backend=cplan.backend)

        # -- pass 2: stream-encode every row -------------------------------
        devices = list(mesh.devices.flat) if mesh is not None else [dev]
        n_shards = len(devices)
        shards = ([src] if n_shards == 1 else
                  [src.shard(i, n_shards) for i in range(n_shards)])
        streams = [prefetch_to_device(s.chunks(chunk_points), prefetch,
                                      device=d)
                   for s, d in zip(shards, devices)]
        params = list(zip(replicate(centers, devices),
                          replicate(codebooks, devices)))
        shard_parts: list = [[] for _ in range(n_shards)]
        n_chunks = max_chunk = 0
        with log.timer("index_encode", n_shards=n_shards):
            meter = log.rate("index_encode_rate", units="points")
            live = list(range(n_shards))
            while live:
                # one chunk per live shard per round: nothing waits on the
                # host, so distinct devices encode at once
                for i in list(live):
                    chunk = next(streams[i], None)
                    if chunk is None:
                        live.remove(i)
                        continue
                    with on_device(devices[i]):
                        shard_parts[i].append(_encode_chunk(
                            cplan.backend, chunk, *params[i]))
                    n_chunks += 1
                    max_chunk = max(max_chunk, int(chunk.shape[0]))
                    meter.tick(int(chunk.shape[0]), shard=i)
        parts = [p for ps in shard_parts for p in ps]   # shard-major
        cells = mesh_concat([c for c, _ in parts], dev)
        codes = mesh_concat([q for _, q in parts], dev)

        with log.timer("index_assemble", nlist=spec.nlist):
            list_codes, list_ids, counts = _assemble_lists(
                cells, codes, spec.nlist)

    n = int(cells.shape[0])
    stats = IndexBuildStats(
        n_points=n,
        n_chunks=n_chunks,
        max_chunk_points=max_chunk,
        train_rows=int(train.shape[0]),
        max_resident_rows=max(int(train.shape[0]),
                              min(max_chunk * prefetch, n)),
        prefetch=prefetch,
        passes=2,
        n_shards=n_shards,
    )
    log.event("index_built", **stats._asdict())
    index = IVFIndex(spec=spec, coarse_centers=centers, codebooks=codebooks,
                     codes=list_codes, ids=list_ids, counts=counts)
    return index, stats


# ---------------------------------------------------------------------------
# Query
# ---------------------------------------------------------------------------

def _smallest(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest entries of each row and their positions,
    ascending, equal values in increasing position (``lax.top_k``'s order
    on the negated values)."""
    vals, pos = torch.sort(d, dim=1, stable=True)
    return vals[:, :k], pos[:, :k]


def _probe_cells(queries: torch.Tensor, coarse_centers: torch.Tensor,
                 nprobe: int) -> torch.Tensor:
    """Route each query to its ``nprobe`` nearest coarse cells."""
    d2 = pairwise_sqdist(queries.float(), coarse_centers)
    return _smallest(d2, nprobe)[1].to(torch.int32)


def _scan_probed(queries: torch.Tensor, cells: torch.Tensor,
                 index: IVFIndex, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """ADC-scan the probed cells' candidate lists and keep the top ``k``.
    Invalid slots (``slot >= counts[cell]``) scan to ``+inf`` and resolve
    to id ``-1``."""
    q, p = cells.shape
    _, cap, m = index.codes.shape
    c = index.codebooks.shape[1]
    cl = cells.long()
    luts = build_luts(queries, cells, index.coarse_centers, index.codebooks)
    dists = adc_scan_cuda(luts.reshape(q * p, m, c),
                          index.codes[cl].reshape(q * p, cap, m)
                          ).reshape(q, p, cap)
    slot = torch.arange(cap, device=dists.device)
    valid = slot[None, None, :] < index.counts[cl][:, :, None]
    flat_d = torch.where(valid, dists, torch.inf).reshape(q, p * cap)
    flat_i = index.ids[cl].reshape(q, p * cap)
    kk = min(k, p * cap)
    out_d, pos = _smallest(flat_d, kk)
    out_i = torch.where(torch.isfinite(out_d), flat_i.gather(1, pos), -1)
    if kk < k:
        out_d = torch.nn.functional.pad(out_d, (0, k - kk), value=torch.inf)
        out_i = torch.nn.functional.pad(out_i, (0, k - kk), value=-1)
    return out_d, out_i.to(torch.int32)


def search(index: IVFIndex, queries, k: int = 10, *,
           nprobe: Optional[int] = None,
           q_block: int = QUERY_BLOCK,
           logger: "RunLogger | str | None" = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched ANN query on the index's device: ``(Q, d)`` queries ->
    ``((Q, k) f32 approximate squared distances, (Q, k) int32 ids)``,
    nearest first.

    Per ``q_block`` of queries: **probe** (route to the ``nprobe`` nearest
    cells) and **scan** (per-(query, cell) ADC lookup tables and the
    :func:`~repro_torch.kernels.scan.adc_scan_cuda` kernel over the cells'
    candidate slots), timed by ``index_probe``/``index_scan`` and metered
    by ``index_query_rate`` on the given logger.  Ids are ``-1`` (distance
    ``+inf``) past the real candidates."""
    log = get_run_logger(logger) if logger is not None else NULL
    nprobe = index.spec.nprobe if nprobe is None else nprobe
    if not 1 <= nprobe <= index.nlist:
        raise ValueError(
            f"search: nprobe={nprobe} out of range [1, nlist="
            f"{index.nlist}]")
    queries = torch.as_tensor(queries, device=index.device)
    if queries.dim() != 2 or queries.shape[1] != index.dim:
        raise ValueError(
            f"search: queries must be (Q, {index.dim}), got "
            f"{tuple(queries.shape)}")
    nq = queries.shape[0]
    out_d, out_i = [], []
    t0 = time.perf_counter()
    with log.timer("index_search", queries=nq, k=k, nprobe=nprobe):
        for start in range(0, nq, q_block):
            qb = queries[start:start + q_block]
            with log.timer("index_probe", queries=int(qb.shape[0]),
                           nprobe=nprobe):
                cells = _probe_cells(qb, index.coarse_centers, nprobe)
            with log.timer("index_scan", candidates=nprobe * index.cap):
                d, i = _scan_probed(qb, cells, index, k)
            out_d.append(d)
            out_i.append(i)
    if log is not NULL:
        log.rate("index_query_rate", units="queries").tick(
            nq, dur=time.perf_counter() - t0, k=k, nprobe=nprobe)
    if len(out_d) == 1:
        return out_d[0], out_i[0]
    return torch.cat(out_d), torch.cat(out_i)


# ---------------------------------------------------------------------------
# Exact baseline + recall
# ---------------------------------------------------------------------------

def exact_search(data, queries, k: int = 10, *, chunk_points: int = 65536,
                 device: "torch.device | str | None" = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Brute-force exact k-NN baseline on ``device`` (``None``: the CUDA
    device): streams any array/DataSource chunk by chunk, folding a running
    ``(Q, k)`` top-k.  Returns ``((Q, k) f32 distances, (Q, k) int32
    ids)``, nearest first.

    For sources whose contents depend on the traversal chunk size
    (``SyntheticSource``), pass the ``chunk_points`` the index was built
    with, so that both describe the same corpus."""
    src = as_source(data)
    dev = resolve_device(device)
    q = torch.as_tensor(queries, device=dev).float()
    best_d = torch.full((q.shape[0], k), torch.inf, device=dev)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int32, device=dev)
    offset = 0
    for chunk in prefetch_to_device(src.chunks(chunk_points), 2,
                                    device=dev):
        d2 = pairwise_sqdist(q, chunk.float())
        ids = torch.arange(offset, offset + chunk.shape[0],
                           dtype=torch.int32, device=dev)
        cat_d = torch.cat([best_d, d2], 1)
        cat_i = torch.cat([best_i, ids.expand(q.shape[0], -1)], 1)
        best_d, pos = _smallest(cat_d, k)
        best_i = cat_i.gather(1, pos)
        offset += int(chunk.shape[0])
    if offset == 0:
        raise ValueError("exact_search: the source yielded no rows")
    return best_d, best_i


def recall_at_k(found_ids, true_ids) -> float:
    """Fraction of true neighbours recovered: ``|found ∩ true| / |true|``
    averaged over queries (ids ``< 0`` in ``true_ids`` — padding — are
    excluded from the denominator)."""
    found, true = (np.asarray(t.cpu()) if isinstance(t, torch.Tensor)
                   else np.asarray(t) for t in (found_ids, true_ids))
    valid = true >= 0
    hits = (true[:, :, None] == found[:, None, :]).any(axis=2) & valid
    denom = np.maximum(valid.sum(), 1)
    return float(hits.sum() / denom)
