"""The GPU tile contract of the port's kernels — ONE place for the launch
shapes that the kernels in ``csrc/`` are given, and for the checks their
wrappers make before a launch.

  * One point per thread, ``THREADS`` points per tile: ragged M is masked
    in the kernel, so the points are never padded.
  * The point is held in ``register_dim(d)`` registers (the next power of
    two from 2 to 128, zero-filled past ``d``); a wider ``d`` reads the
    point from device memory instead (``register_dim`` returns 0).  There
    is no 128-lane padding of ``d``: at the paper's ``d=2`` the kernel does
    the work of ``d=2``.
  * Centers are staged in shared memory ``center_tile(k, d)`` at a time;
    ragged K is never visited.
  * The assignment kernel (``assign.cu``) takes one of two routes,
    ``assign_route(k, d)``: the Lloyd kernel's tensor-core argmin
    (``"tc"``), or the SIMT route, where each thread holds
    ``assign_points(...)`` points and each batch entry gets
    ``assign_blocks(...)`` blocks (one wave for the card), a warp taking
    32 of them per lane at a time.
  * The Lloyd kernel (``lloyd.cu``) takes one of two routes,
    ``lloyd_route(k, d)``.  The tensor-core route (``"tc"``: d >=
    ``TC_MIN_D`` with an accumulator too large for shared memory, or a
    point too wide for the registers) gives each block ``TC_ROWS`` points
    and walks the lane's centers in tiles of ``TC_COLS``, ``TC_CHUNK``
    dims at a time: a pre-pass writes both operands' TF32 hi and lo planes
    to the device workspace (``tc_work_floats``) and ``TC_STAGES`` stages
    stream them by bulk copies (``tc_smem_bytes``).  The SIMT route
    (``"simt"``) runs
    ``lloyd_blocks(...)`` blocks per batch entry (as many as the card holds
    at once, capped by its scratch) and keeps each block's (K, d+1)
    accumulator in shared memory when ``acc_in_smem(k, d)``
    (``lloyd_simt_smem_bytes``).
  * The centroid update (``centroid.cu``) keeps ``centroid_warps(k, d)``
    warp-private (K, d+1) accumulators per block in shared memory and runs
    ``centroid_blocks(...)`` blocks per lane when ``acc_in_smem(k, d)``;
    else (``centroid_sorts(k, d)``) it sorts each lane's points by cluster:
    one block per lane holds K + 1 cursors in shared memory
    (``check_sort_clusters``), then groups of ``segment_lanes(d)`` lanes
    sum ``segment_clusters(d)`` clusters per block.
  * The ADC scan (``adc_scan.cu``) stages one (m, C) lookup table per
    block in shared memory in its own type (``scan_smem_bytes``, at most
    ``MAX_SMEM_BYTES``), 16 bytes at a time where ``scan_vector_table``
    holds; its ``scan_plan`` gives each batch entry G blocks, one wave for
    the card, block g walking the entry's ``THREADS``-row tiles g, g + G,
    ...; each thread owns one row of a tile and reads its codes
    ``code_vector_bytes(...)`` at a time.
  * The cluster attention (``cluster_attn.cu``) gives ``attn_lanes_per_row``
    lanes to one centroid row (16 bytes each), serves up to
    ``ATTN_MAX_GROUP`` query heads per kv head, splits the centroid axis
    into ``attn_splits(...)`` blocks per (batch, kv head), and streams each
    split through shared memory ``attn_stage_rows(...)`` rows at a time.

Launch parameters a tuner may set (``kernels/autotune.py``): the SIMT
routes' center tile, blocks per batch entry and (assignment) points per
thread, the centroid warp path's and the ADC scan's blocks.  Each plan
function takes the requested value as an override, 0 meaning its formula,
and clamps it to what the kernel can run (``clamp_center_tile``, the
``blocks=`` of ``lloyd_blocks`` / ``assign_blocks`` / ``centroid_blocks`` /
``scan_plan``, the ``points=`` of ``assign_points``): without an override
each returns the formula's plan.  ``lloyd_plan`` and ``assign_plan`` put a
SIMT launch together from them.

A shape outside the contract raises :class:`TileError` (a ``ValueError``)
before anything is launched.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

THREADS = 256                     # threads per block = points per tile
REGISTER_DIMS = (2, 4, 8, 16, 32, 64, 128)
CENTER_SMEM_BYTES = 48 * 1024     # shared memory for one staged center tile
ACC_SMEM_BYTES = 96 * 1024        # largest accumulator kept in shared memory
SCRATCH_BYTES = 256 * 2 ** 20     # bound on the Lloyd kernel's partials
CENTROID_MAX_WARPS = 8            # accumulators per block of the warp path
CENTROID_SMEM_BYTES = 100 * 1024  # their shared memory per block
CENTROID_MERGE_BYTES = 384 * 1024  # partials one last block merges
CENTROID_SM_THREADS = 1024        # warp-path threads per SM (registers)
MAX_BATCH = 65535                 # the grid's y extent
MAX_SMEM_BYTES = 232448           # a block's opt-in shared memory on sm_90
SM_SMEM_BYTES = 233472            # shared memory of one SM's blocks (228 KB)
SMEM_RESERVED_BYTES = 1024        # the runtime's own share per block
SM_THREADS = 2048                 # resident threads per SM
WARPS = THREADS // 32
TC_MIN_D = 32                     # narrowest d of the tensor-core route
TC_ROWS = 128                     # points per tensor-core block
TC_COLS = 128                     # centers per tensor-core tile
TC_CHUNK = 32                     # dims per staged chunk
TC_STAGES = 3                     # staged chunks in flight
ASSIGN_POINTS = 4                 # points per thread of the SIMT assignment
ASSIGN_TILE_MAX_DIM = 16          # widest register_dim that takes them
ASSIGN_ITEMS_PER_SCHEDULER = 2    # 32-point-per-lane items that earn them
SM_SCHEDULERS = 4                 # warp schedulers per SM
FLOATS = (torch.float32, torch.bfloat16)   # point, weight and table types
ATTN_MAX_GROUP = 8                # query heads per kv head the kernel serves
ATTN_MIN_ROWS = 64                # fewest centroids one attention split takes
ATTN_MAX_ROWS = 8192              # most centroids (biases in smem) per split
ATTN_BLOCKS_PER_SM = 2            # attention blocks resident per SM
ATTN_STAGE_BYTES = 16 * 1024      # key + value rows per ring stage


class TileError(ValueError):
    """A kernel was handed a shape its launch contract cannot cover.
    Carries the offending ``(extent, block)`` pair."""

    def __init__(self, message: str, *, extent: int = 0, block: int = 0):
        super().__init__(message)
        self.extent = extent
        self.block = block


def register_dim(d: int) -> int:
    """Registers that hold one point: the smallest of ``REGISTER_DIMS``
    that is >= ``d``, or 0 when ``d`` exceeds them all."""
    for r in REGISTER_DIMS:
        if d <= r:
            return r
    return 0


def center_stride(d: int) -> int:
    """Floats per staged center (coordinates, then |c|^2, float4-padded
    when the point is held in registers) — ``center_stride`` in
    ``csrc/distance.cuh``."""
    dp = register_dim(d)
    return (dp + 4) // 4 * 4 if dp else d + 1


def center_tile(k: int, d: int) -> int:
    """Centers staged per tile: all ``k`` when they fit in
    ``CENTER_SMEM_BYTES``, else as many as fit."""
    bk = min(k, CENTER_SMEM_BYTES // (4 * center_stride(d)))
    if bk < 1:
        raise TileError(
            f"d={d}: one center does not fit the {CENTER_SMEM_BYTES}-byte "
            f"shared-memory tile", extent=d, block=CENTER_SMEM_BYTES // 4)
    return bk


def clamp_center_tile(k: int, d: int, tile: int = 0, reserved: int = 0
                      ) -> int:
    """The center tile a SIMT kernel runs for a requested ``tile``: 0 gives
    :func:`center_tile`; else at most ``k`` centers, and no more than fit a
    block's ``MAX_SMEM_BYTES`` beside ``reserved`` bytes of its other
    shared memory (at least one)."""
    derived = center_tile(k, d)
    if not tile:
        return derived
    fit = (MAX_SMEM_BYTES - reserved) // (4 * center_stride(d))
    return max(1, min(tile, k, fit))


def acc_in_smem(k: int, d: int) -> bool:
    """Whether the Lloyd kernel keeps a block's (K, d) sums and (K,) counts
    in shared memory (else in its slice of the global scratch)."""
    return 4 * k * (d + 1) <= ACC_SMEM_BYTES


def centroid_sorts(k: int, d: int) -> bool:
    """Whether the centroid update takes its counting-sort path (a lane's
    (K, d+1) accumulator does not fit shared memory), else its
    warp-accumulator path."""
    return not acc_in_smem(k, d)


def centroid_warps(k: int, d: int) -> int:
    """Warps per block of the centroid update's warp path, each with its
    own (K, d+1) accumulator: as many as ``CENTROID_SMEM_BYTES`` of shared
    memory hold, 1 to ``CENTROID_MAX_WARPS``."""
    return max(1, min(CENTROID_MAX_WARPS,
                      CENTROID_SMEM_BYTES // (4 * k * (d + 1))))


def centroid_blocks(b: int, m: int, k: int, d: int, sm_count: int,
                    blocks: int = 0) -> int:
    """Blocks per lane of the centroid update's warp path: as many as fit
    the card at once (by shared memory and registers), no more than the lane
    has tiles for, and few enough that the last block's merge reads at most
    ``CENTROID_MERGE_BYTES`` of partials; a requested ``blocks`` is clamped
    to that."""
    warps = centroid_warps(k, d)
    acc = 4 * k * (d + 1)
    per_sm = max(1, min(CENTROID_SM_THREADS // (32 * warps),
                        MAX_SMEM_BYTES // (warps * acc)))
    most = max(1, min(-(-m // (32 * warps)), per_sm * sm_count // b,
                      CENTROID_MERGE_BYTES // acc))
    return min(blocks, most) if blocks else most


def sort_clusters_fit(k: int) -> bool:
    """Whether the centroid update's sort path can take ``k`` clusters: it
    keeps K + 1 cursors of one lane in a block's shared memory, beside 32
    warp sums."""
    return 4 * (k + 33) <= MAX_SMEM_BYTES


def check_sort_clusters(kernel: str, k: int) -> None:
    """Raise unless :func:`sort_clusters_fit`."""
    if not sort_clusters_fit(k):
        raise TileError(f"{kernel}: k={k} cluster cursors do not fit the "
                        f"block's {MAX_SMEM_BYTES} bytes of shared memory",
                        extent=k, block=MAX_SMEM_BYTES // 4 - 33)


def segment_lanes(d: int) -> int:
    """Lanes that sum one cluster's rows in the sort path: the smallest
    power of two >= ``d``, at most 32 (a warp)."""
    return min(32, 1 << max(0, d - 1).bit_length())


def segment_clusters(d: int) -> int:
    """Clusters per block of the sort path's segmented sum: eight per group
    of ``segment_lanes(d)`` lanes."""
    return 8 * (THREADS // segment_lanes(d))


def tc_dims(d: int) -> int:
    """Dims a tensor-core block stages per point: ``d`` rounded up to whole
    ``TC_CHUNK`` chunks (zero-filled)."""
    return -(-d // TC_CHUNK) * TC_CHUNK


def tc_smem_bytes(d: int) -> int:
    """Shared memory of one tensor-core block (``tc::kSmem`` in
    ``csrc/tc_argmin.cuh``), 199,248 bytes at any ``d``: ``TC_STAGES``
    stages of the centers' and the points' hi and lo chunks with a tile's
    |c|^2, their two mbarriers each, the rows' results and eight warp
    sums."""
    return TC_STAGES * 4 * (4 * TC_COLS * TC_CHUNK + TC_COLS) \
        + 16 * TC_STAGES + 4 * (2 * TC_ROWS + 8)


def tc_work_floats(b: int, m: int, k: int, d: int, shared_x: bool) -> int:
    """Floats of the tensor-core route's device workspace
    (``tc::work_floats``; the launch refuses a smaller one): the centers'
    and the points' TF32 hi and lo planes in whole tiles of ``TC_ROWS``
    rows (the points' once where the lanes share them, ``shared_x``),
    their squared norms and each point tile's lo flag."""
    x_tiles = (1 if shared_x else b) * -(-m // TC_ROWS)
    return ((b * -(-k // TC_COLS) + x_tiles) * TC_ROWS * (2 * tc_dims(d) + 1)
            + x_tiles)


def lloyd_route(k: int, d: int) -> str:
    """The Lloyd kernel's route: ``"tc"`` (tensor cores, three TF32 passes,
    then the centroid update's sort path for the statistics) for d >=
    ``TC_MIN_D`` where the sort path takes K clusters
    (``sort_clusters_fit``) and either the SIMT kernel's (K, d+1)
    accumulator would not fit shared memory or the point would not fit its
    registers (``register_dim`` 0: its scan reads the point from device
    memory for every center); else ``"simt"`` (one fused pass on the FP32
    cores).  Where the accumulator fits at a register width, the fused pass
    measured faster on the H100 than the two passes of the tensor-core
    route (index_200k's coarse merge, (4, 6554, 256, 64)); past d = 128
    the tensor-core route measured faster at small K too (16 x 16,384 x 64,
    d = 256: PERF.md)."""
    return ("tc" if d >= TC_MIN_D and sort_clusters_fit(k)
            and (not acc_in_smem(k, d) or not register_dim(d))
            else "simt")


def assign_route(k: int, d: int) -> str:
    """The assignment kernel's route: ``"tc"`` (the Lloyd kernel's
    tensor-core argmin, three TF32 passes) for d >= ``TC_MIN_D``, else
    ``"simt"`` (FP32 cores)."""
    return "tc" if d >= TC_MIN_D else "simt"


def assign_points(b: int, m: int, d: int, sm_count: int,
                  points: int = 0) -> int:
    """Points per thread of the SIMT assignment: ``ASSIGN_POINTS`` (the
    block-min scan) up to ``register_dim`` ``ASSIGN_TILE_MAX_DIM`` where the
    batch holds ``ASSIGN_ITEMS_PER_SCHEDULER`` items of 32
    ``ASSIGN_POINTS`` points for every warp scheduler of the card; else one
    (the one-pass scan), so a small batch still spreads over the card and
    a wide point keeps its registers.  A requested ``points`` above one
    gives ``ASSIGN_POINTS`` where the register width takes them, else
    one."""
    dp = register_dim(d)
    wide_ok = 0 < dp <= ASSIGN_TILE_MAX_DIM
    if points:
        return ASSIGN_POINTS if points > 1 and wide_ok else 1
    items = (ASSIGN_ITEMS_PER_SCHEDULER * SM_SCHEDULERS * sm_count * 32
             * ASSIGN_POINTS)
    return ASSIGN_POINTS if wide_ok and b * m >= items else 1


def assign_blocks(b: int, m: int, points: int, per_sm: int,
                  sm_count: int, blocks: int = 0) -> int:
    """Blocks per batch entry of the SIMT assignment: a warp's work item is
    32 ``points`` points, item i goes to block i % G, and G is the most
    that hold all ``b`` entries' blocks on the card at once (``per_sm``
    blocks on each of ``sm_count`` SMs), but no more than the entry has
    items; a requested ``blocks`` is clamped to that."""
    most = max(1, min(-(-m // (32 * points)), per_sm * sm_count // b))
    return min(blocks, most) if blocks else most


def lloyd_simt_reserved_bytes(k: int, d: int) -> int:
    """Shared memory of one SIMT Lloyd block beside its staged centers: the
    tile's ids, weights and owner masks, eight warp sums, and the
    accumulator when it fits."""
    return (4 * ((2 + WARPS) * THREADS + WARPS)
            + (4 * k * (d + 1) if acc_in_smem(k, d) else 0))


def lloyd_simt_smem_bytes(k: int, d: int, tile: int = 0) -> int:
    """Shared memory of one SIMT Lloyd block (``simt_smem`` in
    ``csrc/lloyd.cu``) at center tile ``tile`` (0: :func:`center_tile`):
    the staged centers and :func:`lloyd_simt_reserved_bytes`."""
    return (4 * (tile or center_tile(k, d)) * center_stride(d)
            + lloyd_simt_reserved_bytes(k, d))


def blocks_per_sm(smem: int, threads: int = THREADS) -> int:
    """Blocks of ``threads`` threads and ``smem`` bytes of shared memory
    that one SM holds at once, by shared memory and threads (registers
    aside: the runtime's occupancy, which ``lloyd_blocks`` is given, counts
    them too)."""
    return max(1, min(SM_SMEM_BYTES // (smem + SMEM_RESERVED_BYTES),
                      SM_THREADS // threads))


def lloyd_blocks(b: int, m: int, k: int, d: int, sm_count: int,
                 per_sm: int, blocks: int = 0) -> int:
    """Blocks per batch entry of the SIMT Lloyd kernel.  At most as many as
    hold all ``b`` entries' blocks on the card at once (``per_sm`` blocks
    on each of ``sm_count`` SMs: no partial second wave) and as keep the
    (B, G, K, d+1) partials within ``SCRATCH_BYTES``; within that, the
    fewest blocks that take the most tiles any block must, so every block
    walks the same number of tiles (but the last).  A requested ``blocks``
    is clamped to that most."""
    tiles = -(-m // THREADS)
    most = max(1, min(tiles, per_sm * sm_count // b,
                      SCRATCH_BYTES // (4 * b * k * (d + 1))))
    if blocks:
        return min(blocks, most)
    return -(-tiles // -(-tiles // most))


class LloydPlan(NamedTuple):
    """A SIMT Lloyd launch: ``center_tile`` centers staged at a time,
    ``blocks`` per batch entry."""
    center_tile: int
    blocks: int


def lloyd_plan(b: int, m: int, k: int, d: int, sm_count: int, occupancy,
               tile: int = 0, blocks: int = 0) -> LloydPlan:
    """The SIMT Lloyd launch at a requested center ``tile`` and ``blocks``
    (0: the formulas), where ``occupancy(tile)`` gives the blocks one SM
    holds at that tile."""
    bk = clamp_center_tile(k, d, tile, lloyd_simt_reserved_bytes(k, d))
    return LloydPlan(bk, lloyd_blocks(b, m, k, d, sm_count, occupancy(bk),
                                      blocks))


class AssignPlan(NamedTuple):
    """A SIMT assignment launch: ``center_tile`` centers staged at a time,
    ``points`` per thread, ``blocks`` per batch entry."""
    center_tile: int
    points: int
    blocks: int


def assign_plan(b: int, m: int, k: int, d: int, sm_count: int, occupancy,
                tile: int = 0, points: int = 0, blocks: int = 0
                ) -> AssignPlan:
    """The SIMT assignment launch at a requested center ``tile``,
    ``points`` and ``blocks`` (0: the formulas), where
    ``occupancy(tile, wide)`` gives the blocks one SM holds at that tile
    with the wide register tile (4 points) or without."""
    bk = clamp_center_tile(k, d, tile)
    p = assign_points(b, m, d, sm_count, points)
    return AssignPlan(bk, p, assign_blocks(b, m, p, occupancy(bk, p > 1),
                                           sm_count, blocks))


def scan_smem_bytes(m: int, c: int, dtype: torch.dtype = torch.float32
                    ) -> int:
    """Shared memory of one ADC-scan block: the (m, C) lookup table in the
    table's own type."""
    return m * c * (torch.finfo(dtype).bits // 8)


def scan_vector_table(ptr: int, batch_stride_bytes: int,
                      table_bytes: int) -> bool:
    """Whether the ADC scan stages its tables 16 bytes at a time: every
    table starts on a 16-byte boundary and is a whole number of 16 bytes
    (else one element at a time)."""
    return not (ptr % 16 or batch_stride_bytes % 16 or table_bytes % 16)


class ScanPlan(NamedTuple):
    """An ADC-scan launch: ``blocks`` per batch entry, block g walking the
    entry's ``THREADS``-row tiles g, g + G, ...; ``waves`` of blocks over
    the card's ``per_sm * sm_count`` resident slots."""
    blocks: int
    waves: int


def scan_plan(b: int, l: int, per_sm: int, sm_count: int,
              blocks: int = 0) -> ScanPlan:
    """The ADC scan's launch for ``b`` entries of ``l`` rows when ``per_sm``
    blocks fit one SM: as many blocks per entry as fit the card at once for
    all entries (one wave), no more than an entry has tiles; a requested
    ``blocks`` is clamped to that."""
    slots = per_sm * sm_count
    g = max(1, min(-(-l // THREADS), slots // b))
    if blocks:
        g = min(blocks, g)
    return ScanPlan(g, -(-(b * g) // slots))


def code_vector_bytes(m: int, ptr: int, batch_stride: int) -> int:
    """Bytes per code load of the ADC scan: 16 (``uint4``) or 4 when every
    candidate row of ``m`` uint8 codes starts at such a multiple, else 1."""
    for v in (16, 4):
        if m % v == 0 and ptr % v == 0 and batch_stride % v == 0:
            return v
    return 1


def attn_pieces(dh: int, dtype: torch.dtype) -> int:
    """16-byte pieces in one centroid row of ``dh`` values (the layout rule
    makes the row a whole number of them)."""
    return dh * (torch.finfo(dtype).bits // 8) // 16


def attn_lanes_per_row(dh: int, dtype: torch.dtype) -> int:
    """Lanes that share one centroid row of the cluster attention: the
    row's :func:`attn_pieces` rounded up to a power of two (the shuffle
    reductions run over a power-of-two group of lanes).  Lane ``e`` loads
    piece ``e``; a lane past the row's pieces (dh = 80 in bf16: 10 pieces
    on 16 lanes) loads nothing and adds 0."""
    pieces = attn_pieces(dh, dtype)
    return 1 << max(0, pieces - 1).bit_length()


def attn_splits(b: int, hkv: int, nc: int, sm_count: int) -> tuple[int, int]:
    """``(S, chunk)``: the cluster attention splits each (batch, kv head)'s
    ``nc`` centroids into S blocks of ``chunk``: at most
    ``ATTN_BLOCKS_PER_SM`` blocks on every SM (one wave), none with fewer
    than ``ATTN_MIN_ROWS`` or more than ``ATTN_MAX_ROWS`` centroids (but at
    least one split)."""
    s = max(1, min(ATTN_BLOCKS_PER_SM * sm_count // (b * hkv),
                   nc // ATTN_MIN_ROWS), -(-nc // ATTN_MAX_ROWS))
    chunk = -(-nc // s)
    return -(-nc // chunk), chunk


def attn_stage_rows(dh: int, dtype: torch.dtype) -> int:
    """Centroid rows per shared-memory stage of the cluster attention: the
    key and value rows of a stage fill ``ATTN_STAGE_BYTES``."""
    row = dh * (torch.finfo(dtype).bits // 8)
    return max(1, ATTN_STAGE_BYTES // (2 * row))


def _check_tensors(kernel: str, named, dtypes, device) -> None:
    """Each ``(name, t)`` is a tensor of one of ``dtypes`` on ``device``."""
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{kernel}: {name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.dtype not in dtypes:
            raise TypeError(f"{kernel}: {name} must be one of "
                            f"{[str(d) for d in dtypes]}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, the first "
                             f"input on {device}")


def _check_batch(kernel: str, b: int) -> None:
    if b > MAX_BATCH:
        raise TileError(f"{kernel}: batch {b} exceeds the grid's "
                        f"{MAX_BATCH}", extent=b, block=MAX_BATCH)


def _check_rows(kernel: str, name: str, t, n: int, width: int) -> None:
    """Rows of ``width`` elements of a (B, n, width) tensor are contiguous
    (the batch stride is free)."""
    if (width > 1 and t.stride(2) != 1) or (n > 1 and t.stride(1) != width):
        raise ValueError(f"{kernel}: {name} rows must be contiguous "
                         f"(strides {t.stride()})")


def _check_vector(kernel: str, name: str, t, shape: tuple) -> None:
    """``t`` is (B, M) with contiguous rows."""
    if tuple(t.shape) != shape:
        raise ValueError(f"{kernel}: {name} must be {shape}, got "
                         f"{tuple(t.shape)}")
    if shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{kernel}: {name} rows must be contiguous (strides "
                         f"{t.stride()})")


def check_inputs(kernel: str, x, c, w=None) -> tuple[int, int, int, int]:
    """Validate a kernel call: ``x`` (B, M, d), ``c`` (B, K, d) and ``w``
    (B, M), each f32 or bf16, on one device, each row contiguous (the batch
    stride is free, so ``expand`` may share one point set across restarts).
    Returns ``(B, M, K, d)``; raises ``TypeError`` / ``ValueError`` /
    :class:`TileError` on anything else."""
    named = [("x", x), ("c", c)] + ([("w", w)] if w is not None else [])
    _check_tensors(kernel, named, FLOATS, x.device)
    if x.dim() != 3 or c.dim() != 3:
        raise ValueError(f"{kernel}: x must be (B, M, d) and c (B, K, d), "
                         f"got {tuple(x.shape)} and {tuple(c.shape)}")
    b, m, d = x.shape
    k = c.shape[1]
    if c.shape[0] != b or c.shape[2] != d:
        raise ValueError(f"{kernel}: c {tuple(c.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if w is not None:
        _check_vector(kernel, "w", w, (b, m))
    if min(b, m, k, d) < 1:
        raise ValueError(f"{kernel}: empty input (B, M, K, d) = "
                         f"{(b, m, k, d)}")
    _check_batch(kernel, b)
    _check_rows(kernel, "x", x, m, d)
    _check_rows(kernel, "c", c, k, d)
    return b, m, k, d


def check_update_inputs(kernel: str, x, idx, w, k: int
                        ) -> tuple[int, int, int]:
    """Validate a centroid-update call: ``x`` (B, M, d) f32/bf16 with
    contiguous rows, ``idx`` (B, M) int32 and ``w`` (B, M) f32/bf16 with
    contiguous rows, one device, ``k >= 1``.  Returns ``(B, M, d)``."""
    _check_tensors(kernel, [("x", x), ("w", w)], FLOATS, x.device)
    _check_tensors(kernel, [("idx", idx)], (torch.int32,), x.device)
    if x.dim() != 3:
        raise ValueError(f"{kernel}: x must be (B, M, d), got "
                         f"{tuple(x.shape)}")
    b, m, d = x.shape
    _check_vector(kernel, "idx", idx, (b, m))
    _check_vector(kernel, "w", w, (b, m))
    if min(b, m, k, d) < 1:
        raise ValueError(f"{kernel}: empty input (B, M, k, d) = "
                         f"{(b, m, k, d)}")
    _check_batch(kernel, b)
    _check_rows(kernel, "x", x, m, d)
    return b, m, d


def check_scan_inputs(kernel: str, luts, codes) -> tuple[int, int, int, int]:
    """Validate an ADC-scan call: ``luts`` (B, m, C) f32/bf16, each (m, C)
    table contiguous, ``C <= 256``; ``codes`` (B, L, m) uint8 with
    contiguous rows; one device; the table fits a block's shared memory.
    Returns ``(B, L, m, C)``."""
    _check_tensors(kernel, [("luts", luts)], FLOATS, luts.device)
    _check_tensors(kernel, [("codes", codes)], (torch.uint8,), luts.device)
    if luts.dim() != 3 or codes.dim() != 3:
        raise ValueError(f"{kernel}: luts must be (B, m, C) and codes "
                         f"(B, L, m), got {tuple(luts.shape)} and "
                         f"{tuple(codes.shape)}")
    b, m, c = luts.shape
    l = codes.shape[1]
    if codes.shape[0] != b or codes.shape[2] != m:
        raise ValueError(f"{kernel}: codes {tuple(codes.shape)} do not "
                         f"match luts {tuple(luts.shape)}")
    if min(b, l, m, c) < 1 or c > 256:
        raise ValueError(f"{kernel}: need B, L, m >= 1 and 1 <= C <= 256 "
                         f"(uint8 codes), got (B, L, m, C) = {(b, l, m, c)}")
    _check_batch(kernel, b)
    smem = scan_smem_bytes(m, c, luts.dtype)
    if smem > MAX_SMEM_BYTES:
        raise TileError(f"{kernel}: an (m, C) = {(m, c)} {luts.dtype} table "
                        f"takes {smem} bytes of shared memory, above the "
                        f"block's {MAX_SMEM_BYTES}", extent=smem,
                        block=MAX_SMEM_BYTES)
    _check_rows(kernel, "luts", luts, m, c)
    _check_rows(kernel, "codes", codes, l, m)
    return b, l, m, c


def check_attn_inputs(kernel: str, q, kc, vc, counts
                      ) -> tuple[int, int, int, int, int]:
    """Validate a cluster-attention call: ``q`` (B, H, dh) f32/bf16 with
    contiguous head rows; ``kc`` and ``vc`` (B, Hkv, Nc, dh), both f32 or
    both bf16, rows contiguous and every row 16-byte aligned; ``counts``
    (B, Hkv, Nc) f32 with contiguous rows; one device; ``H % Hkv == 0``
    with at most ``ATTN_MAX_GROUP`` query heads per kv head; a row of
    ``dh`` values a whole number of 16-byte pieces, at most 32 (each lane
    of a row's group loads one piece).
    Returns ``(B, H, Hkv, Nc, dh)``."""
    _check_tensors(kernel, [("q", q), ("kc", kc), ("vc", vc)], FLOATS,
                   q.device)
    _check_tensors(kernel, [("counts", counts)], (torch.float32,), q.device)
    if q.dim() != 3 or kc.dim() != 4 or counts.dim() != 3:
        raise ValueError(f"{kernel}: q must be (B, H, dh), kc and vc "
                         f"(B, Hkv, Nc, dh), counts (B, Hkv, Nc); got "
                         f"{tuple(q.shape)}, {tuple(kc.shape)}, "
                         f"{tuple(counts.shape)}")
    b, h, dh = q.shape
    hkv, nc = kc.shape[1], kc.shape[2]
    if (tuple(kc.shape) != (b, hkv, nc, dh) or vc.shape != kc.shape
            or tuple(counts.shape) != (b, hkv, nc)):
        raise ValueError(f"{kernel}: shapes do not match: q {tuple(q.shape)}, "
                         f"kc {tuple(kc.shape)}, vc {tuple(vc.shape)}, "
                         f"counts {tuple(counts.shape)}")
    if vc.dtype != kc.dtype:
        raise TypeError(f"{kernel}: kc is {kc.dtype} but vc {vc.dtype}")
    if min(b, h, hkv, nc, dh) < 1 or h % hkv:
        raise ValueError(f"{kernel}: need B, H, Hkv, Nc, dh >= 1 and "
                         f"H % Hkv == 0, got (B, H, Hkv, Nc, dh) = "
                         f"{(b, h, hkv, nc, dh)}")
    if h // hkv > ATTN_MAX_GROUP:
        raise TileError(f"{kernel}: {h // hkv} query heads per kv head, "
                        f"above the kernel's {ATTN_MAX_GROUP}",
                        extent=h // hkv, block=ATTN_MAX_GROUP)
    if dh * kc.element_size() % 16 or attn_pieces(dh, kc.dtype) > 32:
        raise TileError(f"{kernel}: a row of dh={dh} {kc.dtype} values must "
                        f"be a whole number of 16-byte pieces, at most 32",
                        extent=dh, block=16 // kc.element_size())
    _check_batch(kernel, b)
    if q.stride(2) != 1:
        raise ValueError(f"{kernel}: q rows must be contiguous (strides "
                         f"{q.stride()})")
    for name, t in (("kc", kc), ("vc", vc)):
        if t.stride(3) != 1 or (nc > 1 and t.stride(2) != dh):
            raise ValueError(f"{kernel}: {name} rows must be contiguous "
                             f"(strides {t.stride()})")
        es = t.element_size()
        if t.data_ptr() % 16 or (t.stride(0) * es) % 16 or (
                t.stride(1) * es) % 16:
            raise ValueError(f"{kernel}: {name} rows must start on 16-byte "
                             f"boundaries (strides {t.stride()})")
    if nc > 1 and counts.stride(2) != 1:
        raise ValueError(f"{kernel}: counts rows must be contiguous (strides "
                         f"{counts.stride()})")
    return b, h, hkv, nc, dh
