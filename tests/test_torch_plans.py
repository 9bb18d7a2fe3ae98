"""The launch plans of the port's assignment and ADC-scan kernels, and the
assignment kernel's block-min argmin emulated in plain PyTorch, on the
CPU.  The kernels run only on the card (tests/test_torch_cuda.py,
chip_smoke.py); what decides their grids and their answers at ties is
held here."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import tiles
from repro_torch.kernels.ref import assign_argmin_ref

SMS = 132     # the H100's SMs


# ---------------------------------------------------------------------------
# ADC scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,l,per_sm", [
    (128, 1586, 3),        # index_200k at nprobe = 2
    (128, 19792, 6),       # index_5m
    (1, 1_000_000, 6),     # one entry spread over the card
    (300, 40, 6),          # more entries than SMs, each under one tile
    (1000, 50, 1),         # more entries than the card holds at once
    (7, 1, 6),             # one row
    (5, 2049, 3),          # ragged: eight tiles and one row
])
def test_scan_plan_one_wave_tiles_once(b, l, per_sm):
    """One wave wherever the entries fit the card (else one block per
    entry); no more blocks than tiles; block g's tiles g, g + G, ... cover
    an entry's tiles exactly once, each block walking as many as any other
    within one, and the tiles cover the ragged rows once."""
    p = tiles.scan_plan(b, l, per_sm, SMS)
    slots = per_sm * SMS
    n_tiles = -(-l // tiles.THREADS)
    assert 1 <= p.blocks <= n_tiles
    if b <= slots:
        assert b * p.blocks <= slots and p.waves == 1
    else:
        assert p.blocks == 1 and p.waves == -(-b // slots)
    walked = [list(range(g, n_tiles, p.blocks)) for g in range(p.blocks)]
    assert sorted(sum(walked, [])) == list(range(n_tiles))
    counts = [len(w) for w in walked]
    assert max(counts) - min(counts) <= 1 and min(counts) >= 1
    rows = np.zeros(l, np.int64)
    for tile in range(n_tiles):
        rows[tile * tiles.THREADS:(tile + 1) * tiles.THREADS] += 1
    assert (rows == 1).all()


@pytest.mark.parametrize("m,c,dtype,per_sm", [
    (64, 256, torch.float32, 3),     # index_200k: 64 KB
    (32, 256, torch.float32, 6),     # index_5m: 32 KB
    (64, 256, torch.bfloat16, 6),    # bf16 stays bf16: half the bytes
    (200, 256, torch.float32, 1),    # 200 KB: one block per SM
])
def test_scan_plan_within_shared_memory(m, c, dtype, per_sm):
    """The table in its own type fits a block; the blocks per SM that the
    shared memory and the threads allow (the runtime's occupancy, which
    also counts registers, is checked on the card) give a wave whose
    tables all fit the SM at once."""
    smem = tiles.scan_smem_bytes(m, c, dtype)
    assert smem == m * c * (2 if dtype == torch.bfloat16 else 4)
    assert smem <= tiles.MAX_SMEM_BYTES
    assert tiles.blocks_per_sm(smem) == per_sm
    assert per_sm * (smem + tiles.SMEM_RESERVED_BYTES) <= tiles.SM_SMEM_BYTES


@pytest.mark.parametrize("ptr,stride,nbytes,vec", [
    (0, 65536, 65536, True), (16, 32768, 32768, True),
    (4, 65536, 65536, False),       # table not on a 16-byte boundary
    (0, 60, 60, False),             # (3, 5) f32 tables: 60 bytes each
    (0, 1024, 1000, False)])
def test_scan_vector_table(ptr, stride, nbytes, vec):
    assert tiles.scan_vector_table(ptr, stride, nbytes) is vec


# ---------------------------------------------------------------------------
# assignment: plan, tile, route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,m,points,per_sm", [
    (1, 500_000, 4, 4),     # predict
    (2, 5000, 1, 8),        # a small batch, one point per thread
    (64, 7813, 4, 4),       # the cuda backend's local stage
    (4, 99968, 4, 4),       # its merge
    (1, 3392, 1, 4),        # few points: fewer items than slots
    (200, 100, 4, 8),       # more entries than SMs
    (1000, 33, 4, 1),       # more entries than the card holds at once
    (3, 1, 4, 6)])          # one point
def test_assign_plan_items_once(b, m, points, per_sm):
    """A warp's item is 32 P points; item i goes to block i % G, warp
    (i // G) % 8, round (i // G) // 8.  Every item of an entry lands once,
    the blocks' shares differ by at most one item, the blocks fill one
    wave where the entries fit the card, and the items' points cover
    [0, M) once (the ragged tail masked)."""
    g = tiles.assign_blocks(b, m, points, per_sm, SMS)
    items = -(-m // (32 * points))
    slots = per_sm * SMS
    assert 1 <= g <= max(1, items)
    if b <= slots:
        assert b * g <= slots
    warps = tiles.THREADS // 32
    rounds = -(-items // (g * warps))
    seen = {}
    for r in range(rounds):
        for blk in range(g):
            for w in range(warps):
                item = blk + g * (w + warps * r)
                if item < items:
                    assert item not in seen
                    seen[item] = blk
    assert sorted(seen) == list(range(items))
    shares = np.bincount(list(seen.values()), minlength=g)
    assert shares.max() - shares.min() <= 1
    pts = np.array([i * 32 * points + 32 * p + lane for i in range(items)
                    for p in range(points) for lane in range(32)])
    assert np.array_equal(np.sort(pts[pts < m]), np.arange(m))


@pytest.mark.parametrize("b,m,d,points", [
    (1, 500_000, 2, 4),      # predict
    (64, 7813, 2, 4),        # the cuda backend's local stage
    (64, 32768, 1, 4),       # the PQ codebooks
    (1, 135_168, 16, 4),     # two 128-point items per scheduler
    (1, 135_167, 16, 1),     # fewer: one point per thread
    (2, 5000, 8, 1),
    (1, 500_000, 17, 1),     # a wider point keeps its registers
    (1, 500_000, 200, 1)])   # the point read from device memory
def test_assign_points(b, m, d, points):
    assert tiles.assign_points(b, m, d, SMS) == points


@pytest.mark.parametrize("k,d,route", [
    (256, 64, "tc"),      # index_200k's routing of chunks to cells
    (512, 32, "tc"),      # index_5m's
    (819, 64, "tc"), (1000, 2, "simt"), (1562, 2, "simt"), (256, 1, "simt"),
    (77, 16, "simt"), (50, 31, "simt"),
    (50, 200, "tc"),      # past d = 128 the block streams its points
    (1000, 256, "tc")])   # the d = 256 assignment
def test_assign_route(k, d, route):
    assert tiles.assign_route(k, d) == route
    if route == "tc":
        assert tiles.tc_smem_bytes(d) <= tiles.MAX_SMEM_BYTES


# ---------------------------------------------------------------------------
# the split-stream argmin, emulated
# ---------------------------------------------------------------------------

def _plain_raw(x, c):
    """assign_argmin_ref's distances before their clamp at 0: the cross
    term one coordinate at a time, then |x|^2 + |c|^2 - 2 x.c."""
    xc = torch.zeros((x.shape[0], x.shape[1], c.shape[1]))
    for j in range(x.shape[2]):
        xc += x[:, :, j, None] * c[:, None, :, j]
    return ((x * x).sum(-1, keepdim=True) + (c * c).sum(-1)[:, None, :]
            - 2.0 * xc)


def _block_min_argmin(raw, q_streams, bk, block):
    """The SIMT assignment kernel's scan of one point's centers, on their
    unclamped distances: staged tiles of ``bk`` centers, each in blocks of
    ``block``; in a full block center kk goes to stream kk % Q, in a short
    one to stream 0; a stream keeps a running min; at a block's end the
    streams' mins are combined, clamped at 0 and compared with the point's
    best by a strict <, and at a tile's end a point whose best fell in it
    takes the first center of that block whose clamped distance equals
    best."""
    b, m, k = raw.shape
    d2 = raw.clamp_min(0.0)
    best = torch.full((b, m), float("inf"))
    best_k = torch.zeros((b, m), dtype=torch.long)
    for k0 in range(0, k, bk):
        nk = min(bk, k - k0)
        blk = torch.full((b, m), -1, dtype=torch.long)
        for kb in range(0, nk, block):
            nb = min(block, nk - kb)
            bm = torch.full((q_streams, b, m), float("inf"))
            for kk in range(nb):
                q = kk % q_streams if nb == block else 0
                bm[q] = torch.minimum(bm[q], raw[:, :, k0 + kb + kk])
            low = bm.amin(0).clamp_min(0.0)
            fell = low < best
            best = torch.where(fell, low, best)
            blk = torch.where(fell, torch.full_like(blk, k0 + kb), blk)
        for i, j in (blk >= 0).nonzero().tolist():
            start = int(blk[i, j])
            end = min(start + block, k0 + nk)
            row = d2[i, j, start:end]
            best_k[i, j] = start + int((row == best[i, j]).nonzero()[0, 0])
    return best_k.to(torch.int32), best


def _tie_case(name):
    rng = np.random.default_rng(41)
    if name == "coincident":          # copies of one center, points on it
        x = rng.random((2, 101, 2)).astype(np.float32)
        c = rng.random((2, 13, 2)).astype(np.float32)
        c[:, [5, 9, 12]] = c[:, 2:3]
        x[:, :30] = c[:, 2:3]
    elif name == "zero_centers":      # every distance ties
        x = rng.random((2, 77, 3)).astype(np.float32)
        c = np.zeros((2, 9, 3), np.float32)
    elif name == "cancel":            # far from 0, centers a hair apart:
        # the expanded form's rounding exceeds the true distances, so the
        # unclamped values of several centers fall below 0 unequally
        x = (1000 + rng.random((2, 64, 2))).astype(np.float32)
        c = (x[:, :1] + 1e-3 * rng.normal(size=(2, 12, 2))).astype(np.float32)
        x[:, 1:32] = x[:, :1] + 1e-3 * rng.normal(size=(2, 31, 2))
    elif name == "lattice":           # small integers: many exact ties
        x = rng.integers(0, 4, (3, 129, 2)).astype(np.float32)
        c = rng.integers(0, 4, (3, 11, 2)).astype(np.float32)
    else:                             # ragged M, K prime, wide d
        x = rng.normal(size=(1, 97, 16)).astype(np.float32)
        c = rng.normal(size=(1, 31, 16)).astype(np.float32)
        c[0, 20] = c[0, 3]
    return torch.from_numpy(x), torch.from_numpy(c)


@pytest.mark.parametrize("q_streams,bk,block", [
    (4, 1000, 32),      # the kernel's: every center resident
    (4, 100, 32),       # staged tiles, a short block at each tile's end
    (2, 7, 4), (1, 1000, 32), (3, 13, 6), (4, 1000, 8)])
@pytest.mark.parametrize("case", ["coincident", "zero_centers", "lattice",
                                  "ragged", "cancel"])
def test_block_min_argmin_equals_plain(case, q_streams, bk, block):
    """Running mins of the unclamped distances in Q interleaved streams per
    block, the clamp and a strict-< compare per block and the first center
    of the winning block at the best distance give exactly the plain
    version's answer (the first index of the minimum) and distance, on
    tie-heavy inputs (coincident points and centers, whose unclamped
    distances fall below 0), with K not a multiple of the block or of Q,
    in resident and in staged center tiles."""
    x, c = _tie_case(case)
    ridx, rdist = assign_argmin_ref(x, c)
    idx, dist = _block_min_argmin(_plain_raw(x, c), q_streams, bk, block)
    assert torch.equal(idx, ridx)
    assert torch.equal(dist, rdist)
    if case == "zero_centers":
        assert not idx.any()
