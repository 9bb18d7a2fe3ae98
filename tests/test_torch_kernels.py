"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package's Pallas kernels (interpret mode) and its jnp oracles, at the
tolerances of tests/test_lloyd.py; plus the wrappers' input contract and the
tile contract.  The CUDA kernels themselves are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import assign_argmin as jax_assign
from repro.kernels import lloyd_step as jax_lloyd
from repro.kernels.ref import lloyd_step_ref as jax_lloyd_ref
from repro_torch.kernels import TileError, assign_argmin, lloyd_step, tiles
from repro_torch.kernels.ref import (assign_argmin_ref, centroid_update_ref,
                                     lloyd_step_ref)

# ragged M / d / K on purpose (tests/test_lloyd.py's sweep)
SHAPES = [(64, 4, 3), (257, 16, 7), (100, 33, 17), (512, 128, 300),
          (1024, 2, 128), (300, 256, 40)]


def _inputs(seed, m, d, k, b=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, m, d)).astype(np.float32)
    c = rng.normal(size=(b, k, d)).astype(np.float32)
    w = rng.uniform(0, 1, (b, m)).astype(np.float32)
    return x, c, w


def _check_lloyd(got, want, rtol=1e-4):
    sums, counts, sse, idx, dist = (np.asarray(t) for t in got)
    rsums, rcounts, rsse, ridx, rdist = (np.asarray(t) for t in want)
    np.testing.assert_allclose(sums, rsums, rtol=rtol, atol=rtol)
    np.testing.assert_allclose(counts, rcounts, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sse, rsse, rtol=rtol)
    np.testing.assert_allclose(dist, rdist, rtol=rtol, atol=rtol)
    # argmin ties can break differently under reordered arithmetic
    assert (idx == ridx).mean() > 0.99


@pytest.mark.parametrize("m,d,k", SHAPES)
def test_lloyd_step_matches_jax_kernel_and_oracle(m, d, k):
    x, c, w = _inputs(m * 7 + k, m, d, k)
    got = [t[0] for t in lloyd_step(torch.from_numpy(x),
                                    torch.from_numpy(w),
                                    torch.from_numpy(c))]
    args = (jnp.asarray(x[0]), jnp.asarray(w[0]), jnp.asarray(c[0]))
    _check_lloyd(got, jax_lloyd(*args))
    _check_lloyd(got, jax_lloyd_ref(*args))


@pytest.mark.parametrize("m,d,k", SHAPES)
def test_assign_matches_jax_kernel(m, d, k):
    x, c, _ = _inputs(m + 3 * k, m, d, k)
    idx, dist = assign_argmin(torch.from_numpy(x), torch.from_numpy(c))
    ridx, rdist = jax_assign(jnp.asarray(x[0]), jnp.asarray(c[0]))
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32
    np.testing.assert_allclose(dist[0].numpy(), np.asarray(rdist),
                               rtol=1e-4, atol=1e-4)
    assert (idx[0].numpy() == np.asarray(ridx)).mean() > 0.99


def test_lloyd_step_batched_lanes_match_jax():
    """B=3 lanes in one call equal three separate reference calls."""
    x, c, w = _inputs(5, 300, 6, 9, b=3)
    got = lloyd_step(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(c))
    for lane in range(3):
        want = jax_lloyd_ref(jnp.asarray(x[lane]), jnp.asarray(w[lane]),
                             jnp.asarray(c[lane]))
        _check_lloyd([t[lane] for t in got], want)


def test_lloyd_step_zero_weight_rows_excluded():
    """Rows with w=0 (capacity padding) contribute to no statistic but
    still get idx/dist."""
    m, d, k = 96, 5, 6
    x, c, _ = _inputs(11, m, d, k)
    x[0, m // 2:] = 1e4        # junk that would wreck sums/sse if counted
    w = np.concatenate([np.ones(m // 2), np.zeros(m - m // 2)]
                       ).astype(np.float32)[None]
    sums, counts, sse, idx, dist = lloyd_step(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(c))
    want = jax_lloyd_ref(jnp.asarray(x[0, :m // 2]), jnp.asarray(w[0, :m // 2]),
                         jnp.asarray(c[0]))
    np.testing.assert_allclose(sums[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(counts[0].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(sse[0]), float(want[2]), rtol=1e-4)
    assert torch.isfinite(dist).all() and idx.shape == (1, m)


def test_lloyd_step_bf16_inputs():
    """bf16 points/centers (and weights) accumulate in fp32."""
    x, c, w = _inputs(13, 200, 9, 11)
    xb, cb = torch.from_numpy(x).bfloat16(), torch.from_numpy(c).bfloat16()
    got = lloyd_step(xb, torch.from_numpy(w).bfloat16(), cb)
    assert all(t.dtype == torch.float32 for t in got[:3])
    want = jax_lloyd_ref(jnp.asarray(x[0], jnp.bfloat16),
                         jnp.asarray(w[0], jnp.bfloat16),
                         jnp.asarray(c[0], jnp.bfloat16))
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(want[0]),
                               rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(got[1][0].numpy(), np.asarray(want[1]),
                               rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(float(got[2][0]), float(want[2]), rtol=5e-2)


def test_exact_ties_go_to_the_lowest_index():
    """Equidistant centers (exact in fp32) and duplicated centers: the
    lowest center index wins, as in the JAX kernels."""
    x = torch.tensor([[[0.0, 0.0], [2.0, 0.0], [5.0, 5.0]]])
    c = torch.tensor([[[1.0, 0.0], [-1.0, 0.0], [5.0, 5.0], [5.0, 5.0],
                       [3.0, 0.0]]])
    idx, dist = assign_argmin(x, c)
    assert idx[0].tolist() == [0, 0, 2]
    assert dist[0].tolist() == [1.0, 1.0, 0.0]
    ridx, _ = jax_assign(jnp.asarray(x[0].numpy()), jnp.asarray(c[0].numpy()))
    assert np.asarray(ridx).tolist() == [0, 0, 2]
    w = torch.ones(1, 3)
    assert lloyd_step(x, w, c)[3][0].tolist() == [0, 0, 2]


def test_restart_lanes_may_share_one_point_set():
    """A batch stride of 0 (``expand``) is accepted: restarts share a pool
    without copying it."""
    x, c, w = _inputs(17, 50, 3, 4, b=1)
    xs, ws = torch.from_numpy(x), torch.from_numpy(w)
    cs = torch.from_numpy(np.concatenate([c, c + 1.0]))
    shared = lloyd_step(xs.expand(2, -1, -1), ws.expand(2, -1), cs)
    copied = lloyd_step(xs.repeat(2, 1, 1), ws.repeat(2, 1), cs)
    for a, b in zip(shared, copied):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad,err", [
    (lambda x, w, c: (x.double(), w, c), TypeError),
    (lambda x, w, c: (x, w.int(), c), TypeError),
    (lambda x, w, c: (x[0], w, c), ValueError),
    (lambda x, w, c: (x, w, c[:, :, :2]), ValueError),
    (lambda x, w, c: (x, w[:, :5], c), ValueError),
    (lambda x, w, c: (x.transpose(1, 2).contiguous().transpose(1, 2), w, c),
     ValueError),
    (lambda x, w, c: (x, w, c[:, :0]), ValueError),
])
def test_wrappers_reject_inputs_outside_the_contract(bad, err):
    x, c, w = (torch.from_numpy(a) for a in _inputs(1, 20, 3, 4))
    xb, wb, cb = bad(x, w, c)
    with pytest.raises(err):
        lloyd_step(xb, wb, cb)
    if wb is w:
        with pytest.raises(err):
            assign_argmin(xb, cb)


def test_centroid_update_ref_matches_one_hot():
    x, c, w = _inputs(3, 40, 3, 5, b=2)
    idx = torch.randint(0, 5, (2, 40), generator=torch.Generator().manual_seed(0))
    sums, counts = centroid_update_ref(torch.from_numpy(x), idx,
                                       torch.from_numpy(w), 5)
    onehot = torch.nn.functional.one_hot(idx.long(), 5).float() \
        * torch.from_numpy(w)[..., None]
    torch.testing.assert_close(sums, onehot.transpose(1, 2) @ torch.from_numpy(x))
    torch.testing.assert_close(counts, onehot.sum(1))
    ridx, rdist = assign_argmin_ref(torch.from_numpy(x), torch.from_numpy(c))
    assert ridx.shape == (2, 40) and rdist.min() >= 0
    # f64 inputs keep f64 (the exact reference the on-card check uses)
    s64, c64 = centroid_update_ref(torch.from_numpy(x).double(), idx,
                                   torch.from_numpy(w).double(), 5)
    assert s64.dtype == c64.dtype == torch.float64
    torch.testing.assert_close(
        s64, onehot.double().transpose(1, 2) @ torch.from_numpy(x).double())


def test_tile_contract():
    assert [tiles.register_dim(d) for d in (1, 2, 3, 16, 33, 128, 129)] == \
        [2, 2, 4, 16, 64, 128, 0]
    assert tiles.center_stride(2) == 4 and tiles.center_stride(200) == 201
    assert tiles.center_tile(1562, 2) == 1562          # the paper's shapes:
    assert tiles.center_tile(1000, 2) == 1000          # one resident tile
    assert 1 <= tiles.center_tile(10 ** 6, 64) < 10 ** 6
    assert tiles.acc_in_smem(1562, 2) and not tiles.acc_in_smem(1000, 64)
    # local stage: 64 partitions of 7813 slots on 132 SMs, 4 blocks each
    g = tiles.lloyd_blocks(64, 7813, 1562, 2, 132, 4)
    assert 1 <= g <= -(-7813 // tiles.THREADS)
    assert tiles.lloyd_blocks(1, 10, 5, 2, 132, 4) == 1  # at most its tiles
    # the centroid update's sort path: K + 1 cursors in one block's smem
    tiles.check_sort_clusters("k", 8192)
    with pytest.raises(TileError):
        tiles.check_sort_clusters("k", 60000)
    with pytest.raises(TileError):
        tiles.center_tile(4, 20000)
    with pytest.raises(TileError):
        tiles.check_inputs("k", torch.zeros(70000, 1, 2), torch.zeros(70000, 1, 2))


@pytest.mark.parametrize("k,d,sorts,lanes,clusters", [
    (1562, 2, False, 2, 1024),       # local stage: warp path
    (1000, 2, False, 2, 1024),       # merge
    (256, 1, False, 1, 2048),        # PQ codebooks
    (300, 64, False, 32, 64),        # fits: 300 * 65 floats
    (1000, 64, True, 32, 64),
    (8192, 128, True, 32, 64),       # the KV-cache refresh's values
    (4096, 128, True, 32, 64),
    (50, 200, False, 32, 64),
    (30000, 1, True, 1, 2048)])
def test_centroid_path(k, d, sorts, lanes, clusters):
    """The centroid update sorts exactly when the (K, d+1) accumulator does
    not fit shared memory; its segment groups are sized to d."""
    assert tiles.centroid_sorts(k, d) == sorts == (not tiles.acc_in_smem(k, d))
    assert tiles.segment_lanes(d) == lanes
    assert tiles.segment_lanes(d) >= min(d, 32)
    assert tiles.segment_clusters(d) == clusters


@pytest.mark.parametrize("b,m,k,d,warps,blocks", [
    (64, 7813, 1562, 2, 5, 4),       # local stage
    (4, 99968, 1000, 2, 8, 32),      # merge: capped by the last merge
    (64, 32768, 256, 1, 8, 8),       # PQ codebooks
    (2, 517, 300, 64, 1, 5),         # one accumulator per block
    (1, 300, 50, 200, 2, 5),         # never more blocks than tiles
    (1, 40, 3, 4, 8, 1)])
def test_centroid_warp_plan(b, m, k, d, warps, blocks):
    """The warp path's accumulators fit the block's shared memory, and its
    blocks fit the card at once and bound the last block's merge."""
    assert tiles.centroid_warps(k, d) == warps
    assert warps * 4 * k * (d + 1) <= max(tiles.CENTROID_SMEM_BYTES,
                                          4 * k * (d + 1))
    g = tiles.centroid_blocks(b, m, k, d, 132)
    assert g == blocks
    assert g <= -(-m // (32 * warps))
    assert g == 1 or g * 4 * k * (d + 1) <= tiles.CENTROID_MERGE_BYTES


@pytest.mark.parametrize("k,d,route", [
    (8192, 128, "tc"),               # the KV-cache refresh
    (819, 64, "tc"), (256, 64, "simt"),  # index_200k's coarse local, merge
    (1638, 32, "tc"), (3000, 33, "tc"), (8193, 64, "tc"), (300, 128, "tc"),
    (129, 96, "simt"), (17, 33, "simt"),
    (50, 200, "tc"),                 # past d = 128: the point is no
    #                                  register tile, the SIMT scan would
    #                                  read it from device memory
    (1562, 2, "simt"), (1000, 2, "simt"),  # paper_500k local and merge
    (256, 1, "simt"),                # PQ codebooks
    (77, 16, "simt"), (3000, 31, "simt"),
    (3000, 160, "tc"),               # the points streamed past d = 128
    (1000, 400, "tc"),
    (8192, 256, "tc"),               # gemma3-12b's KV-cache refresh
    (58079, 64, "tc"),               # the most clusters the sort path takes
    (58080, 64, "simt"), (65536, 64, "simt"),
    (60000, 256, "simt")])           # the SIMT scan's point from memory
def test_lloyd_route(k, d, route):
    """The Lloyd kernel's route by shape: the tensor cores where d >= 32,
    the centroid update's sort path (the route's statistics) takes K
    clusters, and either the SIMT kernel's accumulator would not fit shared
    memory or its point would not fit the registers (d > 128); the
    tensor-core block's shared memory stays within a block's (one block per
    SM)."""
    assert tiles.lloyd_route(k, d) == route
    assert (route == "tc") == (d >= tiles.TC_MIN_D
                               and (not tiles.acc_in_smem(k, d)
                                    or not tiles.register_dim(d))
                               and tiles.tc_smem_bytes(d)
                               <= tiles.MAX_SMEM_BYTES
                               and tiles.sort_clusters_fit(k))
    if (k, d) == (8192, 128):
        assert tiles.tc_smem_bytes(d) == 199248
        assert tiles.blocks_per_sm(tiles.tc_smem_bytes(d)) == 1


@pytest.mark.parametrize("d", [129, 160, 256, 512, 1024])
def test_tc_block_fits_past_d_128(d):
    """A tensor-core block streams its points' chunks beside the centers':
    its shared memory, 199,248 bytes, does not grow with d and fits a
    block's."""
    assert tiles.tc_smem_bytes(d) == 199248 <= tiles.MAX_SMEM_BYTES


@pytest.mark.parametrize("b,m,k,d,shared,floats", [
    # llama's and gemma's refresh: both operands' hi and lo planes in
    # whole tiles of 128 rows, their norms, a lo flag a point tile
    (256, 9216, 8192, 128, False,
     (256 * 64 + 256 * 72) * 128 * 257 + 256 * 72),
    (64, 9216, 8192, 256, False, (64 * 64 + 64 * 72) * 128 * 513 + 64 * 72),
    (3, 300, 50, 200, True, (3 * 1 + 3) * 128 * 449 + 3),
    (3, 300, 50, 200, False, (3 * 1 + 9) * 128 * 449 + 9)])
def test_tc_work_floats(b, m, k, d, shared, floats):
    """The tensor-core route's device workspace: the planes the pre-pass
    writes (the points' once where the lanes share them)."""
    assert tiles.tc_work_floats(b, m, k, d, shared) == floats


@pytest.mark.parametrize("b,m,k,d,smem,per_sm,blocks", [
    (64, 7813, 1562, 2, 54008, 4, 8),     # local: 512 of 528 slots
    (64, 32768, 256, 1, 16416, 8, 16),    # PQ: 1024 of 1056
    (4, 99968, 1000, 2, 38272, 5, 131)])  # merge: 524 of 660
def test_lloyd_simt_plan(b, m, k, d, smem, per_sm, blocks):
    """The SIMT grid holds all its blocks at once (the shared-memory and
    thread reckoning; the card's occupancy, registers included, is checked
    on the card): no partial second wave; every block but the last walks
    the same number of tiles."""
    assert tiles.lloyd_simt_smem_bytes(k, d) == smem
    assert tiles.blocks_per_sm(smem) == per_sm
    g = tiles.lloyd_blocks(b, m, k, d, 132, per_sm)
    assert g == blocks and b * g <= per_sm * 132
    n_tiles = -(-m // tiles.THREADS)
    per_block = -(-n_tiles // g)
    assert (g - 1) * per_block < n_tiles <= g * per_block


def _route_cases():
    rng = np.random.default_rng(31)
    x = rng.random((2, 300, 40)).astype(np.float32)
    c = rng.random((2, 50, 40)).astype(np.float32)
    w = (rng.random((2, 300)) > 0.2).astype(np.float32)   # w = 0 rows
    dup = c.copy()
    dup[:, 30] = dup[:, 7]
    x_on = x.copy()
    x_on[:, :20] = dup[:, 7:8]
    zero_c = np.zeros_like(c)
    pool = np.concatenate([np.zeros_like(x), x], 1)       # empty cache
    pool_w = np.concatenate([np.zeros_like(w), w], 1)
    return {"w0": (x, w, c), "bf16": (x, w, c), "duplicate": (x_on, w, dup),
            "zero_centers": (pool, pool_w, np.zeros((2, 50, 40), np.float32)),
            "zero_centers_small": (x, w, zero_c)}


@pytest.mark.parametrize("case", ["w0", "bf16", "duplicate", "zero_centers",
                                  "zero_centers_small"])
def test_tc_route_composition(case):
    """The tensor-core route's composition in plain versions: the
    assignment, the centroid update on its labels and sum(w * dist) equal
    the plain Lloyd step (labels and counts exactly, sums and SSE to 1e-6
    relative); ties (duplicate and all-zero centers) go to the lowest
    index, as in the JAX package's reference."""
    x, w, c = (torch.from_numpy(a) for a in _route_cases()[case])
    if case == "bf16":
        x, w, c = x.bfloat16(), w.bfloat16(), c.bfloat16()
    idx, dist = assign_argmin_ref(x, c)
    sums, counts = centroid_update_ref(x, idx, w, c.shape[1])
    wf = w.float()
    sse = torch.where(wf != 0, wf * dist, 0.0).sum(-1)
    rsums, rcounts, rsse, ridx, _ = lloyd_step_ref(x, w, c)
    assert torch.equal(idx, ridx) and torch.equal(counts, rcounts)
    torch.testing.assert_close(sums, rsums, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(sse, rsse, rtol=1e-6, atol=0.0)
    if case.startswith("zero_centers"):
        assert not idx.any()
    if case == "duplicate":
        assert not (idx == 30).any() and bool((idx[:, :20] == 7).all())
    if case != "bf16":
        want = jax_lloyd_ref(jnp.asarray(x[0].numpy()),
                             jnp.asarray(w[0].numpy()),
                             jnp.asarray(c[0].numpy()))
        assert np.array_equal(idx[0].numpy(), np.asarray(want[3]))


def _tf32(a: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: the f32 mantissa rounded to 10 bits, ties away
    from zero (on the magnitude bits)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _truncate_tf32(a: np.ndarray) -> np.ndarray:
    """What the tensor core reads of an f32 operand: its top 19 bits."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a):
    """The kernel's split: hi = cvt.rna.tf32(v) (in integer operations),
    lo = v - hi (exact), which the tensor core truncates to TF32."""
    hi = _tf32(a)
    return hi, _truncate_tf32(a - hi)


@pytest.mark.parametrize("d", [128, 256])
def test_three_tf32_passes_keep_fp32_class_distances(d):
    """Why the tensor-core route splits both operands: at d = 128 (llama's
    refresh) and 256 (gemma's) on the unit box, the expanded-form distance
    with the cross term in three TF32 passes (lo_x hi_c + hi_x lo_c +
    hi_x hi_c, f32 accumulation) stays within the fp32 rounding bound that
    chip_smoke.py allows near-ties (``dot_rounding_bound``) against f64;
    one TF32 pass does not."""
    rng = np.random.default_rng(41)
    x = rng.random((256, d)).astype(np.float32)
    c = rng.random((512, d)).astype(np.float32)
    exact = ((x.astype(np.float64)[:, None, :] - c.astype(np.float64)[None])
             ** 2).sum(-1)
    x2 = (x.astype(np.float32) ** 2).sum(-1, dtype=np.float32)[:, None]
    c2 = (c ** 2).sum(-1, dtype=np.float32)[None]
    (xh, xl), (ch, cl) = _split(x), _split(c)
    assert np.abs(xh + xl - x).max() <= 2.0 ** -21 * np.abs(x).max()

    def mm(a, b):   # products of TF32 values are exact in f32
        return torch.from_numpy(a) @ torch.from_numpy(b).T

    three = (mm(xl, ch) + mm(xh, cl) + mm(xh, ch)).numpy()
    one = mm(xh, ch).numpy()
    x2m, c2m = float(x2.max()), float(c2.max())
    bound = (d + 2) * np.finfo(np.float32).eps * (
        x2m + c2m + 2 * (x2m * c2m) ** 0.5)
    err3 = np.abs(np.maximum(x2 + c2 - 2 * three, 0) - exact).max()
    err1 = np.abs(np.maximum(x2 + c2 - 2 * one, 0) - exact).max()
    assert err3 <= bound < err1
    # bf16-valued points (the refresh's) have lo = 0: their split is exact
    xb = torch.from_numpy(x).bfloat16().float().numpy()
    assert not _split(xb)[1].any()
