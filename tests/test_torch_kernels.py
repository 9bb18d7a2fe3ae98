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
from repro_torch.kernels.ref import assign_argmin_ref, centroid_update_ref

# ragged M / d / K on purpose (tests/test_lloyd.py's sweep)
SHAPES = [(64, 4, 3), (257, 16, 7), (100, 33, 17), (512, 128, 300),
          (1024, 2, 128)]


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


def test_tile_contract():
    assert [tiles.register_dim(d) for d in (1, 2, 3, 16, 33, 128, 129)] == \
        [2, 2, 4, 16, 64, 128, 0]
    assert tiles.center_stride(2) == 4 and tiles.center_stride(200) == 201
    assert tiles.center_tile(1562, 2) == 1562          # the paper's shapes:
    assert tiles.center_tile(1000, 2) == 1000          # one resident tile
    assert 1 <= tiles.center_tile(10 ** 6, 64) < 10 ** 6
    assert tiles.acc_in_smem(1562, 2) and not tiles.acc_in_smem(1000, 64)
    # local stage: 64 partitions of 7813 slots on 132 SMs
    g = tiles.lloyd_blocks(64, 7813, 1562, 2, 132)
    assert 1 <= g <= -(-7813 // tiles.THREADS)
    assert tiles.lloyd_blocks(1, 10, 5, 2, 132) == 1   # never more than tiles
    with pytest.raises(TileError):
        tiles.center_tile(4, 20000)
    with pytest.raises(TileError):
        tiles.check_inputs("k", torch.zeros(70000, 1, 2), torch.zeros(70000, 1, 2))
