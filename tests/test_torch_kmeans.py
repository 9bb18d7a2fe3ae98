"""The port's k-means against the JAX package's on the same inputs (made
with numpy from a seed): the deterministic paths exactly or at f32
tolerance, the random inits by their contracts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmeans as jax_kmeans
from repro.core.pipeline import local_stage as jax_local_stage
from repro.core.spec import StopSpec as JaxStop
from repro.core.subcluster import equal_partition as jax_equal
from repro.core.subcluster import gather_partitions as jax_gather
from repro.data.synthetic import blobs
from repro_torch.core import (StopSpec, get_init, kmeans, kmeans_batched,
                              landmark_init, local_stage, random_init)
from repro_torch.core.device import make_generator
from repro_torch.core.kmeans import _jittered_array_init, _linspace01

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pts():
    return blobs(600, n_clusters=4, dim=3, seed=1)[0]


def test_array_init_fixed_trip_matches_jax(pts):
    """Explicit array init, tol=0: centers, assignment, sse and counts match
    the reference's."""
    init = pts[[0, 150, 300, 450]]
    ref = jax_kmeans(jnp.asarray(pts), 4, iters=15, init=jnp.asarray(init))
    got = kmeans(pts, 4, iters=15, init=torch.from_numpy(init), device="cpu")
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(ref.centers),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(ref.assignment))
    np.testing.assert_allclose(float(got.sse), float(ref.sse), rtol=1e-4)
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))
    assert int(got.n_iter) == int(ref.n_iter) == 15
    # separated blobs: the jittered restarts land on the same optimum
    r = kmeans(pts, 4, iters=15, init=torch.from_numpy(init), restarts=3,
               seed=2, device="cpu")
    np.testing.assert_allclose(float(r.sse), float(ref.sse), rtol=1e-4)


@pytest.mark.parametrize("metric", ["rel_sse", "center_shift"])
def test_tol_local_stage_per_lane_n_iter_matches_jax(metric):
    """A tol>0 batched local stage freezes each lane when it converges and
    reports the same per-lane n_iter as the reference's vmapped
    while_loop."""
    x = blobs(2000, n_clusters=5, dim=2, seed=4)[0]
    part = jax_equal(jnp.asarray(x), 5)
    parts, part_w = jax_gather(jnp.asarray(x), part)
    stop = dict(max_iters=30, tol=1e-3, metric=metric, patience=2)
    ref = jax_local_stage(parts, part_w, 8, key=jax.random.PRNGKey(0),
                          init="landmark", stop=JaxStop(**stop))
    got = local_stage(torch.from_numpy(np.array(parts)),
                      torch.from_numpy(np.array(part_w)), 8,
                      generator=make_generator(0, CPU), init="landmark",
                      stop=StopSpec(**stop))
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(ref.n_iter))
    assert len(set(got.n_iter.tolist())) > 1      # lanes really differ
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(ref.centers),
                               rtol=1e-4, atol=1e-4)


def test_landmark_init_matches_jax(pts):
    from repro.core import landmark_init as jax_landmark
    w = np.ones(600, np.float32)
    w[::7] = 0.0
    ref = jax_landmark(jnp.asarray(pts), jnp.asarray(w), 9)
    got = landmark_init(torch.from_numpy(pts)[None], torch.from_numpy(w)[None],
                        9)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    for k in (1, 2, 7, 1000):
        np.testing.assert_array_equal(
            _linspace01(k, torch.float32, CPU).numpy(),
            np.asarray(jnp.linspace(0.0, 1.0, k, dtype=jnp.float32)))


def test_restart_zero_keeps_array_init_verbatim(pts):
    warm = kmeans(pts, 4, iters=10, device="cpu").centers
    again = kmeans(pts, 4, iters=0, init=warm, restarts=1, device="cpu")
    assert torch.equal(again.centers, warm)


def test_restarts_with_degenerate_array_init_split_clusters(pts):
    """restarts>1 with an array init jitters later restarts by the data's
    population std: from all-coincident centers they split apart."""
    degenerate = torch.from_numpy(pts).mean(0, keepdim=True).repeat(4, 1)
    r1 = kmeans(pts, 4, iters=20, init=degenerate, restarts=1, device="cpu")
    r4 = kmeans(pts, 4, iters=20, init=degenerate, restarts=4, seed=0,
                device="cpu")
    assert float(r4.sse) < 0.9 * float(r1.sse)
    assert int((r4.counts > 0).sum()) > int((r1.counts > 0).sum())


def test_jitter_scales_with_population_std():
    x = torch.tensor([[[0.0], [2.0]]])            # population std 1, sample std 1.41
    init = torch.zeros(2000, 1)
    out = _jittered_array_init(init, x.expand(2, -1, -1),
                               make_generator(0, CPU), torch.tensor([0, 1]))
    assert torch.equal(out[0], init)
    assert abs(float(out[1].std()) - (0.05 * 1.0 + 1e-6)) < 0.005


def test_random_init_samples_without_replacement_and_respects_weights():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, 12, 2)).astype(np.float32))
    w = torch.ones(1, 12)
    for seed in range(10):
        c = random_init(x, w, 8, make_generator(seed, CPU))[0]
        assert len(np.unique(c.numpy(), axis=0)) == 8
    x2 = torch.arange(20, dtype=torch.float32).reshape(1, 10, 2)
    w2 = torch.tensor([[1, 0, 1, 0, 1, 0, 1, 0, 1, 0]], dtype=torch.float32)
    valid = x2[0][w2[0] > 0]
    for seed in range(5):
        for c in random_init(x2, w2, 5, make_generator(seed, CPU))[0]:
            assert (c == valid).all(-1).any()
    few = random_init(x2, torch.tensor([[1.0] * 3 + [0.0] * 7]), 5,
                      make_generator(0, CPU))[0]
    assert all((c == x2[0, :3]).all(-1).any() for c in few)


@pytest.mark.parametrize("init", ["kmeans++", "kmeans||", "random"])
def test_random_inits_pick_valid_points_per_lane(init):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(3, 50, 2)).astype(np.float32))
    x[:, 25:] += 1e3                               # masked junk
    w = torch.zeros(3, 50)
    w[:, :25] = 1.0
    c = get_init(init)(x, w, 6, make_generator(1, CPU))
    assert c.shape == (3, 6, 2) and float(c.abs().max()) < 100.0


def test_kmeans_pp_quality_close_to_jax(pts):
    """Different random streams, same statistics: restarted kmeans++ on
    separated blobs lands on the reference's SSE."""
    ref = jax_kmeans(jnp.asarray(pts), 4, iters=20, restarts=4,
                     key=jax.random.PRNGKey(0))
    got = kmeans(pts, 4, iters=20, restarts=4, seed=0, device="cpu")
    np.testing.assert_allclose(float(got.sse), float(ref.sse), rtol=1e-3)


def test_kmeans_batched_lanes_are_independent(pts):
    """Two lanes in one batch equal the same two fits run alone."""
    x = torch.from_numpy(np.stack([pts, pts[::-1].copy()]))
    w = torch.ones(2, 600)
    both = kmeans_batched(x, 4, weights=w, generator=make_generator(0, CPU),
                          init="landmark", stop=StopSpec(max_iters=12))
    for lane in range(2):
        alone = kmeans(x[lane], 4, iters=12, init="landmark", device="cpu")
        torch.testing.assert_close(both.centers[lane], alone.centers)
        assert torch.equal(both.assignment[lane], alone.assignment)


def test_stop_and_iters_conflict_and_minibatch_runs(pts):
    with pytest.raises(TypeError):
        kmeans(pts, 4, iters=3, stop=StopSpec(max_iters=3), device="cpu")
    res = kmeans(pts, 4, stop=StopSpec(max_iters=3, minibatch=64),
                 device="cpu")
    assert res.centers.shape == (4, 3) and int(res.n_iter) == 3
    assert bool(torch.isfinite(res.centers).all())


# ---------------------------------------------------------------------------
# mini-batch Lloyd (StopSpec.minibatch > 0)
# ---------------------------------------------------------------------------

def _minibatch_blobs(n=800, k=4, seed=0):
    return blobs(n, n_clusters=k, dim=3, seed=seed)[0]


def test_minibatch_updates_match_jax_given_its_ids():
    """The reference's own row ids, regenerated from the key it passes to
    ``_lloyd_minibatch``, drive the port's update: after every step the
    centers equal the reference's at rtol 1e-5."""
    from repro.core.backend import get_backend as jax_backend
    from repro.core.kmeans import _MINIBATCH_SALT, _lloyd_minibatch
    from repro_torch.core.backend import get_backend
    from repro_torch.core.kmeans import minibatch_update
    x = _minibatch_blobs()
    w = np.random.default_rng(0).uniform(0.0, 2.0, 800).astype(np.float32)
    w[::7] = 0.0
    key = jax.random.fold_in(jax.random.PRNGKey(5), _MINIBATCH_SALT)
    c0 = jnp.asarray(x[[0, 200, 400, 600]])
    logits = jnp.where(jnp.asarray(w) > 0, jnp.log(jnp.maximum(
        jnp.asarray(w), 1e-30)), -jnp.inf)
    n = 128
    be = get_backend("torch", device="cpu")
    centers = torch.from_numpy(np.array(c0))[None]
    cum = torch.zeros(1, 4)
    for i in range(6):
        ids = np.asarray(jax.random.categorical(jax.random.fold_in(key, i),
                                                logits, shape=(n,)))
        centers, cum, _ = minibatch_update(
            be, torch.from_numpy(x)[None], torch.ones(1, n), centers, cum,
            torch.from_numpy(ids.astype(np.int64))[None])
        ref, _ = _lloyd_minibatch(
            jax_backend("jnp"), jnp.asarray(x), jnp.asarray(w), c0,
            JaxStop(max_iters=i + 1, minibatch=n), key)
        np.testing.assert_allclose(centers[0].numpy(), np.asarray(ref),
                                   rtol=1e-5, err_msg=f"step {i}")


def test_minibatch_is_bit_identical_and_within_2x_of_full_batch():
    x = _minibatch_blobs()
    stop = StopSpec(max_iters=12, minibatch=128)
    a = kmeans(x, 4, stop=stop, seed=5, device="cpu")
    b = kmeans(x, 4, stop=stop, seed=5, device="cpu")
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert a.assignment.shape == (800,)        # the final pass: all points
    full = kmeans(x, 4, iters=12, seed=5, device="cpu")
    assert float(a.sse) <= 2.0 * float(full.sse)
    ref = jax_kmeans(jnp.asarray(x), 4, stop=JaxStop(max_iters=12,
                                                     minibatch=128),
                     key=jax.random.PRNGKey(5))
    assert float(a.sse) <= 2.0 * float(ref.sse)


def test_minibatch_through_the_kernel_wrappers():
    """The kernel wrappers check the kernels' input contract on the CPU
    too (contiguous weight rows, shapes), then run the plain versions:
    the cuda_fused backend's mini-batch fit is the torch backend's."""
    x = _minibatch_blobs()
    stop = StopSpec(max_iters=6, minibatch=100)
    a = kmeans(x, 4, stop=stop, seed=2, restarts=2, backend="cuda_fused",
               device="cpu")
    b = kmeans(x, 4, stop=stop, seed=2, restarts=2, backend="torch",
               device="cpu")
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_minibatch_with_tol_stops_early():
    x = _minibatch_blobs(k=3)
    res = kmeans(x, 3, stop=StopSpec(max_iters=100, minibatch=256, tol=1e-3,
                                     patience=3), seed=6, device="cpu")
    assert int(res.n_iter) < 100


def test_minibatch_restarts_and_point_sets_run_as_lanes():
    """Restarts and point sets are lanes of one batch; each lane draws its
    own rows, and the lowest-SSE restart of each set wins."""
    from repro_torch.core.kmeans import _weight_cdf, minibatch_ids
    xs = torch.from_numpy(np.stack([_minibatch_blobs(seed=s)
                                    for s in (1, 2)]))
    stop = StopSpec(max_iters=8, minibatch=64)
    both = kmeans_batched(xs, 4, weights=torch.ones(2, 800),
                          generator=make_generator(1, CPU), restarts=3,
                          stop=stop)
    assert both.centers.shape == (2, 4, 3) and both.n_iter.tolist() == [8, 8]
    for lane in range(2):
        assert torch.equal(both.sse[lane], kmeans_batched(
            xs[lane:lane + 1], 4, weights=torch.ones(1, 800),
            generator=make_generator(1, CPU), init=both.centers[lane:lane + 1],
            stop=StopSpec(max_iters=0)).sse[0])
    ids = minibatch_ids(_weight_cdf(torch.ones(3, 800)), 64,
                        make_generator(0, CPU))
    assert ids.shape == (3, 64)
    assert not torch.equal(ids[0], ids[1])


def test_minibatch_never_draws_a_zero_weight_row():
    from repro_torch.core.kmeans import _weight_cdf, minibatch_ids
    w = torch.zeros(3, 50)
    w[0, [0, 7, 49]] = torch.tensor([1.0, 3.0, 0.5])
    w[1, 10:] = 1.0                     # the leading rows have no weight
    ids = minibatch_ids(_weight_cdf(w), 4000, make_generator(2, CPU))
    assert set(ids[0].tolist()) == {0, 7, 49}
    assert int(ids[1].min()) >= 10
    assert set(ids[2].tolist()) == {0}  # a lane without mass: row 0
    frac = float((ids[0] == 7).float().mean())
    assert abs(frac - 3.0 / 4.5) < 0.05


def test_minibatch_zero_mass_lane_stays_finite_and_unmoved():
    """The reference's categorical over all -inf logits has no defined
    draw; the port's lane without mass gets sample weight 0, so no step
    moves its centers (ROADMAP §3)."""
    x = torch.from_numpy(np.stack([_minibatch_blobs(seed=3)] * 2))
    w = torch.ones(2, 800)
    w[1] = 0.0
    init = x[:, [0, 100, 200, 300]]
    res = kmeans_batched(x, 4, weights=w, generator=make_generator(0, CPU),
                         init=init, stop=StopSpec(max_iters=5, minibatch=64))
    assert bool(torch.isfinite(res.centers).all())
    assert torch.equal(res.centers[1], init[1])
    assert not torch.equal(res.centers[0], init[0])
    assert float(res.sse[1]) == 0.0


def test_entry_point_defaults_to_cuda_and_never_falls_back(pts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        kmeans(pts, 4, iters=2)
