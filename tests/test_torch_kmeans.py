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


def test_stop_and_iters_conflict_and_minibatch_not_ported(pts):
    with pytest.raises(TypeError):
        kmeans(pts, 4, iters=3, stop=StopSpec(max_iters=3), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kmeans(pts, 4, stop=StopSpec(max_iters=3, minibatch=64),
               device="cpu")


def test_entry_point_defaults_to_cuda_and_never_falls_back(pts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        kmeans(pts, 4, iters=2)
