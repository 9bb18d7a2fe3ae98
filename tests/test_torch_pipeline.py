"""The port's pipeline end to end against the JAX package's.

Exactness is held on the randomness-free spec (``init="landmark"`` in every
stage, ``tol=0``).  Its sizes keep the Lloyd trajectories well conditioned:
at ``compression=50`` the reference's own eager and jitted runs agree, while
at small compressions (100 local centers on 500 points) near-ties flip under
any change of arithmetic, in the reference too.  The kmeans++ spec is held
statistically (different random streams)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ClusterSpec as JaxSpec
from repro.core import LevelSpec as JaxLevel
from repro.core import fit_from_spec as jax_fit
from repro.data.synthetic import blobs
from repro.telemetry import RecordingLogger as JaxRecordingLogger
from repro_torch.core import (ClusterSpec, LevelSpec, fit_from_spec,
                              relative_error, sampled_kmeans,
                              standard_kmeans)
from repro_torch.telemetry import RecordingLogger


@pytest.fixture(scope="module")
def pts():
    return blobs(3000, n_clusters=6, dim=2, seed=3)[0]


def _landmark(cls, level_cls, scheme, levels):
    spec = cls.make(6, scheme=scheme, n_sub=4, compression=50,
                    init="landmark", local_iters=10, global_iters=10,
                    restarts=2)
    if levels:
        spec = spec.replace(levels=(level_cls(
            n_sub=2, compression=2, iters=5, init="landmark",
            scheme=scheme),))
    return spec


@pytest.mark.parametrize("levels", [False, True])
@pytest.mark.parametrize("scheme", ["equal", "unequal"])
def test_landmark_spec_matches_jax(pts, scheme, levels):
    ref = jax_fit(jnp.asarray(pts),
                  _landmark(JaxSpec, JaxLevel, scheme, levels))
    got = fit_from_spec(pts, _landmark(ClusterSpec, LevelSpec, scheme,
                                       levels), device="cpu")
    np.testing.assert_allclose(got.local_centers.numpy(),
                               np.asarray(ref.local_centers), atol=1e-4)
    np.testing.assert_array_equal(got.local_weights.numpy(),
                                  np.asarray(ref.local_weights))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(ref.centers),
                               atol=1e-4)
    np.testing.assert_allclose(float(got.sse), float(ref.sse), rtol=1e-4)
    assert int(got.n_dropped) == int(ref.n_dropped)
    if scheme == "unequal":
        assert int(got.n_dropped) > 0      # the capacity really drops points


def test_coarse_landmark_spec_at_paper_scale_matches_jax():
    """500,000 points in 64 equal partitions (paper_500k's data and
    partitioning) with coarse landmark stages (3 local centers per
    partition, k=20): exact partitions, f32-close centers and SSE.  (At
    paper_500k's own center counts the assignments are rounding-noise
    dominated in fp32, for the reference too; see ROADMAP.md §3.)"""
    pts = blobs(500_000, dim=2, seed=0)[0]

    def spec(cls):
        return cls.make(20, n_sub=64, compression=2000, init="landmark",
                        local_iters=10, global_iters=10, restarts=4)

    ref = jax_fit(jnp.asarray(pts), spec(JaxSpec))
    got = fit_from_spec(pts, spec(ClusterSpec), device="cpu")
    np.testing.assert_array_equal(got.local_weights.numpy(),
                                  np.asarray(ref.local_weights))
    np.testing.assert_allclose(got.local_centers.numpy(),
                               np.asarray(ref.local_centers), atol=1e-4)
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(ref.centers),
                               atol=1e-4)
    np.testing.assert_allclose(float(got.sse), float(ref.sse), rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeanspp_sampled_close_to_standard(pts, seed):
    """The paper's claim in the port: sampled clustering lands within 10%
    of full k-means (tests/test_pipeline.py's bound)."""
    full = standard_kmeans(pts, 6, iters=30, seed=seed, device="cpu")
    samp = sampled_kmeans(pts, 6, spec=ClusterSpec.make(
        6, scheme="equal", n_sub=6, compression=5), seed=seed, device="cpu")
    assert relative_error(float(samp.sse), float(full.sse)) < 0.10
    assert samp.local_centers.shape == (6 * (500 // 5), 2)


def test_repeated_fits_are_bit_identical(pts):
    spec = ClusterSpec.make(6, n_sub=6, compression=5, levels=2)
    a = fit_from_spec(pts, spec, 7, device="cpu")
    b = fit_from_spec(pts, spec, 7, device="cpu")
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    c = fit_from_spec(pts, spec, 8, device="cpu")
    assert not torch.equal(a.centers, c.centers)   # the seed matters


def test_telemetry_is_host_side_only(pts):
    spec = ClusterSpec.make(6, n_sub=6, compression=5)
    log = RecordingLogger()
    logged = fit_from_spec(pts, spec, 1, logger=log, device="cpu")
    plain = fit_from_spec(pts, spec, 1, device="cpu")
    assert torch.equal(logged.centers, plain.centers)
    names = {e["name"] for e in log.events}
    assert {"fold", "merge", "sse", "stage_iters", "fit_from_spec"} <= names
    # the same event schema as the JAX package's logger
    ref = JaxRecordingLogger()
    jax_fit(jnp.asarray(pts), JaxSpec.make(6, n_sub=6, compression=5),
            logger=ref)
    assert {e["name"] for e in ref.events} == names
    assert ({tuple(sorted(e)) for e in log.events}
            == {tuple(sorted(e)) for e in ref.events})


def test_sampled_kmeans_adapter_errors(pts):
    with pytest.raises(ValueError, match="disagrees"):
        sampled_kmeans(pts, 5, spec=ClusterSpec.make(6), device="cpu")
    with pytest.raises(TypeError, match="either spec"):
        sampled_kmeans(pts, 6, spec=ClusterSpec.make(6), n_sub=3,
                       device="cpu")
    with pytest.raises(TypeError, match="unknown kwargs"):
        sampled_kmeans(pts, 6, bogus=1, device="cpu")
    with pytest.warns(DeprecationWarning):
        r = sampled_kmeans(pts, 6, n_sub=6, compression=5, device="cpu")
    assert r.centers.shape == (6, 2)
