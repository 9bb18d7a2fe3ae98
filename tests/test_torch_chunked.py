"""The port's out-of-core executor (``mode="chunked"``) against its own
single mode and against the JAX package's ``fit_chunked``.

Exactness against the reference is held on the randomness-free spec
(``init="landmark"`` in every stage, ``tol=0``) at the sizes of
``test_torch_pipeline.py::test_landmark_spec_matches_jax``: centers and
local centers at rtol 1e-5, the SSE at rtol 1e-6, every ``ChunkStats``
field equal.  Within the port a source that fits in one chunk is
``fit_from_spec`` bit for bit; kmeans++ fits are held statistically
(within 0.15 of single mode, the reference's own bound)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ChunkSpec as JaxChunk
from repro.core import ClusterSpec as JaxSpec
from repro.core import LevelSpec as JaxLevel
from repro.core import fit_chunked as jax_fit_chunked
from repro.data import ArraySource as JaxArraySource
from repro.data.synthetic import blobs
from repro.telemetry import RecordingLogger as JaxRecordingLogger
from repro_torch.api import SampledKMeans, execute, plan
from repro_torch.core import (ChunkSpec, ClusterSpec, ExecutionSpec,
                              LevelSpec, LocalSpec, MergeSpec, PartitionSpec,
                              feature_scale, fit_chunked, fit_from_spec,
                              minmax_pass, relative_error, scale_pass, sse,
                              sse_pass)
from repro_torch.data import ArraySource, IterSource, SyntheticSource
from repro_torch.telemetry import RecordingLogger

SPEC = ClusterSpec(
    partition=PartitionSpec(scheme="equal", n_sub=8),
    local=LocalSpec(compression=5, iters=8),
    merge=MergeSpec(k=5, iters=15),
)


@pytest.fixture(scope="module")
def pts():
    return blobs(2000, n_clusters=5, dim=3, seed=7)[0]


@pytest.fixture(scope="module")
def pts6():
    return blobs(3000, n_clusters=6, dim=2, seed=3)[0]


def _chunked(spec, **chunk_kwargs):
    return spec.replace(chunk=ChunkSpec(**chunk_kwargs),
                        execution=ExecutionSpec(mode="chunked"))


def _assert_results_equal(a, b):
    for u, v in zip(a, b):
        assert torch.equal(u, v)


# ---------------------------------------------------------------------------
# One chunk: the port's fit_from_spec, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("levels", [(), (LevelSpec(n_sub=4, compression=2,
                                                   iters=4),)])
def test_one_chunk_is_fit_from_spec_bit_for_bit(pts, levels):
    spec = SPEC.replace(levels=levels)
    ref = fit_from_spec(pts, spec, 3, device="cpu")
    res, stats = fit_chunked(ArraySource(pts),
                             _chunked(spec, chunk_points=4096), 3,
                             device="cpu")
    assert stats.n_chunks == 1 and stats.passes == 3
    _assert_results_equal(res, ref)


def test_one_chunk_through_the_facade(pts):
    ref = fit_from_spec(pts, SPEC, 11, device="cpu")
    est = SampledKMeans(_chunked(SPEC, chunk_points=4096),
                        device="cpu").fit(ArraySource(pts), seed=11)
    assert torch.equal(est.centers_, ref.centers)
    assert torch.equal(est.sse_, ref.sse)
    assert est.chunk_stats_.n_chunks == 1
    # "auto" resolves a non-resident source to chunked: the same fit
    src = IterSource([pts[:700], pts[700:]])
    auto = SampledKMeans(SPEC.replace(chunk=ChunkSpec(4096)),
                         device="cpu").fit(src, seed=11)
    assert auto.chunk_stats_.n_chunks == 1
    _assert_results_equal(auto.result_, ref)


def test_one_chunk_bf16(pts):
    xb = torch.from_numpy(pts).bfloat16()
    ref = fit_from_spec(xb, SPEC, 2, device="cpu")
    res, _ = fit_chunked(ArraySource(xb), _chunked(SPEC, chunk_points=4096),
                         2, device="cpu")
    _assert_results_equal(res, ref)
    assert res.centers.dtype == torch.bfloat16
    res4, _ = fit_chunked(ArraySource(xb), _chunked(SPEC, chunk_points=500),
                          2, device="cpu")
    assert bool(torch.isfinite(res4.centers.float()).all())
    ref32 = float(fit_from_spec(pts, SPEC, 2, device="cpu").sse)
    assert abs(relative_error(float(res4.sse), ref32)) < 0.25


# ---------------------------------------------------------------------------
# Several chunks: the JAX package's fit_chunked on the landmark spec
# ---------------------------------------------------------------------------

def _landmark(cls, level_cls, chunk_cls, chunk_points, levels):
    spec = cls.make(6, n_sub=4, compression=50, init="landmark",
                    local_iters=10, global_iters=10, restarts=2)
    if levels:
        spec = spec.replace(levels=(level_cls(
            n_sub=2, compression=2, iters=5, init="landmark"),))
    return spec.replace(chunk=chunk_cls(chunk_points=chunk_points))


@pytest.mark.parametrize("chunk_points,levels,n_chunks,flushes", [
    (750, False, 4, False),      # 4 chunks, flat
    (250, True, 12, True),       # 12 chunks and one level: a flush
])
def test_landmark_chunks_match_jax(pts6, chunk_points, levels, n_chunks,
                                   flushes):
    ref, ref_stats = jax_fit_chunked(
        JaxArraySource(jnp.asarray(pts6)),
        _landmark(JaxSpec, JaxLevel, JaxChunk, chunk_points, levels),
        jax.random.PRNGKey(0))
    spec = _landmark(ClusterSpec, LevelSpec, ChunkSpec, chunk_points, levels)
    got, stats = fit_chunked(ArraySource(pts6), spec, device="cpu")
    assert stats._asdict() == ref_stats._asdict()
    assert stats.n_chunks == n_chunks
    # an unflushed run would hold every chunk pool at once
    all_pools = n_chunks * 4 * (-(-chunk_points // 4) // 50)
    assert (stats.peak_pool_rows < all_pools) == flushes
    np.testing.assert_allclose(got.local_centers.numpy(),
                               np.asarray(ref.local_centers), rtol=1e-5)
    np.testing.assert_array_equal(got.local_weights.numpy(),
                                  np.asarray(ref.local_weights))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(ref.centers),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got.sse), float(ref.sse), rtol=1e-6)
    assert int(got.n_dropped) == int(ref.n_dropped) == 0


def test_landmark_flush_schedule_matches_the_spec(pts6):
    spec = _landmark(ClusterSpec, LevelSpec, ChunkSpec, 250, True)
    res, stats = fit_chunked(ArraySource(pts6), spec, device="cpu")
    assert stats.pool_size == spec.chunked_pool_schedule(3000)[-1]
    np.testing.assert_allclose(float(res.local_weights.sum()), 3000.0,
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# Sources and edge cases
# ---------------------------------------------------------------------------

def test_ragged_iter_source_equals_array_source(pts):
    """Pieces of awkward sizes re-batch into the same chunks, so the fit
    is the ArraySource fit bit for bit."""
    spec = _chunked(SPEC, chunk_points=512)
    cuts = [0, 37, 600, 601, 1333, 2000]
    src = IterSource(lambda: (pts[a:b] for a, b in zip(cuts, cuts[1:])))
    a, sa = fit_chunked(src, spec, 5, device="cpu")
    b, sb = fit_chunked(ArraySource(pts), spec, 5, device="cpu")
    assert sa == sb and sa.n_chunks == 4
    assert sa.max_chunk_points == 512
    _assert_results_equal(a, b)


def test_tail_chunk_smaller_than_n_sub(pts):
    """A 3-row tail under n_sub=8 clamps its partitions to its rows."""
    spec = _chunked(SPEC, chunk_points=1997)
    res, stats = fit_chunked(ArraySource(pts), spec, 0, device="cpu")
    assert stats.n_chunks == 2
    assert stats.pool_size == spec.chunked_pool_schedule(2000)[-1]
    assert stats.pool_size == 8 * (-(-1997 // 8) // 5) + 3
    assert bool(torch.isfinite(res.centers).all())
    np.testing.assert_allclose(float(res.local_weights.sum()), 2000.0,
                               rtol=1e-6)


def test_empty_source_raises():
    empty = IterSource(lambda: iter(()), dim=3)
    with pytest.raises(ValueError, match="no chunks"):
        fit_chunked(empty, _chunked(SPEC, chunk_points=64), device="cpu")
    with pytest.raises(ValueError, match="no points"):
        fit_chunked(empty, _chunked(SPEC, chunk_points=64).replace(
            scale=False), device="cpu")
    with pytest.raises(ValueError, match="no chunks"):
        sse_pass(empty, torch.zeros(5, 3), 64)


@pytest.mark.parametrize("chunk_points", [1, 333, 2000, 5000])
def test_scale_pass_equals_feature_scale(pts, chunk_points):
    lo, span = scale_pass(ArraySource(pts), chunk_points, device="cpu")
    _, (rlo, rspan) = feature_scale(torch.from_numpy(pts))
    assert torch.equal(lo, rlo) and torch.equal(span, rspan)
    mlo, mhi = minmax_pass(ArraySource(pts), chunk_points, device="cpu")
    assert torch.equal(mlo, rlo)
    assert torch.equal(mhi, torch.from_numpy(pts.max(0)))


def test_sse_pass_is_the_blocked_sse(pts):
    c = torch.from_numpy(pts[:5].copy())
    one = sse_pass(ArraySource(pts), c, 4096)
    assert torch.equal(one, sse(torch.from_numpy(pts), c, block=65536))
    many = sse_pass(ArraySource(pts), c, 300)
    torch.testing.assert_close(many, one, rtol=1e-6, atol=0.0)


def test_pool_sse_skips_the_exact_pass(pts):
    spec = _chunked(SPEC, chunk_points=500, sse="pool")
    res, stats = fit_chunked(ArraySource(pts), spec, 0, device="cpu")
    assert stats.passes == 2
    assert torch.equal(res.sse, sse(res.local_centers, res.centers,
                                    weights=res.local_weights))
    exact, stats_e = fit_chunked(ArraySource(pts), spec.replace(
        chunk=ChunkSpec(500, sse="exact")), 0, device="cpu")
    assert stats_e.passes == 3
    assert torch.equal(exact.centers, res.centers)
    assert float(res.sse) < float(exact.sse)    # the pool hides spread


def test_unscaled_chunks(pts):
    spec = _chunked(SPEC, chunk_points=4096).replace(scale=False)
    res, stats = fit_chunked(ArraySource(pts), spec, 1, device="cpu")
    _assert_results_equal(res, fit_from_spec(pts, spec, 1, device="cpu"))
    assert stats.passes == 2      # no scale pass


def test_synthetic_source_chunks_are_the_jax_packages():
    from repro.data import SyntheticSource as JaxSynthetic
    a = SyntheticSource(5000, dim=8, n_clusters=64, seed=0)
    b = JaxSynthetic(5000, dim=8, n_clusters=64, seed=0)
    for u, v in zip(a.chunks(1024), b.chunks(1024)):
        np.testing.assert_array_equal(u, np.asarray(v))


# ---------------------------------------------------------------------------
# kmeans++: statistically close to single mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_chunks", [4, 16])
def test_kmeanspp_chunks_within_15pct_of_single(pts, n_chunks):
    ref = float(fit_from_spec(pts, SPEC, 0, device="cpu").sse)
    res, stats = fit_chunked(ArraySource(pts),
                             _chunked(SPEC, chunk_points=2000 // n_chunks),
                             0, device="cpu")
    assert stats.n_chunks == n_chunks
    assert abs(relative_error(float(res.sse), ref)) < 0.15


def test_kmeanspp_with_levels_conserves_mass(pts):
    lv = (LevelSpec(n_sub=4, compression=2, iters=6),)
    spec = _chunked(SPEC, chunk_points=500).replace(levels=lv)
    res, stats = fit_chunked(ArraySource(pts), spec, 0, device="cpu")
    assert stats.pool_size == spec.chunked_pool_schedule(2000)[-1] == 192
    ref = float(fit_from_spec(pts, SPEC.replace(levels=lv), 0,
                              device="cpu").sse)
    assert abs(relative_error(float(res.sse), ref)) < 0.15
    np.testing.assert_allclose(float(res.local_weights.sum()), 2000.0,
                               rtol=1e-5)


@pytest.mark.parametrize("backend", ["cuda_fused", "cuda"])
def test_kernel_wrappers_take_the_executors_inputs(pts, backend):
    """Through the kernel wrappers (which check the kernels' input
    contract on the CPU, then run the plain versions) the chunked fit,
    flushes included, is the torch backend's: bit for bit under
    cuda_fused, to f32 rounding under cuda (another summation order)."""
    spec = _chunked(SPEC, chunk_points=250).replace(
        levels=(LevelSpec(n_sub=2, compression=2, iters=3),))
    a, _ = fit_chunked(ArraySource(pts), spec, 3, backend=backend,
                       device="cpu")
    b, _ = fit_chunked(ArraySource(pts), spec, 3, backend="torch",
                       device="cpu")
    if backend == "cuda_fused":
        _assert_results_equal(a, b)
    else:
        torch.testing.assert_close(a.centers, b.centers, rtol=1e-4,
                                   atol=1e-4)


def test_repeated_chunked_fits_are_bit_identical(pts):
    spec = _chunked(SPEC, chunk_points=300).replace(
        levels=(LevelSpec(n_sub=2, compression=2, iters=3),))
    a, _ = fit_chunked(ArraySource(pts), spec, 9, device="cpu")
    b, _ = fit_chunked(ArraySource(pts), spec, 9, device="cpu")
    _assert_results_equal(a, b)
    c, _ = fit_chunked(ArraySource(pts), spec, 10, device="cpu")
    assert not torch.equal(a.centers, c.centers)


# ---------------------------------------------------------------------------
# Planner, facade, telemetry
# ---------------------------------------------------------------------------

def test_plan_modes_and_schedule_check(pts):
    src = IterSource([pts])
    assert plan(SPEC, source=src, device="cpu").mode == "chunked"
    assert plan(SPEC, source=ArraySource(pts), device="cpu").mode == "single"
    assert plan(SPEC, (2000, 3), device="cpu").mode == "single"
    starved = _chunked(SPEC.replace(merge=MergeSpec(k=500)), chunk_points=50)
    with pytest.raises(ValueError, match="chunked schedule"):
        plan(starved, (2000, 3), device="cpu")
    with pytest.raises(ValueError, match="needs a resident array"):
        execute(plan(SPEC, device="cpu"), src)
    res, stats = execute(plan(SPEC, device="cpu"), ArraySource(pts), 4,
                         return_stats=True)
    assert stats is None
    _assert_results_equal(res, fit_from_spec(pts, SPEC, 4, device="cpu"))


def test_predict_on_a_source(pts):
    est = SampledKMeans(_chunked(SPEC, chunk_points=333),
                        device="cpu").fit(ArraySource(pts))
    assert torch.equal(est.predict(IterSource([pts])), est.predict(pts))


def test_telemetry_is_host_side_and_matches_the_jax_schema(pts):
    spec = _chunked(SPEC, chunk_points=250).replace(
        levels=(LevelSpec(n_sub=2, compression=2, iters=3),))
    log = RecordingLogger()
    logged, _ = fit_chunked(ArraySource(pts), spec, 1, logger=log,
                            device="cpu")
    plain, _ = fit_chunked(ArraySource(pts), spec, 1, device="cpu")
    _assert_results_equal(logged, plain)
    names = {e["name"] for e in log.events}
    assert {"scale_pass", "fold", "fold_rate", "pool_flush", "reduce_level",
            "merge", "stage_iters", "sse_pass", "fit_chunked"} <= names
    ref = JaxRecordingLogger()
    jax_spec = JaxSpec.from_dict(spec.to_dict())
    jax_fit_chunked(JaxArraySource(jnp.asarray(pts)), jax_spec,
                    jax.random.PRNGKey(1), logger=ref)
    assert {e["name"] for e in ref.events} == names
    summary = log.named("fit_chunked")[0]
    ref_summary = [e for e in ref.events if e["name"] == "fit_chunked"][0]
    assert set(summary) == set(ref_summary)
