"""The port's estimator facade, its backend registry, and state carried
over from the JAX package (``repro_torch.convert``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import SampledKMeans as JaxSampledKMeans
from repro.core import ClusterSpec as JaxSpec
from repro.data.synthetic import blobs
from repro_torch import convert
from repro_torch.api import SampledKMeans, plan
from repro_torch.core import ClusterSpec, sampled_kmeans
from repro_torch.core.backend import (ENV_VAR, CudaFusedBackend,
                                      LloydBackend, available_backends,
                                      get_backend, register_backend)


@pytest.fixture(scope="module")
def pts():
    return blobs(2000, n_clusters=5, dim=3, seed=2)[0]


@pytest.fixture(scope="module")
def jax_fit(pts):
    spec = JaxSpec.make(5, n_sub=5, compression=5)
    est = JaxSampledKMeans(spec).fit(jnp.asarray(pts), jax.random.PRNGKey(0))
    return spec, est


def test_jax_fit_serves_from_the_port(pts, jax_fit):
    spec, ref = jax_fit
    est = convert.estimator_from_numpy(spec.to_dict(),
                                       np.asarray(ref.centers_), device="cpu")
    assert est.spec.stable_hash() == spec.stable_hash()
    np.testing.assert_array_equal(est.predict(pts).numpy(),
                                  np.asarray(ref.predict(jnp.asarray(pts))))
    # the expanded form |x|^2 + |c|^2 - 2 x.c cancels: its absolute error is
    # a few ulps of |x|^2 + |c|^2, whatever the distance
    scale = 2.0 * float((pts ** 2).sum(1).max())
    np.testing.assert_allclose(est.transform(pts).numpy(),
                               np.asarray(ref.transform(jnp.asarray(pts))),
                               rtol=1e-5,
                               atol=4 * np.finfo(np.float32).eps * scale)
    np.testing.assert_allclose(float(est.score(pts)),
                               float(ref.score(jnp.asarray(pts))), rtol=1e-5)


def test_result_from_numpy(jax_fit):
    _, ref = jax_fit
    res = convert.result_from_numpy(*(np.asarray(f) for f in ref.result_),
                                    device="cpu")
    np.testing.assert_array_equal(res.centers.numpy(),
                                  np.asarray(ref.result_.centers))
    assert res.local_weights.shape == ref.result_.local_weights.shape
    with pytest.raises(ValueError, match="centers must be"):
        convert.estimator_from_numpy(JaxSpec.make(5).to_dict(),
                                     np.zeros((4, 3), np.float32),
                                     device="cpu")


def test_fit_is_sampled_kmeans_bit_for_bit(pts):
    spec = ClusterSpec.make(5, n_sub=5, compression=5)
    est = SampledKMeans(spec, device="cpu").fit(pts, seed=3)
    ref = sampled_kmeans(pts, 5, spec=spec, seed=3, device="cpu")
    assert torch.equal(est.centers_, ref.centers)
    assert torch.equal(est.sse_, ref.sse)
    labels = est.fit_predict(pts, seed=3)
    assert labels.dtype == torch.int32 and labels.shape == (2000,)


def test_predict_blocks_do_not_change_labels(pts):
    est = SampledKMeans(5, device="cpu").fit(pts)
    dense = est.predict(pts, block=None)
    for block in (7, 333, 2000):
        assert torch.equal(est.predict(pts, block=block), dense)
    torch.testing.assert_close(est.transform(pts, block=300),
                               est.transform(pts, block=None))
    torch.testing.assert_close(est.score(pts, block=256),
                               -est.transform(pts).amin(1).sum(),
                               rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("mode", ["shard_map", "chunked_dist"])
def test_mesh_modes_fit(pts, mode):
    """The two mesh modes fit through the facade on a mesh of two CPU
    entries: ``shard_map`` an array, ``chunked_dist`` a source; the
    estimator's device is the mesh's first entry."""
    from repro_torch.data import ArraySource
    from repro_torch.launch.mesh import make_mesh
    spec = ClusterSpec.make(5, n_sub=5, compression=5, mode=mode,
                            chunk_points=500)
    est = SampledKMeans(spec, mesh=make_mesh((2,), ("data",), ["cpu"] * 2))
    assert est.device == torch.device("cpu")
    est.fit(pts if mode == "shard_map" else ArraySource(pts), seed=3)
    assert est.centers_.shape == (5, 3)
    assert bool(torch.isfinite(est.centers_).all()) and float(est.sse_) > 0
    if mode == "chunked_dist":
        assert est.chunk_stats_.per_device_chunks == (2, 2)
    assert est.predict(pts).shape == (2000,)


@pytest.mark.parametrize("mode", ["chunked", "stream"])
def test_ported_modes_fit(pts, mode):
    """The two modes of the out-of-core slice fit an array: ``chunked`` as
    one chunk (the single fit bit for bit), ``stream`` as one update."""
    spec = ClusterSpec.make(5, n_sub=5, compression=5, mode=mode)
    est = SampledKMeans(spec, device="cpu").fit(pts, seed=3)
    assert est.centers_.shape == (5, 3)
    assert bool(torch.isfinite(est.centers_).all())
    if mode == "chunked":
        assert est.chunk_stats_.n_chunks == 1
        single = sampled_kmeans(pts, 5, spec=spec.replace(mode="single"),
                                seed=3, device="cpu")
        assert torch.equal(est.centers_, single.centers)
    else:
        assert int(est.stream_state.step) == 1 and est.sse_ is None
        assert est.predict(pts).shape == (2000,)


def test_partial_fit_folds_and_unfitted_calls_raise(pts):
    est = SampledKMeans(5, device="cpu")
    with pytest.raises(RuntimeError, match="fit first"):
        est.predict(np.zeros((10, 2), np.float32))
    est.partial_fit(pts[:1000])
    est.partial_fit(pts[1000:])
    assert int(est.stream_state.step) == 2
    assert float(est.stream_state.n_seen) == 2000.0
    assert est.predict(pts).shape == (2000,)


def test_plan_resolves_and_validates():
    pl = plan(ClusterSpec.make(5, donate=True), (1000, 2), device="cpu")
    assert pl.mode == "single" and pl.backend.name == "torch"
    assert pl.n_levels == 1 and pl.k == 5
    with pytest.raises(ValueError, match="representatives"):
        plan(ClusterSpec.make(500, n_sub=2, compression=50), (1000, 2),
             device="cpu")
    with pytest.raises(ValueError, match="unknown init"):
        plan(ClusterSpec.make(5, init="nope"), device="cpu")


def test_estimator_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SampledKMeans(5)
    with pytest.raises(RuntimeError, match="CUDA"):
        sampled_kmeans(np.zeros((100, 2), np.float32), 5)


def test_backend_registry(monkeypatch):
    assert {"torch", "cuda_fused", "auto"} <= set(available_backends())
    assert get_backend("auto", device="cpu").name == "torch"
    assert get_backend("auto", device="cuda").name == "cuda_tuned"
    assert get_backend(None).name == "cuda_tuned"   # entry points' default
    inst = CudaFusedBackend()
    assert get_backend(inst) is inst and inst == CudaFusedBackend()
    assert hash(inst) == hash(CudaFusedBackend())
    monkeypatch.setenv(ENV_VAR, "cuda_fused")
    assert get_backend("auto", device="cpu").name == "cuda_fused"
    assert get_backend("torch").name == "torch"     # explicit name wins
    with pytest.raises(ValueError, match="unknown k-means backend"):
        get_backend("pallas")

    class Tagged(LloydBackend):
        name = "tagged"

    register_backend("tagged", Tagged)
    try:
        assert get_backend("tagged").name == "tagged"
    finally:
        from repro_torch.core import backend as backend_mod
        backend_mod._REGISTRY.pop("tagged")


def test_cuda_fused_backend_on_cpu_tensors_is_the_plain_version(pts):
    """Given CPU tensors the kernel wrappers run their plain versions, so
    the cuda_fused backend computes exactly what the torch backend does."""
    spec = ClusterSpec.make(5, n_sub=5, compression=5)
    a = SampledKMeans(spec.replace(backend="cuda_fused"), device="cpu").fit(pts)
    b = SampledKMeans(spec.replace(backend="torch"), device="cpu").fit(pts)
    assert torch.equal(a.centers_, b.centers_)
    assert torch.equal(a.predict(pts), b.predict(pts))
