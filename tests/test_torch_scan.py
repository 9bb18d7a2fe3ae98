"""The ADC scan and the centroid update of the port (their plain versions,
which the kernel wrappers run for CPU tensors) against the JAX package's
Pallas kernels in interpret mode and its jnp versions; the wrappers'
device contract; and the unfused ``cuda`` Lloyd backend against the JAX package's
``pallas`` backend.

Tolerances: 1e-4 absolute for the scan (the reference tests' own, on
standard-normal tables where the sum over subspaces may cancel) and for the
centroid sums (f32 sums of a few hundred terms); the landmark fit at
rtol 1e-5 (SSE) and atol 1e-5 (centers)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ClusterSpec as JaxSpec
from repro.core import fit_from_spec as jax_fit
from repro.data.synthetic import blobs
from repro.kernels.ops import centroid_update as jax_centroid
from repro.kernels.scan import adc_scan_jnp, adc_scan_pallas
from repro_torch.core import ClusterSpec, fit_from_spec
from repro_torch.core.backend import (CudaBackend, CudaFusedBackend,
                                      LloydBackend, available_backends,
                                      get_backend)
from repro_torch.kernels import (TileError, adc_scan_cuda, centroid,
                                 centroid_update, scan)
from repro_torch.kernels.ref import adc_scan_ref, centroid_update_ref
from repro_torch.kernels.scan import check_codes

# tests/test_index.py's parametrisation
SCAN_SHAPES = [(1, 1, 16, 7), (3, 8, 256, 100), (4, 32, 16, 513),
               (2, 4, 256, 256), (1, 16, 16, 1)]


def _scan_inputs(seed, b, m, c, l):
    rng = np.random.default_rng(seed)
    luts = rng.standard_normal((b, m, c)).astype(np.float32)
    codes = rng.integers(0, c, (b, l, m)).astype(np.uint8)
    return luts, codes


@pytest.mark.parametrize("b,m,c,l", SCAN_SHAPES)
def test_adc_scan_matches_jax_kernel_and_jnp(b, m, c, l):
    luts, codes = _scan_inputs(b * 1000 + l, b, m, c, l)
    want_pallas = np.asarray(adc_scan_pallas(jnp.asarray(luts),
                                             jnp.asarray(codes),
                                             interpret=True))
    want_jnp = np.asarray(adc_scan_jnp(jnp.asarray(luts), jnp.asarray(codes)))
    tl, tc = torch.from_numpy(luts), torch.from_numpy(codes)
    for got in (adc_scan_ref(tl, tc), adc_scan_cuda(tl, tc),
                adc_scan_cuda(tl, tc.int())):
        assert got.shape == (b, l) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want_pallas, atol=1e-4)
        np.testing.assert_allclose(got.numpy(), want_jnp, atol=1e-4)


@pytest.mark.parametrize("c", [16, 256])
def test_adc_scan_bf16_tables(c):
    luts, codes = _scan_inputs(c, 2, 8, c, 333)
    lb = jnp.asarray(luts).astype(jnp.bfloat16)
    want = np.asarray(adc_scan_pallas(lb, jnp.asarray(codes), interpret=True))
    tl = torch.from_numpy(luts).bfloat16()
    got = adc_scan_cuda(tl, torch.from_numpy(codes))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(adc_scan_jnp(lb, jnp.asarray(codes))),
        atol=1e-4)


def test_adc_scan_contract():
    luts = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="do not match"):
        adc_scan_cuda(luts, torch.zeros(2, 10, 4, dtype=torch.uint8))
    with pytest.raises(TypeError):
        adc_scan_cuda(luts, torch.zeros(2, 10, 8, dtype=torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        adc_scan_cuda(torch.zeros(2, 16, 8).transpose(1, 2),
                      torch.zeros(2, 10, 8, dtype=torch.uint8))
    # a table above a block's shared memory is refused before any launch
    with pytest.raises(TileError):
        adc_scan_cuda(torch.zeros(1, 256, 256),
                      torch.zeros(1, 3, 256, dtype=torch.uint8))
    check_codes(torch.tensor([[0, 15]]), 16)
    with pytest.raises(ValueError, match="outside"):
        check_codes(torch.tensor([[0, 16]]), 16)


def test_plain_scan_serves_cpu_tensors_only():
    """The kernel wrapper never hands tensors off the CPU to the plain
    version (meta tensors stand in for CUDA ones here)."""
    luts = torch.zeros(1, 4, 16, device="meta")
    codes = torch.zeros(1, 5, 4, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        adc_scan_cuda(luts, codes)


def test_plain_versions_count_no_launch():
    """A launch counter moves only where its kernel launches: the plain
    versions that CPU tensors take leave it where it was."""
    scan_before, centroid_before = scan.launches, centroid.launches
    adc_scan_cuda(torch.zeros(1, 4, 16), torch.zeros(1, 5, 4,
                                                     dtype=torch.uint8))
    centroid_update(torch.zeros(1, 6, 2), torch.zeros(1, 6,
                                                      dtype=torch.int32),
                    torch.ones(1, 6), 3)
    assert (scan.launches, centroid.launches) == (scan_before,
                                                  centroid_before)


# ---------------------------------------------------------------------------
# centroid update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,m,d,k", [(1, 64, 4, 3), (2, 257, 16, 7),
                                     (3, 100, 33, 17), (1, 1024, 2, 128),
                                     (2, 700, 1, 256)])
def test_centroid_update_matches_jax_kernel(b, m, d, k):
    rng = np.random.default_rng(m + k)
    x = rng.normal(size=(b, m, d)).astype(np.float32)
    idx = rng.integers(0, k, (b, m)).astype(np.int32)
    w = rng.uniform(0, 1, (b, m)).astype(np.float32)
    w[:, ::7] = 0.0                               # masked slots ...
    idx[:, ::14] = -1                             # ... with ids outside [0, k)
    idx[:, 7::14] = k
    got = centroid_update(torch.from_numpy(x), torch.from_numpy(idx),
                          torch.from_numpy(w), k)
    assert all(t.dtype == torch.float32 for t in got)
    for lane in range(b):
        sums, counts = jax_centroid(jnp.asarray(x[lane]),
                                    jnp.asarray(idx[lane]),
                                    jnp.asarray(w[lane]), k, interpret=True)
        np.testing.assert_allclose(got[0][lane].numpy(), np.asarray(sums),
                                   atol=1e-4)
        np.testing.assert_allclose(got[1][lane].numpy(), np.asarray(counts),
                                   atol=1e-4)


def test_centroid_update_bf16_and_contract():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 300, 8)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 9, (2, 300)).astype(np.int32))
    w = torch.ones(2, 300)
    sums, counts = centroid_update(x.bfloat16(), idx, w.bfloat16(), 9)
    want = centroid_update_ref(x.bfloat16().float(), idx, w, 9)
    torch.testing.assert_close(sums, want[0], rtol=1e-5, atol=1e-5)
    assert torch.equal(counts, want[1])
    with pytest.raises(TypeError):
        centroid_update(x, idx.long(), w, 9)
    with pytest.raises(ValueError, match="must be"):
        centroid_update(x, idx[:, :5], w, 9)
    with pytest.raises(ValueError, match="empty"):
        centroid_update(x, idx, w, 0)


# ---------------------------------------------------------------------------
# the unfused "cuda" Lloyd backend
# ---------------------------------------------------------------------------

def test_cuda_backend_is_registered_and_unfused():
    assert {"torch", "cuda", "cuda_fused", "auto"} <= set(available_backends())
    be = get_backend("cuda")
    assert type(be) is CudaBackend and be.name == "cuda"
    assert isinstance(get_backend("cuda_fused"), CudaBackend)
    assert get_backend("auto", device="cuda").name == "cuda_tuned"
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(3, 200, 5)).astype(np.float32))
    w = torch.from_numpy((rng.uniform(size=(3, 200)) > 0.2).astype(np.float32))
    c = x[:, :9].clone()
    prep = be.prepare(x, w)
    got = be.step(prep, c)
    want = LloydBackend().step(prep, c)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    fused = CudaFusedBackend().step(prep, c)
    for a, b in zip(got, fused):
        assert torch.equal(a, b)


def test_cuda_backend_landmark_fit_matches_jax_pallas():
    """The unfused backend end to end on the randomness-free spec, against
    the JAX package's unfused ``pallas`` backend (interpret mode)."""
    pts = blobs(3000, n_clusters=6, dim=2, seed=3)[0]

    def spec(cls, backend):
        return cls.make(6, n_sub=4, compression=50, init="landmark",
                        local_iters=10, global_iters=10, restarts=2,
                        backend=backend)

    ref = jax_fit(jnp.asarray(pts), spec(JaxSpec, "pallas"))
    got = fit_from_spec(pts, spec(ClusterSpec, "cuda"), device="cpu")
    np.testing.assert_array_equal(got.local_weights.numpy(),
                                  np.asarray(ref.local_weights))
    np.testing.assert_allclose(got.local_centers.numpy(),
                               np.asarray(ref.local_centers), atol=1e-5)
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(ref.centers),
                               atol=1e-5)
    np.testing.assert_allclose(float(got.sse), float(ref.sse), rtol=1e-5)
