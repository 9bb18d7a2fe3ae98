"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``; every test skips where no CUDA device is available (the
decision is made inside the fixture, never at import).  On a machine with
an H100 and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, m, k, d, dtype=torch.float32, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((b, m, d), generator=g, device=dev)
    c = torch.rand((b, k, d), generator=g, device=dev)
    w = (torch.rand((b, m), generator=g, device=dev) > 0.1).float()
    return x.to(dtype), w.to(dtype), c.to(dtype)


SHAPES = [(1, 64, 3, 4), (3, 257, 7, 16), (2, 100, 17, 33),
          (1, 512, 300, 128), (2, 1024, 128, 2), (1, 300, 40, 200),
          (5, 3000, 5000, 2)]


@pytest.mark.parametrize("b,m,k,d", SHAPES)
def test_lloyd_kernel_matches_plain(dev, b, m, k, d):
    from repro_torch.kernels import lloyd, ref
    x, w, c = _inputs(dev, b, m, k, d)
    before = lloyd.launches
    got = lloyd.lloyd_step(x, w, c)
    assert lloyd.launches == before + 1
    want = ref.lloyd_step_ref(x, w, c)
    assert (got[3] == want[3]).float().mean() > 0.99
    sums, counts = ref.centroid_update_ref(x, got[3], w, k)
    assert torch.equal(got[1], counts)           # integer weights: exact
    torch.testing.assert_close(got[0], sums, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0.0)
    torch.testing.assert_close(got[4], want[4], rtol=1e-4, atol=1e-5)
    again = lloyd.lloyd_step(x, w, c)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("b,m,k,d", SHAPES)
def test_assign_kernel_matches_plain(dev, b, m, k, d):
    from repro_torch.kernels import assign, ref
    x, _, c = _inputs(dev, b, m, k, d, seed=1)
    idx, dist = assign.assign_argmin(x, c)
    ridx, rdist = ref.assign_argmin_ref(x, c)
    assert (idx == ridx).float().mean() > 0.99
    torch.testing.assert_close(dist, rdist, rtol=1e-4, atol=1e-5)


def test_bf16_and_shared_point_set(dev):
    from repro_torch.kernels import lloyd, ref
    x, w, c = _inputs(dev, 1, 4000, 50, 8, dtype=torch.bfloat16, seed=2)
    got = lloyd.lloyd_step(x.expand(3, -1, -1), w.expand(3, -1),
                           c.expand(3, -1, -1).contiguous())
    want = ref.lloyd_step_ref(x, w, c)
    for lane in range(3):
        torch.testing.assert_close(got[2][lane], want[2][0], rtol=1e-4,
                                   atol=0.0)


def test_ties_go_to_the_lowest_index(dev):
    from repro_torch.kernels import assign
    x = torch.tensor([[[0.0, 0.0], [2.0, 0.0], [5.0, 5.0]]], device=dev)
    c = torch.tensor([[[1.0, 0.0], [-1.0, 0.0], [5.0, 5.0], [5.0, 5.0],
                       [3.0, 0.0]]], device=dev)
    idx, _ = assign.assign_argmin(x, c)
    assert idx[0].tolist() == [0, 0, 2]


def test_fit_runs_through_the_kernels(dev):
    from repro_torch.api import SampledKMeans
    from repro_torch.core import ClusterSpec, relative_error, standard_kmeans
    from repro_torch.data import blobs
    from repro_torch.kernels import assign, lloyd
    # the paper's claim at tests/test_pipeline.py's size and bound
    pts = blobs(3000, n_clusters=6, dim=2, seed=3)[0]
    spec = ClusterSpec.make(6, n_sub=6, compression=5)
    l0, a0 = lloyd.launches, assign.launches
    est = SampledKMeans(spec).fit(pts, seed=0)
    labels = est.predict(pts)
    # 10 + 1 local (one launch for all 6 partitions), 25 + 1 merge (one
    # launch for all 4 restarts); predict is one assignment launch
    assert lloyd.launches - l0 == 37 and assign.launches - a0 == 1
    assert labels.shape == (3000,)
    again = SampledKMeans(spec).fit(pts, seed=0)
    assert torch.equal(est.centers_, again.centers_)
    full = standard_kmeans(pts, 6, iters=30, seed=0)
    assert relative_error(float(est.sse_), float(full.sse)) < 0.10
