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
          (5, 3000, 5000, 2), (2, 1000, 300, 256), (1, 777, 8193, 160),
          (2, 300, 3000, 1024)]


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


def _check_lloyd_step(x, w, c, cancel, route=None):
    """The kernel (on ``route``, else on the one its shape picks) against
    the plain step: distances within 1e-4 relative plus ``cancel`` (the
    expanded form's rounding), labels equal but at near-ties (the plain
    distances to both candidates within ``cancel``), the statistics exactly
    the plain accumulation of the kernel's labels (counts; sums at 1e-4),
    the SSE at 1e-4, a repeat bit-identical, and one launch per
    ``lloyd_step`` call."""
    from repro_torch.kernels import lloyd, ref

    def step():
        if route is not None:
            return lloyd.route_step(x, w, c, route)
        before = lloyd.launches
        out = lloyd.lloyd_step(x, w, c)
        assert lloyd.launches == before + 1
        return out

    got = step()
    sums, counts, sse, idx, dist = got
    ridx, rdist = ref.assign_argmin_ref(x, c)
    assert float(((dist - rdist).abs() - 1e-4 * rdist).amax()) <= cancel
    diff = (idx != ridx).nonzero(as_tuple=True)
    if diff[0].numel():
        xs, cf = x.float()[diff], c.float()
        dk = ((xs - cf[diff[0], idx[diff].long()]) ** 2).sum(-1)
        dr = ((xs - cf[diff[0], ridx[diff].long()]) ** 2).sum(-1)
        assert float((dk - dr).abs().amax()) <= cancel
    psums, pcounts = ref.centroid_update_ref(x, idx, w, c.shape[1])
    assert torch.equal(counts, pcounts)
    torch.testing.assert_close(sums, psums, rtol=1e-4, atol=1e-4)
    wf = w.float()
    torch.testing.assert_close(
        sse, torch.where(wf != 0, rdist * wf, 0.0).sum(-1), rtol=1e-4,
        atol=0.0)
    again = step()
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    return got, ridx


def _cancel(x, c):
    """The expanded-form distance's worst-case f32 rounding at width d
    (chip_smoke.dot_rounding_bound)."""
    x2 = float((x.float() ** 2).sum(-1).amax())
    c2 = float((c.float() ** 2).sum(-1).amax())
    eps = torch.finfo(torch.float32).eps
    return (x.shape[-1] + 2) * eps * (x2 + c2 + 2 * (x2 * c2) ** 0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,m,k,d", [(2, 1000, 300, 128), (1, 777, 8193, 64),
                                     (3, 500, 129, 96), (2, 100, 17, 33),
                                     (2, 300, 3000, 33), (2, 300, 70, 31),
                                     (1, 300, 65536, 64),
                                     (2, 1000, 300, 256),
                                     (1, 777, 8193, 160),
                                     (2, 300, 3000, 1024)])
def test_lloyd_routes_match_plain(dev, b, m, k, d, dtype):
    """Shapes on both sides of the route threshold, ragged M and K, d not a
    multiple of 8, bf16 inputs, more clusters than the tensor-core route's
    statistics take, d past 128 (the tensor-core block streams its
    points): through ``lloyd_step`` (the route its shape picks), then on
    each route that takes the shape."""
    from repro_torch.kernels import tiles
    x, w, c = _inputs(dev, b, m, k, d, dtype=dtype, seed=21)
    cancel = _cancel(x, c)
    _check_lloyd_step(x, w, c, cancel)
    tc = d >= tiles.TC_MIN_D and tiles.sort_clusters_fit(k)
    for route in ("simt", "tc") if tc else ("simt",):
        _check_lloyd_step(x, w, c, cancel, route)


def test_lloyd_tc_route_exact_ties(dev):
    """d = 128: all-zero centers (the empty cache's first refresh) give
    every point center 0; a duplicated center loses to its lower copy; the
    zero-weight rows add nothing; the tensor-core route's statistics come
    from the centroid kernel, counted apart."""
    from repro_torch.kernels import centroid, lloyd
    x, w, _ = _inputs(dev, 2, 1024, 1, 128, seed=22)
    zero = torch.zeros((2, 8192, 128), device=dev)
    pool = torch.cat([zero, x], 1)
    wp = torch.cat([torch.zeros((2, 8192), device=dev), w], 1)
    c0, l0 = centroid.launches, lloyd.centroid_launches
    (sums, counts, _, idx, dist), ridx = _check_lloyd_step(
        pool, wp, zero, _cancel(pool, zero))
    assert centroid.launches == c0 and lloyd.centroid_launches == l0 + 2
    assert torch.equal(idx, ridx) and not idx.any()
    assert torch.equal(counts[:, 0], w.sum(1)) and not counts[:, 1:].any()
    x3, w3, c3 = _inputs(dev, 1, 600, 300, 128, seed=23)
    c3[0, 200] = c3[0, 37]                      # center 200 copies 37
    x3[0, :50] = c3[0, 37]                      # points exactly on it
    got, ridx = _check_lloyd_step(x3, w3, c3, _cancel(x3, c3))
    assert not (got[3] == 200).any() and (got[3][0, :50] == 37).all()


def test_lloyd_simt_route_plan(dev):
    """The SIMT grid holds every block at once: at the paper's local and
    merge and the PQ shapes, the runtime's occupancy (registers included)
    is at most the shared-memory and thread reckoning's, and the grid fits
    it."""
    from repro_torch.kernels import lloyd, tiles
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b, m, k, d in ((64, 7813, 1562, 2), (64, 32768, 256, 1),
                       (4, 99968, 1000, 2)):
        per_sm, smem = lloyd.simt_occupancy(k, d)
        assert smem == tiles.lloyd_simt_smem_bytes(k, d)
        assert per_sm <= tiles.blocks_per_sm(smem)
        assert b * tiles.lloyd_blocks(b, m, k, d, sms, per_sm) <= per_sm * sms


@pytest.mark.parametrize("b,m,k,d", SHAPES)
def test_assign_kernel_matches_plain(dev, b, m, k, d):
    from repro_torch.kernels import assign, ref
    x, _, c = _inputs(dev, b, m, k, d, seed=1)
    idx, dist = assign.assign_argmin(x, c)
    ridx, rdist = ref.assign_argmin_ref(x, c)
    assert (idx == ridx).float().mean() > 0.99
    torch.testing.assert_close(dist, rdist, rtol=1e-4, atol=1e-5)


def _assign_case(dev, case, b, m, k, d):
    """Inputs of the assignment's route tests: exact ties (a center copied
    to a later index, points on it), all-zero centers (every distance
    ties), points far from 0 with centers a hair away (the expanded form's
    rounding exceeds the distances, so many fall below 0 before the
    clamp), bf16 points and centers, or one point set shared by all lanes
    (batch stride 0); ragged M throughout."""
    x, _, c = _inputs(dev, b, m, k, d, seed=31)
    if case == "ties":
        c[:, k - 3] = c[:, 5]
        x[:, :40] = c[:, 5:6]
    elif case == "zero_centers":
        c = torch.zeros_like(c)
    elif case == "cancel":
        x = x + 1000.0
        c = x[:, :k] + 1e-3 * torch.randn(c.shape, device=dev,
                                          generator=torch.Generator(
                                              device=dev).manual_seed(32))
    elif case == "bf16":
        x, c = x.bfloat16(), c.bfloat16()
    elif case == "shared":
        x = x[:1].expand(b, -1, -1)
    return x, c


@pytest.mark.parametrize("case", ["ties", "zero_centers", "cancel", "bf16",
                                  "shared"])
@pytest.mark.parametrize("route,m,d", [("simt", 150_001, 2),
                                       ("simt", 1001, 8),
                                       ("simt", 777, 64), ("tc", 777, 64),
                                       ("tc", 3001, 32), ("tc", 777, 256)])
def test_assign_routes_match_plain(dev, case, route, m, d):
    """Both routes, with the SIMT route's register tile (150,001 points
    at d = 2) and without it: labels equal the plain version's but at
    near-ties within the expanded form's rounding bound, exact ties to the
    lowest index, distances within 1e-4 relative plus that bound, a repeat
    bit-identical; at small d the SIMT route equals the Lloyd kernel's
    SIMT route bit for bit."""
    from repro_torch.kernels import assign, lloyd, ref
    b, k = 3, 301
    x, c = _assign_case(dev, case, b, m, k, d)
    idx, dist = assign.route_argmin(x, c, route)
    ridx, rdist = ref.assign_argmin_ref(x, c)
    cancel = _cancel(x, c)
    assert float(((dist - rdist).abs() - 1e-4 * rdist).amax()) <= cancel
    diff = (idx != ridx).nonzero(as_tuple=True)
    if diff[0].numel():
        xs, cf = x.float()[diff], c.float()
        dk = ((xs - cf[diff[0], idx[diff].long()]) ** 2).sum(-1)
        dr = ((xs - cf[diff[0], ridx[diff].long()]) ** 2).sum(-1)
        assert float((dk - dr).abs().amax()) <= cancel
    if case == "ties":
        assert (idx[:, :40] == 5).all() and not (idx == k - 3).any()
    if case == "zero_centers":
        assert not idx.any()
    again = assign.route_argmin(x, c, route)
    assert torch.equal(again[0], idx) and torch.equal(again[1], dist)
    if route == "simt" and d <= 16:
        w = torch.ones((b, m), device=dev)
        *_, lidx, ldist = lloyd.route_step(x, w, c, "simt")
        assert torch.equal(idx, lidx) and torch.equal(dist, ldist)


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


@pytest.mark.parametrize("b,m,k,d,ids", [
    (1, 64, 3, 4, "uniform"), (3, 257, 7, 16, "uniform"),
    (2, 1000, 256, 1, "uniform"), (2, 500, 300, 64, "uniform"),
    (1, 300, 40, 200, "uniform"), (2, 2000, 5000, 2, "uniform"),
    # the sort path (the accumulator does not fit shared memory)
    (2, 3000, 4096, 128, "uniform"), (2, 3000, 4096, 128, "skewed"),
    (2, 3000, 4096, 128, "one"), (2, 300, 8192, 128, "uniform"),
    (3, 700, 2000, 64, "skewed"),
    # the warp path with skewed ids
    (4, 5000, 1000, 2, "skewed"), (3, 2000, 64, 2, "one")])
def test_centroid_kernel_matches_plain(dev, b, m, k, d, ids):
    """Uniform ids, skewed ids (a power law: most points in few clusters),
    or every point in one cluster; K > M leaves most clusters empty."""
    from repro_torch.kernels import centroid, ref
    x, w, _ = _inputs(dev, b, m, k, d, seed=3)
    g = torch.Generator(device=dev).manual_seed(4)
    if ids == "uniform":
        idx = torch.randint(0, k, (b, m), generator=g, device=dev,
                            dtype=torch.int32)
    elif ids == "skewed":
        u = torch.rand((b, m), generator=g, device=dev)
        idx = (k * u ** 4).to(torch.int32).clamp_max(k - 1)
    else:
        idx = torch.full((b, m), k // 2, device=dev, dtype=torch.int32)
    idx[:, ::9] = -1                  # masked ids outside [0, k) add nothing
    idx[:, 4::9] = k
    before = centroid.launches
    sums, counts = centroid.centroid_update(x, idx, w, k)
    assert centroid.launches == before + 1
    want = ref.centroid_update_ref(x, idx, w, k)
    assert torch.equal(counts, want[1])          # integer weights: exact
    torch.testing.assert_close(sums, want[0], rtol=1e-4, atol=1e-4)
    again = centroid.centroid_update(x, idx, w, k)
    assert torch.equal(again[0], sums) and torch.equal(again[1], counts)


@pytest.mark.parametrize("b,l,m,c", [(1, 7, 1, 16), (3, 100, 8, 256),
                                     (4, 513, 32, 16), (128, 1500, 64, 256),
                                     (2, 300, 5, 256)])
def test_adc_scan_kernel_matches_plain(dev, b, l, m, c):
    from repro_torch.kernels import ref, scan
    g = torch.Generator(device=dev).manual_seed(5)
    luts = torch.rand((b, m, c), generator=g, device=dev)
    codes = torch.randint(0, c, (b, l, m), generator=g, device=dev,
                          dtype=torch.uint8)
    want = ref.adc_scan_ref(luts, codes)
    before = scan.launches
    got = scan.adc_scan_cuda(luts, codes)
    assert scan.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(scan.adc_scan_cuda(luts, codes.int()), want,
                               rtol=1e-5, atol=1e-6)
    lb = luts.bfloat16()
    torch.testing.assert_close(scan.adc_scan_cuda(lb, codes),
                               ref.adc_scan_ref(lb, codes), rtol=1e-5,
                               atol=1e-6)
    # rows that do not start on a 16-byte boundary take narrower loads
    off = torch.empty(b * l * m + 1, dtype=torch.uint8, device=dev)[1:]
    off.copy_(codes.reshape(-1))
    torch.testing.assert_close(scan.adc_scan_cuda(luts, off.view(b, l, m)),
                               want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b,l,m,dtype", [
    (3, 700, 64, torch.bfloat16),   # a bf16 table stays bf16 on the card
    (4, 333, 7, torch.float32),     # m not a multiple of 4: byte loads
    (5, 100, 32, torch.float32),    # L shorter than one tile
    (300, 90, 16, torch.float32),   # more entries than the card has SMs
    (2, 20_000, 96, torch.float32)])  # rows longer than one 64-code batch
def test_adc_scan_plans_match_plain(dev, b, l, m, dtype):
    """The scan against its plain version (1e-5 relative: the sums are the
    plain version's terms in the same order) on the plan's grid: one wave
    wherever the entries fit, a repeat bit-identical."""
    from repro_torch.kernels import ref, scan, tiles
    g = torch.Generator(device=dev).manual_seed(7)
    luts = torch.rand((b, m, 256), generator=g, device=dev).to(dtype)
    codes = torch.randint(0, 256, (b, l, m), generator=g, device=dev,
                          dtype=torch.uint8)
    p = scan.plan(luts, codes)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = scan.occupancy(m, 256, dtype == torch.bfloat16,
                            tiles.code_vector_bytes(m, codes.data_ptr(),
                                                    codes.stride(0)))
    assert 1 <= p.blocks <= -(-l // tiles.THREADS)
    assert b * p.blocks <= max(b, per_sm * sms)
    got = scan.adc_scan_cuda(luts, codes)
    want = ref.adc_scan_ref(luts, codes)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
    assert torch.equal(scan.adc_scan_cuda(luts, codes), got)


def test_cuda_backend_fit_and_index_run_through_the_kernels(dev):
    import numpy as np
    from repro_torch.api import SampledKMeans
    from repro_torch.core import ClusterSpec
    from repro_torch.data import blobs
    from repro_torch.index import (IndexSpec, build_index, exact_search,
                                   recall_at_k)
    from repro_torch.kernels import assign, centroid, lloyd, scan
    pts = blobs(3000, n_clusters=6, dim=2, seed=3)[0]
    spec = ClusterSpec.make(6, n_sub=6, compression=5, backend="cuda")
    l0, c0 = lloyd.launches, centroid.launches
    est = SampledKMeans(spec).fit(pts, seed=0)
    assert lloyd.launches == l0 and centroid.launches - c0 == 37
    again = SampledKMeans(spec).fit(pts, seed=0)
    assert torch.equal(est.centers_, again.centers_)
    rng = np.random.default_rng(3)
    centers = rng.uniform(0, 10, (16, 8)).astype(np.float32)
    x = (centers[rng.integers(0, 16, 6000)]
         + rng.normal(0, 0.35, (6000, 8))).astype(np.float32)
    q = (centers[rng.integers(0, 16, 48)]
         + rng.normal(0, 0.35, (48, 8))).astype(np.float32)
    ispec = IndexSpec.make(nlist=16, n_subspaces=8, bits=8, nprobe=4,
                           train_points=1500, n_sub=4, chunk_points=1024)
    s0, a0, l0 = scan.launches, assign.launches, lloyd.launches
    index, _ = build_index(x, ispec, 5)
    _, ids = index.search(q, k=10)
    assert scan.launches > s0 and assign.launches > a0
    assert lloyd.launches > l0
    _, true_ids = exact_search(x, q, k=10)
    assert recall_at_k(ids, true_ids) >= 0.9


def _attn_inputs(dev, b, h, hkv, nc, dh, dtype=torch.float32, seed=6):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, h, dh), generator=g, device=dev).to(dtype)
    kc = torch.randn((b, hkv, nc, dh), generator=g, device=dev).to(dtype)
    vc = torch.randn((b, hkv, nc, dh), generator=g, device=dev).to(dtype)
    cnt = torch.randint(0, 50, (b, hkv, nc), generator=g,
                        device=dev).float()
    return q, kc, vc, cnt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,nc,dh", [(4, 32, 8, 1000, 128),
                                           (1, 4, 1, 64, 32),
                                           (2, 8, 2, 300, 64),
                                           (3, 48, 8, 777, 128),
                                           (1, 32, 8, 8192, 128),
                                           (1, 8, 1, 20000, 128),
                                           (2, 16, 4, 100, 16),
                                           (1, 32, 32, 8192, 80),
                                           (2, 16, 4, 777, 80)])
def test_cluster_attn_kernel_matches_plain(dev, b, h, hkv, nc, dh, dtype):
    """One split (Nc = 64, 100), many (8192 and 20000 centroids), and Nc
    not a multiple of the split (777, 20000) or of the ring stage; dh = 80
    (zamba2's, at G = 1 and G = 4), whose rows are not a power-of-two
    number of 16-byte pieces; a repeated launch is bit-identical."""
    from repro_torch.kernels import cluster_attn, ref
    q, kc, vc, cnt = _attn_inputs(dev, b, h, hkv, nc, dh, dtype)
    before = cluster_attn.launches
    got = cluster_attn.cluster_attn_partial(q, kc, vc, cnt, dh ** -0.5)
    assert cluster_attn.launches == before + 1
    want = ref.cluster_attn_decode_ref(q, kc, vc, cnt, dh ** -0.5)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=3e-4, atol=3e-4)
    again = cluster_attn.cluster_attn_partial(q, kc, vc, cnt, dh ** -0.5)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


def test_cluster_attn_dead_and_all_dead_rows(dev):
    """Poisoned dead values change nothing; an all-dead row gives the
    sentinel max, l = Nc and the sum of its values."""
    from repro_torch.kernels import cluster_attn, ref
    q, kc, vc, cnt = _attn_inputs(dev, 2, 8, 2, 1024, 128, torch.bfloat16)
    cnt[..., ::2] = 0.0
    out1 = cluster_attn.cluster_attn_decode(q, kc, vc, cnt, 0.1)
    vc2 = vc.clone()
    vc2[..., ::2, :] = 1e6
    assert torch.equal(cluster_attn.cluster_attn_decode(q, kc, vc2, cnt, 0.1),
                       out1)
    cnt[0] = 0.0
    acc, m, l = cluster_attn.cluster_attn_partial(q, kc, vc, cnt, 0.1)
    assert torch.all(m[0] == ref.NEG) and torch.all(l[0] == 1024.0)
    torch.testing.assert_close(acc[0], vc[0].float().sum(1)[:, None]
                               .expand_as(acc[0]), rtol=1e-4, atol=1e-3)
