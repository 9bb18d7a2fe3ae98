"""The port's roofline layer (``repro_torch.roofline.analysis``) against
the JAX package's (``repro.roofline.analysis``) on the CPU: the ring model
against the reference's HLO parser, ``PartCost`` and ``model_flops``
against the reference's, the kernel models against the reference's with
the TPU-schedule terms they leave out pinned, the bounds at the kernel
table's shapes (PERF.md), and the tensor-based bounds against the
dims-based models."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.roofline import analysis as ref
from repro_torch import configs
from repro_torch.roofline import analysis as rl

# one hand-written HLO line an op: (line, result bytes, group size).  The
# reference reads a group size from ``replica_groups`` only, so the
# permute's line carries one beside its pairs.
HLO = {
    "all-gather": (
        "%ag = f32[8,128]{1,0} all-gather(f32[2,128]{1,0} %p0), "
        "channel_id=1, replica_groups={{0,1,2,3}}, dimensions={0}",
        8 * 128 * 4, 4),
    "reduce-scatter": (
        "%rs = bf16[2,128]{1,0} reduce-scatter(bf16[8,128]{1,0} %p1), "
        "channel_id=2, replica_groups={{0,1,2,3}}, dimensions={0}, "
        "to_apply=%add", 2 * 128 * 2, 4),
    "all-reduce": (
        "%ar = f32[1024]{0} all-reduce(f32[1024]{0} %p2), channel_id=3, "
        "replica_groups=[2,8]<=[16], to_apply=%add", 1024 * 4, 8),
    "all-to-all": (
        "%a2a = s32[16,64]{1,0} all-to-all(s32[16,64]{1,0} %p3), "
        "channel_id=4, replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}",
        16 * 64 * 4, 8),
    "collective-permute": (
        "%cp = f32[4,4]{1,0} collective-permute-start(f32[4,4]{1,0} %p4), "
        "channel_id=5, source_target_pairs={{0,1},{1,0}}, "
        "replica_groups={{0,1}}", 4 * 4 * 4, 2),
}


@pytest.mark.parametrize("op", list(HLO))
def test_ring_bytes_matches_the_reference_parser(op):
    line, nbytes, n = HLO[op]
    parsed = ref.parse_collective_bytes(line)
    assert parsed["counts"][op] == 1
    assert rl.ring_bytes(op, nbytes, n) == parsed[op] == parsed["total"] > 0
    assert rl.ring_bytes(op, nbytes, 1) == 0.0


def test_ring_bytes_refuses_an_unknown_op():
    with pytest.raises(ValueError):
        rl.ring_bytes("all-to-some", 8, 2)


def test_partcost_arithmetic_matches_the_reference():
    a = dict(flops=3.0e12, bytes=5.5e9, coll=2.0e6,
             coll_by_op={"all-gather": 1.5e6, "reduce-scatter": 0.5e6})
    b = dict(flops=1.0e12, bytes=0.5e9, coll=1.0e6,
             coll_by_op={"all-gather": 1.0e6, "all-to-all": 7.0})
    pa, pb = rl.PartCost(**a), rl.PartCost(**b)
    ra, rb = ref.PartCost(**a), ref.PartCost(**b)
    for got, want in ((pa + pb, ra + rb), (pa - pb, ra - rb),
                      (pa.scaled(2.5), ra.scaled(2.5)),
                      ((pa - pb).scaled(32) + pb, (ra - rb).scaled(32) + rb)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(rl.PartCost)] == [
        f.name for f in dataclasses.fields(ref.PartCost)]


def test_model_flops_match_the_reference_for_every_cell():
    n = 0
    for arch, shape_name, ok, _ in configs.cells():
        if not ok:
            continue
        shape = configs.SHAPES[shape_name]
        got = rl.model_flops(configs.get_config(arch), shape, shape.kind)
        want = ref.model_flops(jax_configs.get_config(arch),
                               jax_configs.SHAPES[shape_name], shape.kind)
        assert got == want > 0, (arch, shape_name)
        n += 1
    assert n >= 30


def test_roofline_terms_use_the_h100_roofs():
    """Compute over the BF16 peak and bytes over HBM, each of the whole
    step's over the chips; the link bytes (one chip's) over NVLink."""
    total = rl.PartCost(989e12 * 8, 3.35e12 * 4, 450e9 * 0.5)
    terms = rl.roofline_terms(total, chips=8)
    assert terms == pytest.approx({"compute_s": 1.0, "memory_s": 0.5,
                                   "collective_s": 0.5}, rel=1e-12)
    assert rl.dominant_term(terms) == "compute_s"
    assert rl.roofline_terms(total) == pytest.approx(
        {"compute_s": 8.0, "memory_s": 4.0, "collective_s": 0.5}, rel=1e-12)
    roof = rl.device_roof("NVIDIA H100 80GB HBM3")
    assert roof is rl.DEVICE_ROOFS["H100"] is rl.device_roof("some card")
    assert (roof["peak_flops"], roof["tf32_flops"], roof["fp32_flops"],
            roof["hbm_bw"], roof["link_bw"]) == (989e12, 495e12, 67e12,
                                                 3.35e12, 450e9)


@pytest.mark.parametrize("m,k,d", [(7813, 1562, 2), (4096, 819, 64),
                                   (300, 50, 200), (99_968, 1000, 2)])
def test_kernel_cost_drops_only_the_tpu_schedule_terms(m, k, d):
    """The pair term is the reference's distance term; the reference's
    one-hot accumulation matmul and its centers streamed again for every
    ``block_m`` tile (the scan's tables for every ``block_l`` tile) are
    the only differences."""
    dims = dict(m=m, k=k, d=d)
    onehot = 2.0 * m * k * d + 2.0 * m * k
    restream = 4.0 * k * d * (math.ceil(m / 256) - 1)
    for kernel, extra_flops in (("lloyd", onehot), ("assign", 0.0)):
        got = rl.kernel_cost(kernel, **dims)
        want = ref.kernel_cost(kernel, **dims)
        assert got.flops == 2.0 * m * k * d + 3.0 * m * k
        assert want.flops - got.flops == extra_flops
        assert want.bytes - got.bytes == restream
    got, want = rl.kernel_cost("centroid", **dims), ref.kernel_cost(
        "centroid", **dims)
    assert want.flops == onehot and got.flops == m * (2 * d + 1)
    assert got.bytes == want.bytes
    b, l, msub, c = 3, m, 16, 256
    got = rl.kernel_cost("scan", b=b, l=l, msub=msub, c=c, code_bytes=4)
    want = ref.kernel_cost("scan", b=b, l=l, msub=msub, c=c)
    assert want.flops == 2.0 * b * l * msub * c and got.flops == b * l * msub
    assert want.bytes - got.bytes == 4.0 * b * msub * c * (
        math.ceil(l / 256) - 1)


# (kernel, route, dims, PERF.md's Bound ms, bound by): the kernel table's
# shapes; "3 passes" are f32 points (every block three TF32 passes), "2
# passes" bf16-valued ones (lo_rows 0)
TABLE = [
    ("lloyd", "simt", dict(b=64, m=7813, k=1562, d=2), "0.0816", "operations"),
    ("lloyd", "simt", dict(b=4, m=99_968, k=1000, d=2, x_lanes=1), "0.0418",
     "operations"),
    ("lloyd", "simt", dict(b=64, m=32_768, k=256, d=1), "0.0401",
     "operations"),
    ("lloyd", "tc", dict(b=256, m=9216, k=8192, d=128), "29.99",
     "operations"),
    ("lloyd", "tc", dict(b=256, m=9216, k=8192, d=128, lo_rows=0), "19.99",
     "operations"),
    ("lloyd", "tc", dict(b=4, m=9216, k=8192, d=128), "0.4685", "operations"),
    ("lloyd", "tc", dict(b=8, m=4096, k=819, d=64), "0.0208", "operations"),
    ("lloyd", "tc", dict(b=8, m=8192, k=1638, d=32), "0.0416", "operations"),
    ("lloyd", "simt", dict(b=16, m=16_384, k=256, d=8), "0.0190",
     "operations"),
    ("lloyd", "simt", dict(b=64, m=9216, k=8192, d=256), "37.14",
     "operations"),
    ("lloyd", "tc", dict(b=192, m=9216, k=8192, d=80, lo_rows=0), "9.371",
     "operations"),
    ("lloyd", "simt", dict(b=1, m=4096, k=16, d=1), "0.0000196", "bytes"),
    ("assign", "simt", dict(b=1, m=500_000, k=1000, d=2), "0.0522",
     "operations"),
    ("assign", "tc", dict(b=1, m=1_048_576, k=1024, d=32), "0.4165",
     "operations"),
    ("centroid", "simt", dict(b=64, m=7813, k=1562, d=2), "0.00275", "bytes"),
    ("centroid", "simt", dict(b=256, m=9216, k=8192, d=128), "0.6892",
     "bytes"),
    ("scan", "simt", dict(b=128, l=1586, msub=64, c=256), "0.00662", "bytes"),
    ("cluster_attn", "simt", dict(b=1, h=32, hkv=8, nc=8192, dh=128,
                                  dtype_bytes=2), "0.0101", "bytes"),
    ("cluster_attn", "simt", dict(b=4, h=32, hkv=8, nc=1000, dh=128,
                                  dtype_bytes=2), "0.00496", "bytes"),
    ("cluster_attn", "simt", dict(b=1, h=16, hkv=8, nc=8192, dh=256,
                                  dtype_bytes=2), "0.02012", "bytes"),
    ("cluster_attn", "simt", dict(b=1, h=32, hkv=32, nc=8192, dh=80,
                                  dtype_bytes=2), "0.02536", "bytes"),
]


@pytest.mark.parametrize("kernel,route,dims,want,by", TABLE)
def test_bounds_at_the_kernel_tables_shapes(kernel, route, dims, want, by):
    """Each bound equals PERF.md's to the digits the table prints, and
    ``predicted_vs_measured`` predicts exactly that bound."""
    ms, got_by = rl.kernel_bound_ms(kernel, route=route, **dims)
    decimals = len(want.split(".")[1])
    assert abs(ms - float(want)) <= 0.5 * 10 ** -decimals, ms
    assert got_by == by
    p = rl.predicted_vs_measured(kernel, 2 * ms / 1e3,
                                 device_kind="NVIDIA H100 80GB HBM3",
                                 route=route, **dims)
    assert p["predicted_s"] * 1e3 == ms
    assert p["dominant"] == {"operations": "compute", "bytes": "memory"}[by]
    assert p["efficiency"] == pytest.approx(0.5, rel=1e-12)
    assert set(p) == {"flops", "bytes", "compute_s", "memory_s",
                      "predicted_s", "dominant", "measured_s", "efficiency"}


def test_the_issue_floor_and_the_fp32_bound_of_the_table():
    """The predict shape's issue floor at 132 SMs x 128 lanes x 1.98 GHz
    (0.1196 ms) and the refresh's FP32 bound beside its tensor-core one
    (74.71 ms)."""
    assert abs(rl.issue_floor_ms(1, 500_000, 1000, 2, 132, 1.98e9)
               - 0.1196) <= 5e-5
    ms, by = rl.pair_bound_ms(256, 9216, 8192, 128, 0, 0)
    assert abs(ms - 74.71) <= 5e-3 and by == "operations"


def _old_bound_ms(ops, n_bytes):
    """The bound as the on-card script reckoned it before it moved into
    the package: FP32 operations or bytes, the larger time."""
    t_ops, t_bytes = ops / 67e12 * 1e3, n_bytes / 3.35e12 * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _old_tc_bound_ms(x, k):
    """The cross term's TF32 passes as the script reckoned them: passes x
    rows a block at the TF32 peak."""
    from repro_torch.kernels import tiles
    b, m, d = x.shape
    rows = torch.full((-(-m // tiles.TC_ROWS),), tiles.TC_ROWS)
    rows[-1] = m - (rows.numel() - 1) * tiles.TC_ROWS
    passes = 2 + rl.tc_lo_blocks(x).long().cpu()
    return float((passes * rows).sum()) * 2 * k * d / 495e12 * 1e3


def test_tensor_bounds_equal_the_models_on_their_dims():
    """On CPU tensors: the tensor-core blocks of three passes counted from
    the points, and ``kernel_bound_ms`` on ``kernel_dims`` of each
    kernel's inputs equal to the bound the script reckoned from the same
    tensors (and to ``predicted_vs_measured``'s prediction)."""
    g = np.random.default_rng(0)
    x = torch.from_numpy(g.random((3, 300, 40), dtype=np.float32))
    x[1] = x[1].bfloat16().float()          # lane 1 exact in TF32
    x[2, 128:256] = x[2, 128:256].bfloat16().float()
    w = torch.ones(3, 300)
    c = x[:, :17].clone()
    lo = rl.tc_lo_blocks(x)
    assert lo.tolist() == [[True] * 3, [False] * 3, [True, False, True]]
    assert rl.tc_lo_rows(x) == 300 + 128 + 44
    n_bytes = (x.numel() + w.numel() + c.numel()) * 4 + 3 * 300 * 8 \
        + 3 * 17 * 41 * 4 + 3 * 4
    tc_ops = max(_old_tc_bound_ms(x, 17), 3 * 300 * 17 * 3 / 67e12 * 1e3)
    tc_bytes = n_bytes / 3.35e12 * 1e3
    old = {"simt": _old_bound_ms(3 * 300 * 17 * (2 * 40 + 3), n_bytes),
           "tc": ((tc_ops, "operations") if tc_ops >= tc_bytes
                  else (tc_bytes, "bytes"))}
    for route in ("simt", "tc"):
        dims = rl.kernel_dims("lloyd", x, w, c, route=route)
        assert dims["x_lanes"] == dims["w_lanes"] == 3
        assert rl.kernel_cost("lloyd", **dims).bytes == n_bytes
        bound = rl.kernel_bound_ms("lloyd", route=route, **dims)
        assert bound[1] == old[route][1]
        assert bound[0] == pytest.approx(old[route][0], rel=1e-12)
        p = rl.predicted_vs_measured("lloyd", 1e-3, route=route, **dims)
        assert p["predicted_s"] * 1e3 == bound[0]
    shared = x[:1].expand(3, -1, -1)
    dims = rl.kernel_dims("assign", shared, c)
    assert dims["x_lanes"] == 1 and "w_lanes" not in dims
    assert rl.kernel_bound_ms("assign", **dims) == _old_bound_ms(
        3 * 300 * 17 * 83, (300 * 40 + c.numel()) * 4 + 3 * 300 * 8)
    ids = torch.zeros(3, 300, dtype=torch.int32)
    dims = rl.kernel_dims("centroid", x, ids, w[:1].expand(3, -1), 17)
    assert (dims["k"], dims["w_lanes"]) == (17, 1)
    assert rl.kernel_bound_ms("centroid", **dims) == _old_bound_ms(
        3 * 300 * 81, (x.numel() + 300 + ids.numel()) * 4 + 3 * 17 * 41 * 4)
    luts = torch.rand(4, 8, 256)
    codes = torch.randint(0, 256, (4, 500, 8), dtype=torch.uint8)
    assert rl.kernel_bound_ms("scan", **rl.kernel_dims(
        "scan", luts, codes)) == rl.kernel_bound_ms(
        "scan", b=4, l=500, msub=8, c=256) == _old_bound_ms(
        4 * 500 * 8, codes.numel() + luts.numel() * 4 + 4 * 500 * 4)
    q = torch.rand(2, 8, 16, dtype=torch.bfloat16)
    kc = torch.rand(2, 2, 50, 16, dtype=torch.bfloat16)
    counts = torch.rand(2, 2, 50)
    in_bytes = (q.numel() + 2 * kc.numel()) * 2 + counts.numel() * 4
    assert rl.kernel_bound_ms("cluster_attn", **rl.kernel_dims(
        "cluster_attn", q, kc, kc, counts)) == _old_bound_ms(
        2 * 8 * 50 * (4 * 16 + 4), in_bytes + 2 * 8 * 18 * 4)


def test_kernel_models_refuse_unknown_kernels_and_routes():
    with pytest.raises(ValueError):
        rl.kernel_cost("softmax", m=1, k=1, d=1)
    with pytest.raises(ValueError):
        rl.kernel_cost("lloyd", route="mxu", m=1, k=1, d=1)
