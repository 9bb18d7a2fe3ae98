"""The port's dry run (``repro_torch.launch.dryrun``) on the ``meta``
device: every architecture's reduced config through a train, a prefill
and a decode cell (the full and the clustered cache) with the A/B FLOP
count; the full configs' byte accounting for every runnable cell of
``configs.cells()`` on both production meshes; the cluster-attention
wrapper's ``meta`` branch; and the command line, which writes only into
the directory it is given."""
import dataclasses
import functools
import json
import math

import pytest
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig, cells, \
    get_config
from repro_torch.kernels import cluster_attn
from repro_torch.kernels.ref import cluster_attn_decode_ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh, production_mesh_shape

MESH = AbstractMesh((2, 2), ("data", "model"))
SMALL = {"train": ShapeConfig("train_s", 64, 8, "train"),
         "prefill": ShapeConfig("prefill_s", 64, 2, "prefill"),
         "decode": ShapeConfig("decode_s", 64, 2, "decode"),
         "clustered": ShapeConfig("long_s", 64, 1, "decode",
                                  cluster_compression=4, cluster_window=16)}


@functools.lru_cache(maxsize=None)
def _reduced_record(arch: str, cell: str) -> dict:
    """The dry run's record of a reduced config at a small cell on MESH
    (one run a cell for every test of this file)."""
    return dryrun.dry_run(get_config(arch).reduced(), SMALL[cell], MESH)


@pytest.mark.parametrize("cell", list(SMALL))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_cells_run_on_meta_with_every_field(arch, cell):
    cfg, shape = get_config(arch).reduced(), SMALL[cell]
    rec = _reduced_record(arch, cell)
    for key in ("shape", "kind", "n_super", "layers_per_step", "params",
                "active_params", "chips", "gate", "memory", "seconds",
                "parts", "total_flops", "model_flops_global",
                "useful_flop_ratio"):
        assert key in rec, key
    assert rec["gate"]["ran"] == "meta" and rec["chips"] == 4
    mem = rec["memory"]
    assert mem["fits"] is None and mem["card"] is None     # no card here
    for part in ("sharded_per_device", "port_per_device"):
        assert mem[part]["total"] == sum(v for k, v in mem[part].items()
                                         if k != "total") > 0
    assert mem["sharded_per_device"]["params"] <= \
        mem["port_per_device"]["params"]
    assert rec["parts"]["block"] > 0 and rec["total_flops"] > 0
    assert 0 < rec["useful_flop_ratio"] < math.inf
    if shape.kind == "train":
        assert rec["plan"]["n_micro"] == 4            # 8 rows over dp = 2
        assert rec["parts"]["n_micro"] == 4
    if shape.kind == "decode":
        want = "clustered" if (cell == "clustered" and cfg.family in (
            "dense", "moe", "vlm", "hybrid")) else "full"
        assert rec["cache_kind"] == want
    json.dumps(rec)                                   # a JSON record


@pytest.mark.parametrize("cell", list(SMALL))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_cells_carry_the_roofline_on_the_h100_roofs(arch, cell):
    """``total_cost`` (FLOPs, the bytes of the meta step's ops, a training
    cell's per-chip link bytes), the three terms on the H100's roofs with
    the whole step's FLOPs and bytes over the chips, the dominant term and
    ``roofline_fraction`` in (0, 1]; a serving cell moves nothing between
    cards and says why."""
    rec = _reduced_record(arch, cell)
    for key in ("total_cost", "roofline", "dominant", "model_flops_per_chip",
                "roofline_fraction", "collective"):
        assert key in rec, key
    total, terms, chips = rec["total_cost"], rec["roofline"], rec["chips"]
    assert set(terms) == {"compute_s", "memory_s", "collective_s"}
    assert all(v >= 0 for v in terms.values())
    assert total["flops"] == rec["total_flops"] > 0 and total["bytes"] > 0
    assert terms["compute_s"] == total["flops"] / chips / 989e12
    assert terms["memory_s"] == total["bytes"] / chips / 3.35e12
    assert terms["collective_s"] == total["coll"] / 450e9
    assert rec["dominant"] == max(terms, key=terms.get)
    assert 0 < rec["roofline_fraction"] <= 1
    assert rec["roofline_fraction"] == pytest.approx(
        rec["model_flops_per_chip"] / 989e12 / terms[rec["dominant"]],
        rel=1e-12)
    assert rec["model_flops_per_chip"] == rec["model_flops_global"] / chips
    bounds = rec["roofline_bounds"]
    assert bounds["memory_s"].startswith("upper bound")
    assert bounds["roofline_fraction"].startswith("lower bound")
    lean = dict(terms, memory_s=0.0)
    assert bounds["without_memory"]["dominant"] == max(lean, key=lean.get)
    assert bounds["without_memory"]["roofline_fraction"] >= \
        rec["roofline_fraction"]
    coll = rec["collective"]
    if SMALL[cell].kind == "train":
        assert terms["collective_s"] > 0
        assert total["coll_by_op"] == coll["by_op"]
        assert sum(coll["by_op"].values()) == coll["per_chip_bytes"]
        weights, acts = coll["weights"], coll["activations"]
        assert set(weights["by_op"]) == {"all-gather", "reduce-scatter"}
        assert coll["per_chip_bytes"] == pytest.approx(
            weights["per_chip_bytes"] + acts["per_chip_bytes"], rel=1e-12)
        for op, b in coll["by_op"].items():
            assert b == weights["by_op"].get(op, 0) + acts["by_op"].get(op,
                                                                        0)
    else:
        assert terms["collective_s"] == 0 == coll["per_chip_bytes"]
        assert "one card" in coll["reason"]


def test_a_training_cells_collective_bytes_count_each_pass():
    """llama3-8b at train_4k on 16 x 16: a data shard's first position
    all-gathers each layer in the forward and again in the remat
    recompute, the head's Vp / 16 columns once a step, and reduce-scatters
    each gradient (f32, twice the bf16 weights' bytes) once a
    micro-batch.  A region within one "model" block spans the leaf's 16
    "data" blocks (15/16 of it over the links): its query heads' columns
    of wq and rows of wo, its FFN columns, the head's; the one kv head it
    reads (128 columns of wk and wv, cut in blocks of 64) spans 32
    (31/32).  The activations of the micro-batch's 16 x 4096 tokens (d =
    4096, f32: 1 GiB) are all-reduced eight times a layer: the attention's
    and the FFN's row-parallel sums in the forward, the attention's again
    in the recompute (which stops once it has what the backward keeps),
    and the input gradients of wq, wk, wv, w1 and w3 in the backward; once
    more for the head's input gradient, and three values a row for the
    vocab-parallel loss."""
    cfg = get_config("llama3-8b")
    mesh = production_mesh_shape()
    rec = dryrun.account(cfg, SHAPES["train_4k"], mesh)
    rec["collective"] = dryrun.collective(cfg, SHAPES["train_4k"], mesh)
    port = rec["memory"]["port_per_device"]
    coll = rec["collective"]["weights"]
    assert rec["plan"]["grad_dtype"] == "float32" and rec["plan"]["remat"]
    assert coll["micro_batches_per_shard"] == 1
    assert coll["model_position"] == 0
    d, f, dh, m = cfg.d_model, cfg.d_ff, cfg.dh, 16
    q_o, kv = 2 * 2 * d * cfg.n_heads * dh // m, 2 * 2 * d * dh
    ffn = 2 * 3 * d * f // m
    assert q_o + kv + ffn == port["gathered_layer"]
    layer = q_o * 15 / 16 + kv * 31 / 32 + ffn * 15 / 16
    head = port["gathered_once"] * 15 / 16
    ag, rs = coll["by_op"]["all-gather"], coll["by_op"]["reduce-scatter"]
    assert ag == head + 2 * cfg.n_layers * layer
    assert rs == 2 * (head + cfg.n_layers * layer)
    assert coll["per_chip_bytes"] == ag + rs
    acts = rec["collective"]["activations"]
    tokens = SHAPES["train_4k"].global_batch // 16 * 4096
    ring = 2 * 15 / 16
    assert acts["passes"] == {"blocks": 2}
    assert acts["by_op"] == {"all-reduce": pytest.approx(
        (8 * cfg.n_layers + 1) * ring * tokens * d * 4
        + 3 * ring * tokens * 4, rel=1e-12)}
    assert rec["collective"]["per_chip_bytes"] == pytest.approx(
        ag + rs + acts["by_op"]["all-reduce"], rel=1e-12)


def test_whisper_encoder_layers_are_gathered_once_a_micro_batch():
    """whisper-base at train_4k on 16 x 16: its encoder layers keep their
    activations (no remat), so each is gathered once a micro-batch, its
    decoder layers twice; the weights' all-gathers are those of the
    copies at those passes."""
    cfg, shape = get_config("whisper-base"), SHAPES["train_4k"]
    mesh = production_mesh_shape()
    coll = dryrun.collective(cfg, shape, mesh)
    assert coll["activations"]["passes"] == {"enc": 1, "dec": 2}
    _, args, plan = dryrun.build_train_program(cfg, shape, mesh)
    params = args[0]["params"]
    copies = dryrun._copies(cfg, params, dryrun.param_specs(params, mesh),
                            mesh)
    twice = dryrun._collective(copies, mesh, plan, {"enc": 2, "dec": 2})
    enc = sum(dryrun.ring_bytes("all-gather", n * size, blocks)
              for name, cs in copies[0][coll["weights"]["model_position"]
                                        ].items()
              if name.startswith("enc.") for n, size, blocks in cs)
    micro = plan.n_micro // 16
    assert enc > 0
    assert coll["weights"]["by_op"]["all-gather"] == pytest.approx(
        twice["by_op"]["all-gather"] - micro * enc, rel=1e-12)


@pytest.mark.parametrize("arch,ops", [
    ("dbrx-132b", {"all-reduce", "all-to-all", "all-gather"}),
    ("internvl2-2b", {"all-reduce", "all-gather"}),
    ("llama3-8b", {"all-reduce"}),
    ("xlstm-1.3b", {"all-reduce"})])
def test_activation_collectives_by_op(arch, ops):
    """The reduced configs' training cells on MESH: the MoE's
    expert-parallel dispatch is an all-to-all and its combine an
    all-gather (each the other way in the backward, the gates' bytes
    beside the tokens' in the dispatch); a VLM's patch columns an
    all-gather once a step; the row-parallel sums and the input
    gradients' sums of the attention, the FFN and the recurrent blocks
    all-reduces; every stacked layer gathered twice a micro-batch (the
    remat recompute)."""
    acts = _reduced_record(arch, "train")["collective"]["activations"]
    assert set(acts["by_op"]) == ops
    assert all(b > 0 for b in acts["by_op"].values())
    assert set(acts["passes"].values()) == {2}
    if arch.startswith("dbrx"):
        assert acts["by_op"]["all-to-all"] > acts["by_op"]["all-gather"]


def test_decode_flops_count_the_cluster_attention():
    """The kernel's 4 B H Nc dh a clustered layer (which FlopCounterMode
    cannot see) is counted, so it is part of the block's FLOPs."""
    cfg = get_config("llama3-8b").reduced()
    long = dryrun.dry_run(cfg, SMALL["clustered"], MESH)
    caches = dryrun.build_decode_program(
        dryrun._variant(cfg, 1, 1), SMALL["clustered"], MESH)[1][1]
    nc = SMALL["clustered"].seq_len // SMALL["clustered"].cluster_compression
    assert dryrun.cluster_attn_flops(cfg, caches) == \
        4.0 * 1 * cfg.n_heads * nc * cfg.dh
    assert long["parts"]["block"] >= dryrun.cluster_attn_flops(cfg, caches)


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_full_configs_byte_accounting_for_every_cell(mesh_name):
    """Every runnable cell of ``configs.cells()`` builds its full-depth
    trees on ``meta`` and accounts what one device holds; the only cell
    skipped is whisper at long_500k."""
    mesh = production_mesh_shape(multi_pod=(mesh_name == "multi"))
    skipped = []
    for arch, shape_name, ok, _ in cells():
        if not ok:
            skipped.append((arch, shape_name))
            continue
        cfg, shape = get_config(arch), SHAPES[shape_name]
        rec = dryrun.account(cfg, shape, mesh)
        sharded = rec["memory"]["sharded_per_device"]
        port = rec["memory"]["port_per_device"]
        whole = rec["memory"]["whole_per_device"]
        assert 0 < sharded["total"] <= port["total"] <= whole["total"], (
            arch, shape_name)
        # two bytes or more a parameter (bf16, f32 where the reference
        # keeps f32), over at least the analytic count's parameters
        assert whole["params"] > cfg.param_count(), arch
        if shape.kind == "train":
            assert rec["plan"]["n_micro"] == max(
                1, shape.global_batch // (16 if mesh_name == "single"
                                          else 32))
    assert skipped == [("whisper-base", "long_500k")]


def test_a_training_cells_port_figure_is_the_sharded_trainers():
    """llama3-8b at train_4k on 16 x 16: the port holds the rules' blocks
    plus what a "model" position gathers over "data": one layer's column
    and row blocks (its 2 query heads' columns of wq and rows of wo, the
    one kv head they read in wk and wv, its d_ff / 16 columns of w1, w3
    and rows of w2) and the head's Vp / 16 columns (``embed`` and
    ``final_ln`` are replicated, read in place), far below every tree
    whole and within 1.75 GB."""
    cfg = get_config("llama3-8b")
    mem = dryrun.account(cfg, SHAPES["train_4k"],
                         production_mesh_shape())["memory"]
    sharded, port = mem["sharded_per_device"], mem["port_per_device"]
    whole = mem["whole_per_device"]
    d, f, dh, m = cfg.d_model, cfg.d_ff, cfg.dh, 16
    layer = 2 * (2 * d * cfg.n_heads * dh // m + 2 * d * dh + 3 * d * f // m)
    head = 2 * d * cfg.padded_vocab // m
    assert port["gathered_once"] == head
    assert port["gathered_layer"] == layer
    assert port["total"] == sharded["total"] + layer + head
    assert port["total"] <= 1.75e9
    assert port["total"] < whole["total"] / 50
    for part in ("params", "opt", "grad_accumulator", "batch"):
        assert port[part] == sharded[part], part


@pytest.mark.parametrize("arch,split", [("llama4-maverick-400b-a17b", False),
                                        ("whisper-base", False),
                                        ("gemma3-12b", True)])
def test_what_a_training_cell_leaves_whole_is_gathered_whole(arch, split):
    """llama4's 40 heads on a "model" axis of 16 compute their attention
    whole (its experts split, 8 a position), and so do whisper's 8 heads
    (16 does not divide them; its FFN and head split, below): a
    position's largest layer holds those leaves whole.  gemma3's 16 heads
    split (one query head and its kv head a position), its tied head is
    the replicated table, so nothing is gathered once a step."""
    cfg = get_config(arch)
    mem = dryrun.account(cfg, SHAPES["train_4k"],
                         production_mesh_shape())["memory"]
    port = mem["port_per_device"]
    d, dh = cfg.d_model, cfg.dh
    attn = 2 * (2 * d * cfg.n_heads * dh + 2 * d * cfg.n_kv_heads * dh)
    if split:     # a superblock of local_per_global + 1 such blocks
        block = 2 * (2 * d * dh + 2 * d * dh + 3 * d * cfg.d_ff // 16)
        assert port["gathered_layer"] == (cfg.local_per_global + 1) * block
        assert port["gathered_once"] == 0
    else:
        assert port["gathered_layer"] >= attn


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-2b"])
def test_a_training_cells_whisper_and_vlm_figures(arch):
    """whisper-base and internvl2-2b at train_4k on 16 x 16 (bf16).
    whisper: its largest layer a decoder layer, whose attention and cross
    attention are gathered whole (16 does not divide 8 heads) beside its
    FFN's d_ff / 16 columns of ``w1``, ``w3`` and rows of ``w2``
    (4,587,520 B); once a step the head's Vp / 16 columns (3,325,952 B);
    94,039,044 B a device.  internvl2: once a step the head's Vp / 16
    columns and ``patch_proj``'s d / 16 (24,248,320 B)."""
    cfg = get_config(arch)
    mem = dryrun.account(cfg, SHAPES["train_4k"],
                         production_mesh_shape())["memory"]
    port, sharded = mem["port_per_device"], mem["sharded_per_device"]
    d, m = cfg.d_model, 16
    head = 2 * d * cfg.padded_vocab // m
    if arch == "whisper-base":
        attn = 2 * d * cfg.n_heads * cfg.dh + 2 * d * cfg.n_kv_heads * cfg.dh
        layer = 2 * (2 * attn + 3 * d * cfg.d_ff // m)
        assert (layer, head) == (4_587_520, 3_325_952)
        assert port["gathered_layer"] == layer
        assert port["gathered_once"] == head
        assert port["total"] == 94_039_044
    else:
        once = head + 2 * d * d // m
        assert once == 24_248_320
        assert port["gathered_once"] == once
        assert port["total"] == 562_999_300
    assert port["total"] == (sharded["total"] + port["gathered_layer"]
                             + port["gathered_once"])


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-maverick-400b-a17b"])
def test_a_training_cells_gathered_moe_layer_holds_its_experts(arch):
    """dbrx-132b and llama4 at train_4k on 16 x 16: a data shard's first
    "model" position copies, for its largest layer, its E / 16 experts of
    ``moe.we1``, ``moe.we3``, ``moe.we2`` (bf16, whole along d and d_ff),
    its attention (dbrx: 3 query heads and the one kv head they read;
    llama4's 40 heads whole), llama4's shared expert's d_ff / 16 columns
    and the f32 router (d, E) whole; the head's Vp / 16 columns once a
    step."""
    cfg = get_config(arch)
    mem = dryrun.account(cfg, SHAPES["train_4k"],
                         production_mesh_shape())["memory"]
    port, sharded = mem["port_per_device"], mem["sharded_per_device"]
    d, f, e, dh, m = (cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.dh, 16)
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if h % m == 0:
        attn = 2 * d * (h // m) * dh + 2 * d * max(1, h // m * kv // h) * dh
    else:
        attn = 2 * d * h * dh + 2 * d * kv * dh
    shared = 3 * d * f // m if arch.startswith("llama4") else 0
    layer = 2 * (attn + 3 * (e // m) * d * f + shared) + 4 * d * e
    assert port["gathered_layer"] == layer
    assert port["gathered_once"] == 2 * d * cfg.padded_vocab // m
    assert port["total"] == sharded["total"] + layer + port["gathered_once"]


def test_a_training_cells_gathered_recurrent_layer_holds_its_regions():
    """xlstm-1.3b and zamba2-2.7b at train_4k on 16 x 16, from the shapes
    (bf16 weights, f32 gates and conv).  zamba2: each of a superblock's 9
    Mamba2 layers, its 5 of 80 heads: 773 columns of ``in_proj`` (their
    z, x and dt columns, all of B and C), 448 rows of ``conv``, 5 entries
    of ``A_log``, ``dt_bias``, ``D``, 320 rows of ``out_proj``.  xlstm (4
    heads of 1024 on 16 positions: 256 value columns a position): each
    of 7 mLSTMs, its head's whole 1024 columns of ``wq``, ``wk`` and
    column of ``wi``, ``wf``, its own 256 columns of ``wv``, ``up2`` and
    rows of ``down``, and on a data shard's first position ``up1``
    whole; the sLSTM (4 heads on 16) whole there."""
    for arch in ("zamba2-2.7b", "xlstm-1.3b"):
        cfg = get_config(arch)
        mem = dryrun.account(cfg, SHAPES["train_4k"],
                             production_mesh_shape())["memory"]
        port, sharded = mem["port_per_device"], mem["sharded_per_device"]
        d, di = cfg.d_model, 2 * cfg.d_model
        if arch.startswith("zamba2"):
            mamba = 2 * (d * 773 + 320 * d) + 4 * (448 * 4 + 3 * 5)
            layer = cfg.mamba_per_attn * mamba
            assert layer == 50_430_492
        else:
            dh = di // cfg.n_heads
            mlstm = (2 * (2 * di * dh + di * 256 + 2 * d * 256 + d * di)
                     + 4 * 2 * di)
            slstm = 2 * (4 * d * d + 4 * d * d // cfg.n_heads + d * d)
            layer = cfg.mlstm_per_slstm * mlstm + slstm
            assert layer == 314_802_176
        assert port["gathered_layer"] == layer, arch
        assert port["total"] == (sharded["total"] + layer
                                 + port["gathered_once"])


def test_the_command_line_writes_the_roofline_of_a_training_cell(tmp_path):
    """``--arch llama3-8b --shape train_4k``: the record carries every
    field it had (the byte accounting, the parts and the FLOPs) and the
    roofline on the H100's roofs."""
    out = tmp_path / "out"
    assert dryrun.main(["--arch", "llama3-8b", "--shape", "train_4k",
                        "--mesh", "single", "--out", str(out)]) == 0
    rec = json.loads((out / "llama3-8b__train_4k__single.json").read_text())
    for key in ("shape", "kind", "n_super", "layers_per_step", "params",
                "active_params", "chips", "gate", "memory", "seconds",
                "plan", "parts", "total_flops", "model_flops_global",
                "useful_flop_ratio", "total_cost", "roofline", "dominant",
                "model_flops_per_chip", "roofline_fraction", "collective"):
        assert key in rec, key
    assert rec["chips"] == 256 and rec["parts"]["n_micro"] == 16
    terms = rec["roofline"]
    assert terms["compute_s"] == rec["total_flops"] / 256 / 989e12
    assert terms["collective_s"] == rec["collective"]["per_chip_bytes"] \
        / 450e9 > 0
    assert rec["collective"]["activations"]["per_chip_bytes"] > 0
    assert 0 < rec["roofline_fraction"] <= 1
    assert rec["roofline_bounds"]["memory_s"].startswith("upper bound")


def test_the_byte_counter_counts_each_ops_inputs_and_outputs():
    """Not a view, not an allocation: an add reads two and writes one."""
    a = torch.empty((4, 8), device="meta")
    with dryrun.ByteCounterMode() as bc:
        b = a + a
        b.view(32).t()
        torch.empty((100,), device="meta")
        b.sum()
    assert bc.bytes == 3 * 128 + 128 + 4


def test_the_meta_branch_gives_the_plain_versions_shapes():
    """Empty f32 ``meta`` outputs of the plain version's shapes, with no
    launch counted; the CPU still runs the plain version."""
    gen = torch.Generator().manual_seed(0)
    b, h, hkv, nc, dh = 2, 8, 2, 24, 16
    q = torch.randn((b, h, dh), generator=gen)
    kc = torch.randn((b, hkv, nc, dh), generator=gen)
    vc = torch.randn((b, hkv, nc, dh), generator=gen)
    counts = torch.rand((b, hkv, nc), generator=gen)
    want = cluster_attn_decode_ref(q, kc, vc, counts, dh ** -0.5)
    before = cluster_attn.launches
    got = cluster_attn.cluster_attn_partial(
        *(t.to("meta") for t in (q, kc, vc, counts)), dh ** -0.5)
    assert cluster_attn.launches == before
    for g, w in zip(got, want):
        assert g.device.type == "meta" and g.shape == w.shape
        assert g.dtype == w.dtype == torch.float32
    cpu = cluster_attn.cluster_attn_partial(q, kc, vc, counts, dh ** -0.5)
    for g, w in zip(cpu, want):
        assert torch.equal(g, w)


def test_the_command_line_writes_only_into_its_directory(tmp_path,
                                                         monkeypatch):
    """Records (and a skip record) under ``--out``, nothing in the working
    directory or the default ``build/dryrun``; a second run skips the
    existing records."""
    work, out = tmp_path / "work", tmp_path / "out"
    work.mkdir()
    monkeypatch.chdir(work)
    default = list(dryrun.ART.glob("*")) if dryrun.ART.exists() else None
    argv = ["--shape", "long_500k", "--mesh", "single", "--no-ab", "--out",
            str(out)]
    assert dryrun.main(["--arch", "whisper-base", *argv]) == 0
    assert dryrun.main(["--arch", "llama3-8b", *argv]) == 0
    assert sorted(p.name for p in out.iterdir()) == [
        "llama3-8b__long_500k__single.json",
        "whisper-base__long_500k__single.json"]
    rec = json.loads((out / "llama3-8b__long_500k__single.json").read_text())
    assert rec["arch"] == "llama3-8b" and rec["cache_kind"] == "clustered"
    assert "parts" not in rec                          # --no-ab
    assert "skipped" in json.loads(
        (out / "whisper-base__long_500k__single.json").read_text())
    assert list(work.iterdir()) == []
    now = list(dryrun.ART.glob("*")) if dryrun.ART.exists() else None
    assert now == default
    mtime = (out / "llama3-8b__long_500k__single.json").stat().st_mtime_ns
    assert dryrun.main(["--arch", "llama3-8b", *argv]) == 0
    assert (out / "llama3-8b__long_500k__single.json").stat(
        ).st_mtime_ns == mtime
