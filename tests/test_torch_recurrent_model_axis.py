"""The recurrent blocks over the "model" axis, on the CPU in f32: each
block alone over 2 (and 4) positions (``ModelSplit`` of ``"cpu"``
repeated, each position given its region of every weight it splits, cut
by :func:`repro_torch.core.blocks.gather`) against the same block whole
on the same inputs and output gradient: the output, the input's gradient
and every weight's gradient (each position's added back into a whole
tensor by :func:`~repro_torch.core.blocks.add_into` in mesh order) at
rtol 1e-5 / atol 1e-6 (of the tensor's largest entry, where it is above
1).  The cases are the mLSTM by heads, the mLSTM by
value columns of a head (one or two heads on more positions), the sLSTM
by heads, the Mamba2 by its 64-wide heads, and the blocks M does not
divide (an sLSTM of one head, a Mamba2 of three), which name no region
and compute whole.  Then the sharded train step: on a 2 x 2 mesh each
position of reduced xlstm-1.3b and zamba2-2.7b gathers its regions'
bytes a layer, computed from the shapes, and the step matches the
one-device step at ``test_torch_train_dp.py``'s Adafactor rule; and a
region of several ranges a dim is gathered and added back exactly."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.func import functional_call

from repro_torch.configs import get_config
from repro_torch.core import blocks
from repro_torch.core.model_axis import ModelSplit
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import ssm
from test_torch_train_tp import N_MICRO, _against_one_device, _layer_bytes

B, S, CHUNK = 2, 16, 8


def _block(kind: str, d: int, n_heads: int = 4, d_state: int = 16):
    """A block of ``kind`` (``mlstm``, ``slstm``, ``mamba``) in f32 with
    every parameter drawn from numpy seed 0 (Mamba2's ``A_log`` and
    ``dt_bias`` too, so every head differs)."""
    if kind == "mamba":
        blk = ssm.Mamba2Block(d, d_state, 1e-5, torch.float32, "cpu")
    else:
        cls = ssm.MLSTMBlock if kind == "mlstm" else ssm.SLSTMBlock
        blk = cls(d, n_heads, 1e-5, torch.float32, "cpu")
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            scale = 0.1 if p.dim() == 1 else p.shape[-2] ** -0.5
            p.copy_(torch.from_numpy(rng.normal(
                size=tuple(p.shape)).astype(np.float32) * scale))
    return blk


def _inputs(d: int):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(B, S, d)).astype(np.float32))
    gy = torch.from_numpy(rng.normal(size=(B, S, d)).astype(np.float32))
    return x, gy


def _run(blk, x, gy, ways: int = 1):
    """(y, {"x": its gradient, name: each weight's gradient}) of one call
    of ``blk``, whole or over ``ways`` positions, each position computing
    with its regions of the weights ``split_regions`` names (the rest
    whole), under the output gradient ``gy``."""
    whole = {n: p.detach().clone().requires_grad_(True)
             for n, p in blk.named_parameters()}
    regions = blk.split_regions(ways) if ways > 1 else {}
    parts = [{n: blocks.gather(blocks.Sharded.whole(whole[n].detach()),
                               "cpu", (), rs[m]).clone().requires_grad_(True)
              for n, rs in regions.items()} for m in range(ways)]
    split = ModelSplit(["cpu"] * ways, {blk: parts} if regions else {})
    xx = x.clone().requires_grad_(True)
    y = functional_call(blk, whole, (xx, {"ssm_chunk": CHUNK,
                                          "model_split": split}))
    leaves = [xx, *whole.values()] + [t for p in parts for t in p.values()]
    gs = torch.autograd.grad((y * gy).sum(), leaves, allow_unused=True)
    grads = {"x": gs[0]}
    for n, g in zip(whole, gs[1:]):
        grads[n] = torch.zeros_like(whole[n]) if g is None else g
    it = iter(gs[1 + len(whole):])
    for m, p in enumerate(parts):          # mesh order
        for n in p:
            g = next(it)
            if g is not None:
                blocks.add_into(blocks.Sharded.whole(grads[n]), g, (),
                                regions[n][m])
    return y.detach(), grads, split


CASES = {
    # kind, d, heads, ways: split by heads, by value columns, or whole
    "mlstm_by_heads": ("mlstm", 64, 4, 2),
    "mlstm_by_heads_4": ("mlstm", 64, 4, 4),
    "mlstm_by_value_columns": ("mlstm", 64, 1, 2),
    "mlstm_by_value_columns_4": ("mlstm", 64, 2, 4),
    "slstm_by_heads": ("slstm", 64, 4, 2),
    "slstm_by_heads_4": ("slstm", 64, 4, 4),
    "slstm_whole": ("slstm", 64, 1, 2),
    "mamba_by_heads": ("mamba", 64, 4, 2),
    "mamba_by_heads_4": ("mamba", 128, 4, 4),
    "mamba_whole": ("mamba", 96, 4, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_over_model_is_the_whole_block(case):
    """The output and every gradient at rtol 1e-5 / atol 1e-6; a block
    that splits adds its rows' partials once (``from_model_adds``) and
    gives each position a nonzero part of every gradient it splits; a
    block M does not divide names no region and is the whole block bit
    for bit."""
    kind, d, heads, ways = CASES[case]
    blk = _block(kind, d, heads)
    x, gy = _inputs(d)
    y0, g0, _ = _run(blk, x, gy)
    y1, g1, split = _run(blk, x, gy, ways)
    regions = blk.split_regions(ways)
    if case.endswith("whole"):
        assert regions == {}
        assert torch.equal(y0, y1) and all(torch.equal(g0[n], g1[n])
                                           for n in g0)
        assert split.counts["from_model_adds"] == 0
        return
    assert regions and split.counts["from_model_adds"] == 1
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=1e-5, atol=1e-6)
    for name in g0:
        # atol 1e-6 of the tensor's scale where its entries pass 1: the
        # mLSTM's ln gradient (entries up to 11) sums each position's f32
        # gradient of u before the positions' sum, so its entries move
        # by 2-3e-7 of the largest (f32 rounding of another order)
        scale = max(1.0, float(g0[name].abs().max()))
        np.testing.assert_allclose(g1[name].numpy(), g0[name].numpy(),
                                   rtol=1e-5, atol=1e-6 * scale,
                                   err_msg=name)
        assert float(g0[name].abs().sum()) > 0, name


def test_the_mlstm_regions_by_heads_and_by_value_columns():
    """xlstm-1.3b's mLSTM (d 2048, 4 heads of 1024): on 2 positions two
    heads each; on 16, 256 value columns of head m // 4, with that head's
    whole columns of wq, wk, wi and wf; ``up1`` never split."""
    blk = ssm.MLSTMBlock(2048, 4, 1e-5, torch.bfloat16, "meta")
    every, rows = slice(0, 4096), slice(0, 2048)
    two = blk.split_regions(2)
    assert two["wq"][1] == (every, slice(2048, 4096))
    assert two["wi"][1] == (every, slice(2, 4))
    assert two["down"][1] == (slice(2048, 4096), rows)
    assert "up1" not in two and "ln" not in two
    sixteen = blk.split_regions(16)
    assert sixteen["wk"][6] == (every, slice(1024, 2048))
    assert sixteen["wf"][6] == (every, slice(1, 2))
    assert sixteen["wv"][6] == (every, slice(1024 + 512, 1024 + 768))
    assert sixteen["up2"][6] == (rows, slice(1536, 1792))
    assert sixteen["down"][6] == (slice(1536, 1792), rows)
    assert blk.split_regions(3) == {} and blk.split_regions(1) == {}


def test_the_mamba_regions_hold_four_column_ranges_and_two_row_ranges():
    """zamba2-2.7b's Mamba2 (d 2560, 80 heads of 64, d_state 64) on 16
    positions: position m's five heads' z, x and dt columns of
    ``in_proj`` beside all of B and C (773 columns), their x channels and
    B, C of ``conv`` (448 rows), their rows of ``out_proj`` (320)."""
    blk = ssm.Mamba2Block(2560, 64, 1e-5, torch.bfloat16, "meta")
    r = blk.split_regions(16)
    cols = r["in_proj"][3][1]
    assert cols == (slice(960, 1280), slice(6080, 6400), slice(10240, 10368),
                    slice(10383, 10388))
    assert blocks.region_shape(r["in_proj"][3]) == [2560, 773]
    assert blocks.region_shape(r["conv"][3]) == [448, 4]
    assert r["out_proj"][3] == (slice(960, 1280), slice(0, 2560))
    assert r["D"][3] == (slice(15, 20),)
    assert blk.split_regions(3) == {}


def test_a_region_of_several_ranges_is_gathered_and_added_back_exactly():
    """A leaf in the blocks of a 2 x 2 mesh (rows over "data", columns
    over "model"): a region of two row ranges and three column ranges
    (one across the two "model" blocks) gathers the ranges concatenated
    in order, bit for bit, and ``add_into`` adds a gradient of that shape
    into exactly those entries of the blocks."""
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    s = blocks.shard(x, ("data", "model"), mesh)
    region = ((slice(1, 3), slice(5, 8)), (slice(0, 2), slice(4, 8),
                                           slice(10, 12)))
    got = blocks.gather(s, "cpu", (), region)
    rows, cols = [1, 2, 5, 6, 7], [0, 1, 4, 5, 6, 7, 10, 11]
    assert torch.equal(got, x[rows][:, cols])
    acc = blocks.zeros((8, 12), torch.float32, ("data", "model"), mesh)
    g = torch.arange(1, 41, dtype=torch.float32).reshape(5, 8)
    blocks.add_into(acc, g, (), region)
    want = torch.zeros(8, 12)
    want[np.ix_(rows, cols)] = g
    assert torch.equal(blocks.gather(acc, "cpu"), want)
    # a 0-d leaf read onto a device that holds no copy of it
    step = blocks.shard(torch.tensor(7.0), (), mesh)
    assert blocks.gather(step, "meta").shape == ()


def _recurrent_layer_bytes(cfg, ways: int) -> tuple:
    """(the f32 bytes a "model" position copies of one reduced recurrent
    superblock, its data shard's first position's extra), from the
    shapes.  xlstm: each mLSTM's h/M heads' columns of wq, wk, wv, up2,
    wi, wf and rows of down, the sLSTM's heads' columns of wz ... wo,
    slices of rz ... ro and rows of down; the first position also copies
    each mLSTM's up1 whole.  zamba2: each Mamba2's heads' z, x, dt
    columns and all B, C columns of in_proj, their x channels and B, C
    rows of conv, their entries of A_log, dt_bias, D and rows of
    out_proj.  The norms are read in place (one replicated block)."""
    d = cfg.d_model
    if cfg.family == "ssm":
        di, h = 2 * d, cfg.n_heads
        cm = di // ways
        mlstm = 3 * di * cm + 2 * di * (h // ways) + 2 * d * cm
        sd = d // ways
        slstm = 4 * d * sd + 4 * (h // ways) * (d // h) ** 2 + sd * d
        return (4 * (cfg.mlstm_per_slstm * mlstm + slstm),
                4 * cfg.mlstm_per_slstm * d * di)
    di, ds = 2 * d, cfg.ssm_state
    hm = di // 64 // ways
    xm = hm * 64
    mamba = d * (2 * xm + 2 * ds + hm) + (xm + 2 * ds) * 4 + 3 * hm + xm * d
    return 4 * cfg.mamba_per_attn * mamba, 0


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-2.7b"])
def test_each_position_gathers_its_recurrent_regions(arch):
    """Reduced xlstm-1.3b (4 heads) and zamba2-2.7b (2 Mamba2 heads) on a
    2 x 2 mesh: each position copies its regions' bytes of every
    recurrent layer (its first position also ``up1``), no gathered layer
    outlives its use, the recurrent blocks' row products are added over
    "model", and the step is the one-device step at the Adafactor
    rule."""
    cfg = get_config(arch).reduced()
    stats = _against_one_device(cfg, make_host_mesh(2, 2, device="cpu"))
    layer, first = _recurrent_layer_bytes(cfg, 2)
    for p in stats["positions"]:
        extra = first if p["position"] % 2 == 0 else 0
        assert _layer_bytes(p) == {layer + extra}, p
        assert p["gathers"] > 0 and p["max_live_layers"] == 1
        assert p["live_after"] == 0
    # each recurrent block's row product in each micro-batch's forward
    # (the remat recompute stops after the last saved tensor it needs)
    per = (cfg.mlstm_per_slstm + 1 if cfg.family == "ssm"
           else cfg.mamba_per_attn)
    assert stats["from_model_adds"] > N_MICRO * (cfg.n_layers // per * per)


def test_an_xlstm_of_one_head_splits_its_mlstm_by_value_columns():
    """Reduced xlstm-1.3b with one head on a 1 x 2 mesh: each mLSTM splits
    by value columns (both positions read the head's wq, wk, wi, wf and
    add their gradients in mesh order), the sLSTM is computed whole on
    the first position; the step is the one-device step at the Adafactor
    rule."""
    cfg = dataclasses.replace(get_config("xlstm-1.3b").reduced(), n_heads=1)
    stats = _against_one_device(cfg, make_host_mesh(1, 2, device="cpu"))
    d, di = cfg.d_model, 2 * cfg.d_model
    # on 1 x 2 "data" is 1: a region that is one "model" block is read in
    # place, wq's and wk's whole head (two blocks) are copied
    mlstm = 4 * 2 * di * di
    whole_slstm = 4 * (4 * d * d + 4 * d * d + d * d)
    for p in stats["positions"]:
        first = p["position"] == 0
        want = cfg.mlstm_per_slstm * (mlstm + (4 * d * di if first else 0))
        assert _layer_bytes(p) == {want + (whole_slstm if first else 0)}, p
