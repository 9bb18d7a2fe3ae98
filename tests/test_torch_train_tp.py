"""The sharded train step's compute over the "model" axis, on the CPU in
f32: attention by heads, the dense SwiGLU FFN and llama4's shared expert
by hidden columns (their output projections' partial products added in
mesh order), the MoE experts by expert (each position its E/M experts
on its slice of the dispatch block), the recurrent blocks (xlstm's mLSTM
and sLSTM, zamba2's Mamba2) by heads, whisper's encoder and decoder
layers (self and cross attention by heads, the FFN by hidden columns),
internvl2's patch projection by columns and the vocab-parallel head and
loss.  whisper's frames and internvl2's patches are drawn with numpy
from seed 0 in the reference's subprocess, after the tokens and labels.

The oracle is the JAX package's own GSPMD step: its jitted train step on
a 2 x 2 ("data", "model") mesh of 4 host devices, in one subprocess for
the module, with the parameters, optimizer state and batch laid out by
its partition rules.  The port's step on ``make_host_mesh(2, 2)`` from
that state carried across is held at ``test_torch_train_dp.py``'s
Adafactor rule (loss rtol 1e-6; parameters rtol 1e-5, atol 1e-6;
factored moments rtol 1e-4).  The cases the reference's configs do not
reach (kv heads read across blocks, heads the axis does not divide) are
held against the port's one-device step at the same rule, as are
experts the axis does not divide (computed whole) beside llama4's
shared expert split by columns."""
import dataclasses
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import optim as toptim
from repro_torch import tree
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.convert import stacked_params, train_state_from_jax
from repro_torch.core import blocks
from repro_torch.core.model_axis import ModelSplit, from_model, to_model
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model, lm
from repro_torch.models.layers import (cross_entropy,
                                       vocab_parallel_cross_entropy)
from repro_torch.train import sharding as sh
from repro_torch.train.step import (TrainPlan, make_train_step,
                                   position_members)
from test_torch_train import LR, _compare_step

ROOT = Path(__file__).resolve().parents[1]
SEQ, BATCH, N_MICRO, CHUNK = 16, 8, 4, 8
REF_ARCHS = ["llama3-8b", "dbrx-132b", "llama4-maverick-400b-a17b",
             "xlstm-1.3b", "zamba2-2.7b", "whisper-base", "internvl2-2b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the reduced models' ops are tiny, and the
    suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
            for k in ("tokens", "labels")}


# ---------------------------------------------------------------------------
# (a) the reference's own GSPMD step on a 2 x 2 mesh
# ---------------------------------------------------------------------------

_JAX_TP = r"""
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat, optim
from repro.configs import ShapeConfig, get_config
from repro.models.registry import build_model
from repro.train.sharding import batch_specs, opt_state_specs, param_specs
from repro.train.step import TrainPlan, make_train_step
assert len(jax.devices()) == 4
archs, seq, batch_n, n_micro, chunk, lr = sys.argv[2:8]
seq, batch_n, n_micro, chunk, lr = (int(seq), int(batch_n), int(n_micro),
                                    int(chunk), float(lr))
mesh = compat.make_mesh((2, 2), ("data", "model"))
named = lambda specs: jax.tree.map(lambda s: NamedSharding(mesh, s), specs)
out = {}
for arch in archs.split(","):
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    opt = optim.Adafactor(lr=lr)
    state = {"params": params, "opt": opt.init(params),
             "step": jnp.zeros((), jnp.int32)}
    before = jax.tree.map(np.asarray, state)
    p_specs = param_specs(params, mesh)
    state_sh = {"params": named(p_specs),
                "opt": named(opt_state_specs(state["opt"], p_specs, mesh)),
                "step": NamedSharding(mesh, P())}
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab, (batch_n, seq)).astype(np.int32)
             for k in ("tokens", "labels")}
    if cfg.family == "audio":
        batch["frames"] = rng.normal(
            size=(batch_n, cfg.encoder_ctx, cfg.d_model)).astype(np.float32)
    if cfg.n_patches:
        batch["patches"] = rng.normal(
            size=(batch_n, cfg.n_patches, cfg.d_model)).astype(np.float32)
    b_sh = named(batch_specs(batch, mesh))
    fn = make_train_step(model, opt, cfg,
                         ShapeConfig("t", seq, batch_n, "train"),
                         TrainPlan(n_micro=n_micro, q_chunk=chunk),
                         act_spec=P("data", None, None))
    with compat.set_mesh(mesh):
        step = jax.jit(fn, in_shardings=(state_sh, b_sh),
                       out_shardings=(state_sh, None))
        new, met = step(jax.device_put(state, state_sh),
                        {k: jax.device_put(v, b_sh[k])
                         for k, v in batch.items()})
        out[arch] = (before, jax.tree.map(np.asarray, new),
                     jax.tree.map(np.asarray, met), batch)
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
print("JAX_TP_OK")
"""


@pytest.fixture(scope="module")
def gspmd(tmp_path_factory):
    """{arch: (state before, state after, metrics, batch)} of the
    reference's jitted Adafactor step on a 2 x 2 host mesh, as numpy."""
    path = tmp_path_factory.mktemp("jax_tp") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-c", _JAX_TP, str(path), ",".join(REF_ARCHS),
         str(SEQ), str(BATCH), str(N_MICRO), str(CHUNK), str(LR)],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert "JAX_TP_OK" in r.stdout, r.stdout + r.stderr
    with open(path, "rb") as f:
        return pickle.load(f)


def _step(cfg, mesh, opt):
    return make_train_step(
        build_model(cfg, device="cpu" if mesh is None else "meta"), opt,
        cfg, ShapeConfig("t", SEQ, BATCH, "train"),
        TrainPlan(n_micro=N_MICRO, q_chunk=CHUNK), mesh=mesh)


def _gathered(state) -> dict:
    return dict(blocks.gather_tree({k: state[k] for k in ("params", "opt")},
                                   "cpu"), step=state["step"])


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_the_model_axis_step_matches_the_reference_gspmd_step(gspmd, arch):
    """The reference's state carried across and cut into the blocks of a
    2 x 2 mesh: the port's step over "model" against the reference's
    GSPMD step on its own 2 x 2 mesh."""
    before, after, met, batch = gspmd[arch]
    cfg = get_config(arch).reduced()
    mesh = make_host_mesh(2, 2, device="cpu")
    step = _step(cfg, mesh, toptim.Adafactor(lr=LR))
    got, gmet = step(sh.shard_state(train_state_from_jax(
        before, device="cpu"), mesh), batch)
    assert step.stats["from_model_adds"] > 0
    _compare_step("adafactor", before, after, met, _gathered(got), gmet)
    if cfg.family == "moe":     # the experts really split: E/M a position
        _assert_moe_positions(cfg, step.stats, 2)
        assert step.stats["split_model_calls"] > 0
        assert step.stats["concat_model_calls"] > 0
    if cfg.family in ("ssm", "hybrid", "audio"):    # every position
        n_layers = len(position_members(          # computes a part of
            build_model(cfg, device="meta"), 2)[0])   # each layer
        for p in step.stats["positions"]:
            assert len(p["layer_bytes"]) == n_layers, p
            assert min(p["layer_bytes"].values()) > 0, p
    if cfg.n_patches:       # patch_proj's d/M columns beside the head's
        d = cfg.d_model     # Vp/M, put together by concat_model
        for p in step.stats["positions"]:
            assert p["once_bytes"] == 4 * d * (cfg.padded_vocab + d) // 2, p
        assert step.stats["concat_model_calls"] == 1


def _moe_layer_bytes(cfg, ways: int, experts_split: bool = True) -> tuple:
    """(the f32 bytes a "model" position copies of one reduced MoE layer,
    its data shard's first position's extra): its heads' columns and rows
    of the attention, its E/M experts (all E on the first position where
    they compute whole), llama4's shared expert's d_ff/M columns of
    ``moe.w1``, ``moe.w3`` and rows of ``moe.w2``; the first position
    also copies the router (d, E), split over "data"."""
    d, f, e, dh = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.dh
    hm = cfg.n_heads // ways
    kvm = max(1, hm * cfg.n_kv_heads // cfg.n_heads)
    layer = 2 * d * hm * dh + 2 * d * kvm * dh
    expert = 3 * d * f
    if cfg.name.startswith("llama4"):
        layer += expert // ways
    first = d * e
    if experts_split:
        layer += e // ways * expert
    else:
        first += e * expert
    return 4 * layer, 4 * first


def _assert_moe_positions(cfg, stats, ways: int, experts_split=True):
    layer, first = _moe_layer_bytes(cfg, ways, experts_split)
    for p in stats["positions"]:
        extra = first if p["position"] % ways == 0 else 0
        assert _layer_bytes(p) == {layer + extra}, p
        assert p["max_live_layers"] == 1 and p["live_after"] == 0


# ---------------------------------------------------------------------------
# against the port's one-device step: (b) what a position gathers,
# (c) kv heads read across blocks, (d) heads the axis does not divide
# ---------------------------------------------------------------------------

def _numpy(t):
    return tree.map_(lambda x: x.numpy(), t)


def _against_one_device(cfg, mesh, before_mesh=None) -> dict:
    """One Adafactor step from the seed-0 state, whole on one device and
    in the blocks of ``mesh`` (``before_mesh()`` called between the two),
    held at ``test_torch_train_dp.py``'s rule; -> the mesh step's
    stats."""
    runs = []
    for m in (None, mesh):
        if m is not None and before_mesh is not None:
            before_mesh()
        opt = toptim.Adafactor(lr=LR)
        params = stacked_params(build_model(cfg, device="cpu").init_params(0))
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        before = _numpy(state)
        if m is not None:
            state = sh.shard_state(state, m)
        step = _step(cfg, m, opt)
        new, met = step(state, _batch(cfg))
        runs.append((before, new, met, getattr(step, "stats", None)))
    (before, want, wmet, _), (_, got, gmet, stats) = runs
    _compare_step("adafactor", before, _numpy(want), wmet, _gathered(got),
                  gmet)
    return stats


def _layer_bytes(p) -> set:
    return set(p["layer_bytes"].values())


def test_each_position_gathers_its_column_and_row_blocks(monkeypatch):
    """llama3-8b reduced on 2 x 2: every position copies, for each layer,
    its h/M heads' columns of wq, wk, wv and rows of wo, its d_ff/M
    columns of w1, w3 and rows of w2 over "data" (half of the layer), and
    once a step its Vp/M columns of the head; the whole (rows, Vp)
    logits are never formed (the loss sees blocks of Vp/M columns)."""
    cfg = get_config("llama3-8b").reduced()
    d, f, vp = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    widths = []
    real = lm.vocab_parallel_cross_entropy

    def spy(blocks_, labels):
        widths.extend(b.shape[-1] for b in blocks_)
        return real(blocks_, labels)

    def whole(*a, **k):
        raise AssertionError("whole logits formed")

    def patch():
        monkeypatch.setattr(lm, "vocab_parallel_cross_entropy", spy)
        monkeypatch.setattr(lm.DecoderLM, "head_out", whole)

    stats = _against_one_device(cfg, make_host_mesh(2, 2, device="cpu"),
                                patch)
    qkv = cfg.n_heads * cfg.dh // 2
    layer = 4 * (2 * d * qkv + 2 * d * (cfg.n_kv_heads // 2) * cfg.dh
                 + 3 * d * f // 2)
    whole_layer = 4 * (2 * d * 2 * qkv + 2 * d * cfg.n_kv_heads * cfg.dh
                       + 3 * d * f)
    assert 2 * layer == whole_layer
    for p in stats["positions"]:
        assert _layer_bytes(p) == {layer}, p
        assert p["once_bytes"] == 4 * d * vp // 2, p
        assert p["max_live_layers"] == 1 and p["live_after"] == 0
    assert widths and set(widths) == {vp // 2}


def test_kv_heads_read_across_blocks_match_the_one_device_step():
    """One kv head on a 1 x 2 mesh: both positions' query heads read it,
    a column region that spans both positions' blocks of wk and wv (each
    holds half its columns); its gradient is added into both blocks in
    mesh order."""
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              n_kv_heads=1)
    stats = _against_one_device(cfg, make_host_mesh(1, 2, device="cpu"))
    kv = 4 * 2 * cfg.d_model * cfg.dh      # wk and wv copied, the rest read
    for p in stats["positions"]:           # in place (one "data" block)
        assert _layer_bytes(p) == {kv}, p


def test_heads_the_model_axis_does_not_divide_are_computed_whole():
    """Three heads on a "model" axis of 2: the attention is gathered whole
    and computed on each data shard's first position; the FFN and the
    head still split."""
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), n_heads=3,
                              n_kv_heads=1)
    assert lm.head_split(lm.AttnDims(3, 1, 16), 2) is None
    stats = _against_one_device(cfg, make_host_mesh(2, 2, device="cpu"))
    d, hd = cfg.d_model, 3 * cfg.dh
    attn = 4 * (2 * d * hd + 2 * d * cfg.dh)
    ffn = 4 * 3 * d * cfg.d_ff // 2
    for p in stats["positions"]:
        first = p["position"] % 2 == 0
        assert _layer_bytes(p) == {ffn + attn if first else ffn}, p


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-maverick-400b-a17b"])
def test_experts_the_model_axis_does_not_divide_are_computed_whole(arch):
    """Three experts on a "model" axis of 2: the experts are gathered
    whole and computed on each data shard's first position, with no
    ``split_model`` or ``concat_model``; attention, the head and
    llama4's shared expert (by its hidden columns, at the dense FFN's
    rule) still split."""
    cfg = dataclasses.replace(get_config(arch).reduced(), n_experts=3)
    assert "moe.we1" not in lm.AttnBlock(cfg, torch.float32, "meta",
                                         moe=True).split_regions(2)
    stats = _against_one_device(cfg, make_host_mesh(2, 2, device="cpu"))
    _assert_moe_positions(cfg, stats, 2, experts_split=False)
    assert stats["split_model_calls"] == stats["concat_model_calls"] == 0
    assert stats["from_model_adds"] > 0


def test_head_split_reads_the_kv_heads_of_its_queries():
    """Position m's query heads and the kv heads they use: M dividing
    kv (a block each), heads inside one group (one kv head, shared by
    positions), and groups a position's heads cut (whole)."""
    assert lm.head_split(lm.AttnDims(32, 8, 128), 2) == [
        ((0, 16), (0, 4)), ((16, 32), (4, 8))]
    split16 = lm.head_split(lm.AttnDims(32, 8, 128), 16)
    assert split16[5] == ((10, 12), (2, 3)) and len(split16) == 16
    assert lm.head_split(lm.AttnDims(40, 8, 128), 16) is None
    assert lm.head_split(lm.AttnDims(12, 3, 64), 2) is None
    assert lm.head_split(lm.AttnDims(32, 8, 128), 1) is None


# ---------------------------------------------------------------------------
# (e) the vocab-parallel loss, (f) the collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offset", [0.0, 1e4])
@pytest.mark.parametrize("ways", [2, 4])
def test_vocab_parallel_loss_and_gradient_match_whole_logits(ways, offset):
    """Blocks of Vp/M columns against :func:`cross_entropy` on the whole
    logits, with labels in every position's block, also with every logit
    offset by 1e4: the loss and each block's gradient (its softmax block
    minus the one-hot on its own columns) at rtol 1e-6 and atol 1e-7 of
    the exact values (the whole logits' in f64), and within
    :func:`cross_entropy`'s own f32 rounding at the offset (``ulp``: f32's
    epsilon times the offset; at 0, rtol 1e-6 and atol 1e-7)."""
    gen = torch.Generator().manual_seed(ways)
    v = 64
    logits = torch.randn((2, 16, v), generator=gen) * 3 + offset
    labels = (torch.arange(32).reshape(2, 16) * 7) % v
    assert set((labels // (v // ways)).flatten().tolist()) == set(
        range(ways))
    parts = [b.clone().requires_grad_(True)
             for b in logits.split(v // ways, dim=-1)]
    got = vocab_parallel_cross_entropy(parts, labels)
    got.backward()
    grad = torch.cat([p.grad for p in parts], -1)
    exact = logits.double().requires_grad_(True)
    nll = (torch.logsumexp(exact, -1)
           - torch.gather(exact, -1, labels[..., None])[..., 0]).mean()
    nll.backward()
    np.testing.assert_allclose(got.item(), nll.item(), rtol=1e-6)
    np.testing.assert_allclose(grad.double(), exact.grad, rtol=1e-6,
                               atol=1e-7)
    whole = logits.clone().requires_grad_(True)
    want = cross_entropy(whole, labels)
    want.backward()
    ulp = float(torch.finfo(torch.float32).eps) * offset
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6,
                               atol=2 * ulp)
    np.testing.assert_allclose(grad, whole.grad, rtol=2 * ulp, atol=1e-7)


def test_at_one_position_the_collectives_return_their_input():
    """A "model" axis of 1: no copy, no add, no cast."""
    x = torch.randn((3, 4), dtype=torch.bfloat16)
    assert to_model(x, ["cpu"])[0] is x
    assert from_model([x], ["cpu"], torch.float32)[0] is x
    split = ModelSplit(["cpu"])
    assert split.to_model(x)[0] is x and split.parts(object()) is None
    assert split.from_model([x], torch.bfloat16)[0] is x
    assert split.counts["from_model_adds"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_collectives_add_in_mesh_order_in_f32(dtype):
    """Two positions: ``to_model`` gives the activations on each and adds
    the positions' gradients in f32, rounded once; ``from_model`` adds
    the f32 partials in mesh order, rounds once to the activations' type,
    places the sum on each position and hands its gradient to each."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((5, 8), generator=gen).to(dtype).requires_grad_(True)
    xs = to_model(x, ["cpu", "cpu"])
    assert len(xs) == 2 and all(torch.equal(t, x) for t in xs)
    w = [torch.randn((8, 8), generator=gen).to(dtype) for _ in range(2)]
    parts = [(t.float() @ wm.float()) for t, wm in zip(xs, w)]
    outs = from_model(parts, ["cpu", "cpu"], dtype)
    want = (parts[0] + parts[1]).to(dtype)
    assert all(o.dtype == dtype and torch.equal(o, want) for o in outs)
    g = torch.randn((5, 8), generator=gen).to(dtype)
    (x_grad,) = torch.autograd.grad(outs[0], [x], g)
    dx = [(g.float() @ wm.float().T).to(dtype) for wm in w]
    assert torch.equal(x_grad, (dx[0].float() + dx[1].float()).to(dtype))
    split = ModelSplit(["cpu", "cpu"])
    split.from_model([p.detach() for p in parts], dtype)
    assert split.counts == {"from_model_adds": 1,
                            "from_model_bytes": 5 * 8 * (4 + dtype.itemsize)}


def test_the_collectives_module_stands_below_the_models_and_the_step():
    """``core.model_axis`` imports neither ``models`` nor ``train``, and
    no module of ``models`` imports ``train``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-c", "import sys, repro_torch.core.model_axis; "
         "print(sorted(m for m in sys.modules if m.startswith("
         "('repro_torch.models', 'repro_torch.train'))))"],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert r.returncode == 0 and r.stdout.strip() == "[]", r.stdout + r.stderr
    upward = re.compile(r"^\s*(from|import)\s+(repro_torch\.train|\.\.train)",
                        re.MULTILINE)
    for f in (ROOT / "src" / "repro_torch" / "models").glob("*.py"):
        assert not upward.search(f.read_text()), f.name
