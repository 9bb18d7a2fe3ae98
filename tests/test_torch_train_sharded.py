"""The sharded train state (the block layout of ``repro_torch.core.blocks``
under ``repro_torch.train.sharding``'s specs)
and its step, trainer and checkpoint, on the CPU in f32 for the six
decoder families (reduced llama3-8b, gemma3-12b, dbrx-132b, internvl2-2b,
xlstm-1.3b and zamba2-2.7b) and whisper-base, on meshes that repeat the
CPU: 2 x 1, 1 x 2, 2 x 2 ("data", "model") and 2 x 2 x 1 ("pod", "data",
"model").

The layout is exact (``gather(shard(x))`` is ``x``; every position holds
``shard_bytes``).  The sharded step takes whole micro-batches a data
shard and adds each gradient into one accumulator in micro-batch order.
Where the "model" axis is 1 (2 x 1, 2 x 2 x 1) its loss and global
gradient are therefore the one-device whole-state step's bit for bit;
with AdamW and no clip so is the whole new state, and with the default
clip the state is held at the rounding-level rule (norm at rtol 1e-6;
moments, master weights and f32 parameters at rtol 1e-5 except entries
whose gradient is below 1e-4 of its leaf's largest; bf16 parameters one
ulp).  Where it is 2 (1 x 2, 2 x 2) the step computes attention (and
whisper's cross attention), the dense FFN and the head over "model", and
the row-parallel adds reorder the sums, as the reference's GSPMD step
does: the loss, the gradient and
the state are held at ``test_torch_train_dp.py``'s rule instead (loss at
rtol 1e-6, the gradient and the moments at rtol 1e-4 plus 1e-5 of the
leaf's largest entry, parameters and master weights at rtol 1e-5, atol
1e-6, where AdamW's first step may move an entry whose gradient is at
rounding level anywhere within 2 lr), and bf16 at the chip phase's rule.
Adafactor's sharded statistics add per-block sums in mesh order, held
against the reference's jitted step at ``test_torch_train_dp.py``'s
tolerances."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import optim as toptim
from repro_torch import tree
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.core import blocks
from repro_torch.convert import stacked_params
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import build_model
from repro_torch.models.registry import batch_like
from repro_torch.train import sharding as sh
from repro_torch.train.step import TrainPlan, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_train import _on_cpu
from test_torch_train_dp import (ARCHS, BATCH, CHUNK, N_MICRO, SEQ,
                                 _carried, _compare_step, _reference)

MESHES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2), "pod2x2x1": None}
SHARD_BATCH = 8
LR = 1e-2


def _mesh(name):
    if name == "pod2x2x1":
        return make_mesh((2, 2, 1), ("pod", "data", "model"), ["cpu"] * 4)
    return make_host_mesh(*MESHES[name], device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the reduced models' ops are tiny, and the
    suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t: torch.Tensor) -> torch.Tensor:
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(ints[t.element_size()]) if t.is_floating_point() else t


def _differ(a, b) -> list:
    fa, fb = (dict(tree.items(blocks.gather_tree(t, "cpu"))) for t in (a, b))
    assert fa.keys() == fb.keys()
    return [tree.key_of(p) for p in fa
            if fa[p].dtype != fb[p].dtype
            or not torch.equal(_bits(fa[p]), _bits(fb[p]))]


def _cfg(arch: str, dtype: str = "float32"):
    return dataclasses.replace(get_config(arch).reduced(), dtype=dtype)


def _state(cfg, opt) -> dict:
    params = stacked_params(build_model(cfg, device="cpu").init_params(0))
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def _batch(cfg, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, cfg.vocab, (SHARD_BATCH, SEQ)
                             ).astype(np.int32) for k in ("tokens", "labels")}
    if cfg.n_patches:
        batch["patches"] = rng.normal(
            size=(SHARD_BATCH, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_gather_back_and_hold_shard_bytes(arch, mesh_name):
    """Every leaf of the parameters, both optimizers' states and the
    accumulator gathers back bit for bit; each position holds exactly
    ``shard_bytes``; a block its spec does not tell apart from another
    position's is stored once (every position names the CPU)."""
    cfg, mesh = _cfg(arch), _mesh(mesh_name)
    params = stacked_params(build_model(cfg, device="cpu").init_params(0))
    p_specs = sh.param_specs(params, mesh)
    trees = [(params, p_specs)]
    for opt in (toptim.AdamW(master_weights=True), toptim.Adafactor()):
        ostate = opt.init(params)
        trees.append((ostate, sh.opt_state_specs(ostate, p_specs, mesh)))
    for t, specs in trees:
        cut = blocks.shard_tree(t, specs, mesh)
        assert _differ(cut, t) == []
        held = blocks.position_bytes(cut, mesh)
        assert (held == sh.shard_bytes(t, specs, mesh)).all(), held
        for leaf in tree.leaves(cut):
            assert len(leaf.blocks) == len(leaf.keys())
            assert all(b.dim() == leaf.dim() for b in leaf.blocks.values())
    acc = sh.grad_accumulator(params, mesh, torch.bfloat16)
    like = tree.map_(lambda p: torch.empty(p.shape, dtype=torch.bfloat16),
                     params)
    assert (blocks.position_bytes(acc, mesh) == sh.shard_bytes(
        like, sh.grad_specs(params, mesh), mesh)).all()


def test_a_replicated_block_is_one_tensor_per_distinct_device():
    """On a 2 x 2 mesh naming the CPU four times a replicated leaf holds
    one tensor and every position reads it; a (data, model) leaf holds
    four; the embed table's accumulator is sharded although the table is
    replicated."""
    mesh = make_host_mesh(2, 2, device="cpu")
    x = torch.arange(32.0).reshape(4, 8)
    rep = blocks.shard(x, sh.P(), mesh)
    assert len(rep.blocks) == 1 and len(rep.positions) == 4
    assert len({id(rep.blocks[u]) for u in rep.positions}) == 1
    split = blocks.shard(x, sh.P("data", "model"), mesh)
    assert len(split.blocks) == 4
    assert torch.equal(split.block((1, 0)), x[2:, :4])
    table = {"embed": torch.zeros((8, 4))}
    assert sh.param_specs(table, mesh)["embed"] == sh.P(None, None)
    assert sh.grad_accumulator(table, mesh, torch.float32)[
        "embed"].parts == (2, 2)


def test_relayout_and_assign_move_values_between_layouts():
    """A leaf cut by one spec, laid out by another and written back
    (the embed table's update: state blocks, then the replicated table)
    keeps every bit, and a stacked member gathers alone."""
    mesh = make_host_mesh(2, 2, device="cpu")
    x = torch.randn((3, 4, 8), generator=torch.Generator().manual_seed(0))
    a = blocks.shard(x, sh.P(None, "data", "model"), mesh)
    b = blocks.relayout(blocks.shard(x, sh.P(), mesh), a)
    assert b.parts == a.parts and _differ(b, a) == []
    dst = blocks.zeros(x.shape, x.dtype, sh.P(), mesh)
    blocks.assign(dst, b)
    assert torch.equal(blocks.gather(dst, "cpu"), x)
    assert torch.equal(blocks.gather(a, "cpu", (2,)), x[2])


# ---------------------------------------------------------------------------
# the sharded step against the whole-state one-device step
# ---------------------------------------------------------------------------

def _run(cfg, n_micro: int, mesh, clip: float, optimizer="adamw"):
    """One step from the seed-0 state, whole on one device (``mesh``
    None) or in the blocks of ``mesh``: (state, metrics, the gradient
    the hook saw, the step's stats)."""
    opt = (toptim.AdamW(lr=LR, master_weights=True, grad_clip=clip)
           if optimizer == "adamw" else toptim.Adafactor(lr=LR))
    state = _state(cfg, opt)
    if mesh is not None:
        state = sh.shard_state(state, mesh)
    seen = []

    def hook(grads):
        seen.append(tree.map_(lambda g: g.clone(), grads))
        return grads

    model = build_model(cfg, device="cpu" if mesh is None else "meta")
    step = make_train_step(model, opt, cfg,
                           ShapeConfig("t", SEQ, SHARD_BATCH, "train"),
                           TrainPlan(n_micro=n_micro, q_chunk=CHUNK),
                           compress_fn=hook, mesh=mesh)
    new, met = step(state, _batch(cfg))
    assert len(seen) == 1
    return new, met, seen[0], getattr(step, "stats", None)


@functools.lru_cache(maxsize=None)
def _one_device(arch: str, n_micro: int, clip: float, dtype="float32"):
    return _run(_cfg(arch, dtype), n_micro, None, clip)


def _rounding_rule(got, want, bf16_ulp: bool) -> None:
    """Moments, master weights and f32 parameters at rtol 1e-5 except
    entries whose gradient (the first moment, at step 1) is below 1e-4
    of its leaf's largest; bf16 parameters at most one ulp apart."""
    g = dict(tree.items(blocks.gather_tree(got, "cpu")))
    w = dict(tree.items(want))
    for path, a in g.items():
        b = w[path]
        key = tree.key_of(path)
        if a.dtype == torch.bfloat16:
            assert bf16_ulp, key
            ulps = (_bits(a).int() - _bits(b).int()).abs()
            assert int(ulps.max()) <= 1, key
            continue
        if path[0] == "step" or path[-1] == "step":
            assert torch.equal(a, b), key
            continue
        leaf = path[1:] if path[0] == "params" else path[2:]
        m = tree.get(want["opt"]["m"], leaf).abs()
        tiny = m < 1e-4 * m.max()
        close = torch.isclose(a, b, rtol=1e-5, atol=0.0)
        assert bool((close | tiny).all()), key


def _close(got, want, rtol, atol_frac, what) -> None:
    """Each leaf of two trees within ``rtol`` plus ``atol_frac`` of the
    leaf's largest entry."""
    g = dict(tree.items(blocks.gather_tree(got, "cpu")))
    for path, b in tree.items(want):
        a = g[path]
        np.testing.assert_allclose(
            a.numpy(), b.numpy(), rtol=rtol,
            atol=atol_frac * float(b.abs().max()) + 1e-30,
            err_msg=f"{what} {tree.key_of(path)}")


def _dp_rule(got, gmet, ggrad, want, wmet, wgrad) -> None:
    """``test_torch_train_dp.py``'s rule (``_compare_step``'s) between
    two of the port's AdamW steps from the same state: loss rtol 1e-6,
    norm rtol 1e-5, the gradient and the moments at rtol 1e-4 plus 1e-5
    of the leaf's largest entry, parameters and master weights at rtol
    1e-5, atol 1e-6 except where AdamW's first step is ill-conditioned,
    which may land anywhere within 2 lr: entries whose gradient (the
    first moment, at step 1) is below 1e-4 of its leaf's largest, or on
    which the two steps' gradients part by more than 1e-3 of it (the
    update lr g / (|g| + eps) moves by lr eps / |g| times that part)."""
    np.testing.assert_allclose(float(gmet["loss"]), float(wmet["loss"]),
                               rtol=1e-6)
    if "grad_norm" in wmet:
        np.testing.assert_allclose(float(gmet["grad_norm"]),
                                   float(wmet["grad_norm"]), rtol=1e-5)
    _close(ggrad, wgrad, 1e-4, 1e-5, "gradient")
    _close({k: got["opt"][k] for k in ("m", "v")},
           {k: want["opt"][k] for k in ("m", "v")}, 1e-4, 1e-5, "moment")
    assert int(got["step"]) == int(want["step"])
    g = dict(tree.items(blocks.gather_tree(
        {"params": got["params"], "master": got["opt"]["master"]}, "cpu")))
    gm = dict(tree.items(blocks.gather_tree(got["opt"]["m"], "cpu")))
    for path, b in tree.items({"params": want["params"],
                               "master": want["opt"]["master"]}):
        a = g[path]
        m = tree.get(want["opt"]["m"], path[1:])
        tiny = ((m.abs() < 1e-4 * m.abs().max())
                | ((gm[path[1:]] - m).abs() > 1e-3 * m.abs()))
        close = torch.isclose(a, b, rtol=1e-5, atol=1e-6)
        assert bool((close | tiny).all()), tree.key_of(path)
        assert bool(((a - b).abs()[~close] <= 2 * LR).all()), tree.key_of(
            path)


def _chip_rule(got, gmet, want, wmet, lr: float) -> None:
    """``chip_smoke.py``'s ``train_sharded`` rule for a bf16 step over
    "model" against the one-device step: loss at rtol 1e-3, norm at rtol
    1e-2, each leaf's AdamW first moment within a relative Frobenius
    error of 1e-2, every parameter within 2 lr plus one ulp."""
    np.testing.assert_allclose(float(gmet["loss"]), float(wmet["loss"]),
                               rtol=1e-3)
    np.testing.assert_allclose(float(gmet["grad_norm"]),
                               float(wmet["grad_norm"]), rtol=1e-2)
    g = dict(tree.items(blocks.gather_tree(got, "cpu")))
    for path, b in tree.items(want["opt"]["m"]):
        a = g[("opt", "m") + path]
        assert float((a - b).norm()) <= 1e-2 * float(b.norm()), path
    for path, b in tree.items(want["params"]):
        a = g[("params",) + path]
        big = torch.maximum(a.abs(), b.abs())   # one ulp at the larger
        ulp = torch.nextafter(big, torch.full_like(big, float("inf"))
                              ).float() - big.float()
        assert bool(((a.float() - b.float()).abs() <= 2 * lr + ulp).all()
                    ), path


def _model_ways(mesh) -> int:
    return mesh.shape.get("model", 1)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_is_the_one_device_step(arch, mesh_name):
    """n_micro = W without a clip, and n_micro = 2 W with the default
    clip.  Where "model" is 1: loss and gradient bit for bit, and the
    whole new state bit for bit without the clip; with it the norm at
    rtol 1e-6 and the state at the rounding-level rule.  Where "model" is
    2: the loss, the gradient and the state at ``_dp_rule``.  At every
    position no gathered layer outlives its forward or its backward: at
    every gather (forward and remat recompute) no other layer's copies
    are alive, and none after the step; a position gathers each layer
    twice a micro-batch where it computes a part of it (every position:
    the attention families' layers split by heads, xlstm's mLSTM and
    sLSTM and zamba2's Mamba2 layers by heads too)."""
    cfg, mesh = _cfg(arch), _mesh(mesh_name)
    w, ways = sh.dp_size(mesh), _model_ways(mesh)
    for n_micro, clip in ((w, 0.0), (2 * w, 1.0)):
        want, wmet, wgrad, _ = _one_device(arch, n_micro, clip)
        got, gmet, ggrad, stats = _run(cfg, n_micro, mesh, clip)
        if ways > 1:
            _dp_rule(got, gmet, ggrad, want, wmet, wgrad)
        else:
            assert torch.equal(_bits(gmet["loss"]), _bits(wmet["loss"]))
            assert _differ(ggrad, wgrad) == [], n_micro
            if clip:
                np.testing.assert_allclose(float(gmet["grad_norm"]),
                                           float(wmet["grad_norm"]),
                                           rtol=1e-6)
                _rounding_rule(got, want, bf16_ulp=False)
            else:
                assert _differ({k: got[k] for k in ("params", "opt")},
                               {k: want[k] for k in ("params", "opt")}) == []
        assert int(got["step"]) == 1
        n_layers = len(build_model(cfg, device="meta").layers())
        assert len(stats["positions"]) == mesh.devices.size
        for p in stats["positions"]:
            gathers = 2 * n_layers * p["micro_batches"]     # remat
            assert p["micro_batches"] == n_micro // w
            assert p["gathers"] == gathers, p
            assert p["max_live_layers"] == (1 if p["gathers"] else 0), p
            assert p["live_after"] == 0, p
        assert stats["max_live_layers"] == 1 and stats["live_after"] == 0
        assert (stats["accumulator_bytes"] == sh.shard_bytes(
            want["params"], sh.grad_specs(want["params"], mesh),
            mesh)).all()


@pytest.mark.parametrize("mesh_name", ["2x1", "2x2"])
def test_bf16_parameters_within_one_ulp(mesh_name):
    """llama3-8b reduced in bf16 (the chip's type) with the default clip:
    on 2 x 1 the loss and gradient bit for bit and the parameters within
    one ulp; on 2 x 2, computed over "model", under ``chip_smoke.py``'s
    ``train_sharded`` rule."""
    mesh = _mesh(mesh_name)
    want, wmet, wgrad, _ = _one_device("llama3-8b", 4, 1.0, "bfloat16")
    got, gmet, ggrad, _ = _run(_cfg("llama3-8b", "bfloat16"), 4, mesh, 1.0)
    if _model_ways(mesh) > 1:
        _chip_rule(got, gmet, want, wmet, LR)
        return
    assert torch.equal(_bits(gmet["loss"]), _bits(wmet["loss"]))
    assert _differ(ggrad, wgrad) == []
    _rounding_rule(got, want, bf16_ulp=True)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("mesh_name", ["2x1", "pod2x2x1"])
@pytest.mark.parametrize("arch", ["llama3-8b", "dbrx-132b"])
def test_whole_tensors_on_a_mesh_are_the_one_device_step(arch, mesh_name,
                                                          optimizer):
    """A state of whole tensors on a mesh is read as one block a leaf:
    n_micro = 2 W with the default clip gives the one-device step's loss,
    gradient and whole new state bit for bit, updated in place."""
    cfg, mesh = _cfg(arch), _mesh(mesh_name)
    n_micro = 2 * sh.dp_size(mesh)
    out = []
    for m in (None, mesh):
        opt = (toptim.AdamW(lr=LR, master_weights=True)
               if optimizer == "adamw" else toptim.Adafactor(lr=LR))
        state, seen = _state(cfg, opt), []
        step = make_train_step(build_model(cfg, device="cpu"), opt, cfg,
                               ShapeConfig("t", SEQ, SHARD_BATCH, "train"),
                               TrainPlan(n_micro=n_micro, q_chunk=CHUNK),
                               compress_fn=lambda g: seen.append(g) or g,
                               mesh=m)
        new, met = step(state, _batch(cfg))
        assert new["params"]["head"] is state["params"]["head"]
        out.append((new, met, seen[0]))
    (want, wmet, wgrad), (got, gmet, ggrad) = out
    assert torch.equal(_bits(gmet["loss"]), _bits(wmet["loss"]))
    assert _differ(ggrad, wgrad) == []
    assert _differ(got, want) == []


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_adafactor_step_matches_the_reference(arch):
    """The reference's jitted one-device Adafactor step, carried across
    and cut into the blocks of a 2 x 2 mesh, at ``test_torch_train_dp``'s
    tolerances."""
    js, js2, jmet, batch = _reference(arch)
    cfg = get_config(arch).reduced()
    mesh = _mesh("2x2")
    opt = toptim.Adafactor(lr=LR)
    step = make_train_step(build_model(cfg, device="meta"), opt, cfg,
                           ShapeConfig("t", SEQ, BATCH, "train"),
                           TrainPlan(n_micro=N_MICRO, q_chunk=CHUNK),
                           mesh=mesh)
    got, met = step(sh.shard_state(_carried(js), mesh), batch)
    got = dict(blocks.gather_tree({k: got[k] for k in ("params", "opt")},
                              "cpu"), step=got["step"])
    _compare_step("adafactor", js, js2, jmet, got, met)


@pytest.mark.parametrize("mesh_name", ["2x1", "2x2"])
def test_whisper_takes_the_sharded_state(mesh_name):
    """whisper-base reduced (``batch_like``'s frames) against the
    one-device step.  On 2 x 1 ("model" 1) loss, gradient and the AdamW
    state bit for bit.  On 2 x 2 each data shard computes the encoder's
    and decoder's attention, the cross attention and the FFN by heads and
    hidden columns and the head by vocab columns over its two "model"
    positions, and the row-parallel adds reorder the sums by design: the
    loss, gradient and state at ``_dp_rule``.  On both its encoder's
    gathered layers live until the backward, as its activations do, and
    none after."""
    cfg = _cfg("whisper-base")
    shape = ShapeConfig("t", SEQ, 4, "train")
    batch = batch_like(cfg, shape, 0, device="cpu")
    out = []
    for mesh in (None, _mesh(mesh_name)):
        opt = toptim.AdamW(lr=LR, master_weights=True)
        state = _state(cfg, opt)
        if mesh is not None:
            state = sh.shard_state(state, mesh)
        seen = []
        step = make_train_step(
            build_model(cfg, device="cpu" if mesh is None else "meta"), opt,
            cfg, shape, TrainPlan(n_micro=4, q_chunk=CHUNK),
            compress_fn=lambda g: seen.append(g) or g, mesh=mesh)
        new, met = step(state, batch)
        out.append((new, met, seen[0], step.stats))
    (want, wmet, wgrad, _), (got, gmet, ggrad, stats) = out
    if _model_ways(_mesh(mesh_name)) > 1:
        _dp_rule(got, gmet, ggrad, want, wmet, wgrad)
        assert stats["from_model_adds"] > 0
    else:
        assert torch.equal(_bits(gmet["loss"]), _bits(wmet["loss"]))
        assert _differ(ggrad, wgrad) == []
        assert _differ({k: got[k] for k in ("params", "opt")},
                       {k: want[k] for k in ("params", "opt")}) == []
        assert stats["from_model_adds"] == 0
    assert stats["max_live_layers"] <= cfg.encoder_layers + 1
    assert stats["live_after"] == 0


# ---------------------------------------------------------------------------
# the trainer, its checkpoint and the launcher
# ---------------------------------------------------------------------------

def _trainer(mesh, ckpt_dir, steps=1, n_micro=4):
    cfg = get_config("llama3-8b").reduced()
    tc = TrainerConfig(steps=steps, ckpt_every=1, ckpt_dir=str(ckpt_dir),
                       log_every=100)
    return Trainer(cfg, ShapeConfig("tiny", 16, 4, "train"), mesh, tc,
                   plan=TrainPlan(n_micro=n_micro, q_chunk=16))


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_init_state_is_todays_bit_for_bit(arch, tmp_path):
    """Drawn a leaf at a time and cut into 2 x 2 blocks, the state
    gathers to ``init_params(seed)``'s stacked tree and the optimizer's
    initial state over it; each position holds ``shard_bytes``."""
    cfg = get_config(arch).reduced()
    tr = Trainer(cfg, ShapeConfig("t", 16, 4, "train"), _mesh("2x2"),
                 TrainerConfig(ckpt_dir=str(tmp_path)),
                 plan=TrainPlan(n_micro=2, q_chunk=16))
    state = tr.init_state()
    params = stacked_params(build_model(cfg, device="cpu").init_params(0))
    want = {"params": params, "opt": tr.optimizer.init(params)}
    assert _differ({k: state[k] for k in want}, want) == []
    held, specs = tr.position_bytes(state), tr.specs()
    for k in ("params", "opt"):
        assert (held[k] == sh.shard_bytes(state[k], specs[k],
                                          tr.mesh)).all(), k


def test_checkpoints_rescale_across_meshes_bit_for_bit(tmp_path):
    """A 2 x 2 trainer's checkpoint restores on 1 x 1, that state's on
    2 x 2 and that one's on 4 x 1, every time bit for bit; the files are
    the whole-tree layout, so a step from each restore is the same."""
    state, hist = _trainer(_mesh("2x2"), tmp_path / "a").run()
    assert len(hist) == 1 and np.isfinite(hist[0])
    chain = [("a", "1x1", (1, 1)), ("b", "2x2", (2, 2)),
             ("c", "4x1", (4, 1))]
    for i, (name, _, shape) in enumerate(chain):
        tr = _trainer(make_host_mesh(*shape, device="cpu"),
                      tmp_path / name)
        restored, start = tr.restore_or_init()
        assert start == 1 and _differ(restored, state) == [], shape
        assert tree.leaves(restored["params"])[0].mesh is tr.mesh
        if i + 1 < len(chain):
            tckpt.save(tmp_path / chain[i + 1][0], 1, restored)
        state = restored
    with np.load(tmp_path / "a" / "step_00000001" / "arrays.npz") as data:
        assert data["params/head"].shape == tuple(state["params"][
            "head"].shape)


def test_launch_train_on_a_2x2_mesh(tmp_path, monkeypatch, capsys):
    """``launch.train --reduced --data-mesh 2 --model-mesh 2`` trains
    with the sharded state and writes its checkpoints."""
    from repro_torch.launch.train import main as train_main
    _on_cpu(monkeypatch)
    d = str(tmp_path)
    state, hist = train_main(["--reduced", "--steps", "2", "--seq", "16",
                              "--batch", "4", "--ckpt-dir", d,
                              "--ckpt-every", "2", "--data-mesh", "2",
                              "--model-mesh", "2"])
    assert len(hist) == 2 and all(np.isfinite(hist))
    assert tckpt.steps(d) == [2] and "done: loss" in capsys.readouterr().out
    head = state["params"]["head"]
    assert isinstance(head, blocks.Sharded) and head.parts == (2, 2)
    assert dict(head.mesh.shape) == {"data": 2, "model": 2}
