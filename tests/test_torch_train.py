"""The port's training path against the JAX package's on the CPU, reduced
llama3-8b in f32: ``make_train_step`` against the reference's jitted step,
the hoisted embedding's quirk, the gradient compressor, ``token_stream``,
the trainer's restart and the two launchers.

Tolerances.  A step starts from the reference's state carried across
(``convert.train_state_from_jax``), so each step is compared on its own:
loss at rtol 1e-6, ``grad_norm`` at rtol 1e-5, moments at rtol 1e-4 plus
1e-5 of the leaf's largest entry (the gradients' f32 sums).  Parameters
(and master weights) at rtol 1e-5, atol 1e-6, with one exception for
AdamW: its first steps move an entry by about ``lr * g / (|g| + eps)``,
so where the reference's gradient is at rounding level (below 1e-4 of
its leaf's largest entry; the two packages' f32 sums differ there by a
large part of it) the entry may land anywhere within ``2 lr`` of the
reference's.  Such entries are
counted and may be at most 0.1% of a leaf.  Adafactor has no such
entries: every parameter within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import ShapeConfig as JShape
from repro.configs import get_config as jget_config
from repro.data import synthetic as jsyn
from repro.models.registry import build_model as jbuild_model
from repro.train import compress as jcompress
from repro.train.step import TrainPlan as JPlan
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import optim as toptim
from repro_torch import tree
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.convert import lm_params_to_stacked, train_state_from_jax
from repro_torch.data import token_stream
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.train import compress as tcompress
from repro_torch.train.step import TrainPlan, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCH = "llama3-8b"
SEQ, BATCH, LR = 16, 4, 1e-2


def _jflat(t) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(t)[0]}


def _tflat(t) -> dict:
    return {tree.key_of(p): v.numpy() for p, v in tree.items(t)}


def _setup(opt_name: str, n_micro: int, weight_decay: float = 0.1):
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jshape, shape = JShape("t", SEQ, BATCH, "train"), ShapeConfig(
        "t", SEQ, BATCH, "train")
    make = {"adamw": lambda m: m.AdamW(lr=LR, master_weights=True,
                                       weight_decay=weight_decay),
            "adafactor": lambda m: m.Adafactor(lr=LR)}[opt_name]
    jopt, topt = make(joptim), make(toptim)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    js = {"params": jp, "opt": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(jmake_train_step(jm, jopt, jcfg, jshape,
                                     JPlan(n_micro=n_micro, q_chunk=8)))
    tm = build_model(cfg, device="cpu")
    tstep = make_train_step(tm, topt, cfg, shape,
                            TrainPlan(n_micro=n_micro, q_chunk=8))
    return cfg, js, jstep, tm, tstep


def _carried(js) -> dict:
    return train_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")


def _compare_step(opt_name, js_before, js, jmet, ts, tmet):
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]),
                               rtol=1e-7)
    if "grad_norm" in jmet:
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-5)
    want, got = _jflat(js), _tflat(ts)
    assert sorted(got) == sorted(want)
    assert int(got["step"]) == int(want["step"])
    before = _jflat(js_before)
    for key, w in want.items():
        g = got[key]
        if key.startswith(("opt/m/", "opt/v/", "opt/fac/")):
            np.testing.assert_allclose(
                g, w, rtol=1e-4, atol=1e-5 * float(np.abs(w).max()),
                err_msg=key)
        elif key.startswith(("params/", "opt/master/")):
            close = np.isclose(g, w, rtol=1e-5, atol=1e-6)
            if opt_name == "adafactor":
                assert close.all(), key
                continue
            leaf = key.split("/", 2)[-1] if key.startswith("opt/") \
                else key[len("params/"):]
            b1 = 0.9
            grad = ((want[f"opt/m/{leaf}"] - b1 * before[f"opt/m/{leaf}"])
                    / (1 - b1))
            tiny = np.abs(grad) < 1e-4 * np.abs(grad).max()
            assert (close | tiny).all(), key
            odd = ~close
            assert odd.sum() <= 1e-3 * odd.size, (key, int(odd.sum()))
            assert (np.abs(g - w)[odd] <= 2 * LR).all(), key


@pytest.mark.parametrize("opt_name,n_micro", [("adamw", 2), ("adafactor", 1),
                                              ("adafactor", 2)])
def test_train_steps_match_the_reference(opt_name, n_micro):
    """Three steps, each from the reference's state carried across."""
    cfg, js, jstep, _, tstep = _setup(opt_name, n_micro)
    for step in range(3):
        batch = token_stream(step, BATCH, SEQ, cfg.vocab)
        ts = _carried(js)
        js_before = js
        js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tmet = tstep(ts, batch)
        _compare_step(opt_name, js_before, js, jmet, ts, tmet)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_three_steps_on_the_ports_own_state(opt_name):
    """The port carrying its own state through three steps keeps the
    reference's losses (rtol 1e-5) and gradient norms (rtol 1e-4)."""
    cfg, js, jstep, _, tstep = _setup(opt_name, 2)
    ts = _carried(js)
    for step in range(3):
        batch = token_stream(step, BATCH, SEQ, cfg.vocab)
        js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tmet = tstep(ts, batch)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        if "grad_norm" in jmet:
            np.testing.assert_allclose(float(tmet["grad_norm"]),
                                       float(jmet["grad_norm"]), rtol=1e-4)
    assert int(ts["step"]) == 3 and int(ts["opt"]["step"]) == 3


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_the_hoisted_embedding_gets_no_gradient(weight_decay):
    """The reference gathers the embeddings outside the gradient, so an
    untied ``embed`` keeps zero moments and moves only by weight decay
    (not at all without it); the port does the same, as the reference's
    own step shows."""
    cfg, js, jstep, _, tstep = _setup("adamw", 2, weight_decay)
    ts = _carried(js)
    e0 = ts["params"]["embed"].clone()
    batch = token_stream(0, BATCH, SEQ, cfg.vocab)
    js, _ = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
    ts, _ = tstep(ts, batch)
    assert not ts["opt"]["m"]["embed"].any()
    assert not ts["opt"]["v"]["embed"].any()
    want = e0 - LR * (0.0 + weight_decay * e0)
    assert torch.equal(ts["params"]["embed"], want)
    if weight_decay == 0.0:
        assert torch.equal(ts["params"]["embed"], e0)
    # the reference's own step: within an f32 rounding (XLA may fuse the
    # decay's multiply-add)
    np.testing.assert_allclose(ts["params"]["embed"].numpy(),
                               np.asarray(js["params"]["embed"]), rtol=2e-7,
                               atol=0)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def _leaves():
    rng = np.random.default_rng(0)
    return {"a": rng.normal(size=(64, 64)).astype(np.float32),
            "b": rng.normal(size=(4, 8)).astype(np.float32),
            "g_blocks": {"w": rng.standard_t(3, size=(3, 70, 90))
                         .astype(np.float32)},
            "zero": np.zeros((16, 16), np.float32)}


@pytest.mark.parametrize("levels", [4, 16])
def test_quantize_leaf_matches_the_reference_codebooks(levels):
    """The landmark-initialised 1-D k-means on the strided sample gives the
    reference's codebook (rtol 1e-5), and every value its code."""
    for key, g in tree.items(_leaves()):
        want, wstats = jcompress.quantize_leaf(jnp.asarray(g), levels,
                                               jax.random.PRNGKey(0))
        got, gstats = tcompress.quantize_leaf(torch.from_numpy(g), levels)
        np.testing.assert_allclose(gstats["codebook"].numpy(),
                                   np.asarray(wstats["codebook"]),
                                   rtol=1e-5, atol=1e-7, err_msg=str(key))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7, err_msg=str(key))
        assert got.shape == g.shape and got.dtype == torch.float32


def test_grad_compressor_error_feedback_and_zero_leaf():
    """``dequantized + residual == g + the previous residual`` (rel 1e-6);
    the all-zero leaf quantizes to finite zeros; the compressed bytes are
    the reference's."""
    g = tree.map_(torch.from_numpy, _leaves())
    comp = tcompress.make_grad_compressor(levels=16)
    out, resid = comp(g)
    jout, jres = jcompress.make_grad_compressor(levels=16)(
        jax.tree.map(jnp.asarray, _leaves()))
    for key, w in _jflat(jout).items():
        np.testing.assert_allclose(_tflat(out)[key], w, rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    for key, w in _jflat(jres).items():
        np.testing.assert_allclose(_tflat(resid)[key], w, rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    for (key, o), r, x in zip(tree.items(out), tree.leaves(resid),
                              tree.leaves(g)):
        rel = float((o + r - x).norm() / x.norm().clamp_min(1e-30))
        assert rel < 1e-6, key
    assert torch.isfinite(out["zero"]).all() and not out["zero"].any()
    assert not resid["zero"].any()
    out2, resid2 = comp(g, resid)           # the residual carried in
    for o, r, x, r0 in zip(tree.leaves(out2), tree.leaves(resid2),
                           tree.leaves(g), tree.leaves(resid)):
        assert float((o + r - x - r0).norm()) <= 1e-6 * float(
            (x + r0).norm()) + 1e-12
    raw, small = tcompress.compressed_bytes(g, 16)
    assert (raw, small) == jcompress.compressed_bytes(
        jax.tree.map(jnp.asarray, _leaves()), 16)
    assert small < raw / 7


def test_grad_compressor_from_a_spec():
    """``spec=``: ``merge.k`` levels, the merge's stop and init."""
    from repro_torch.core import ClusterSpec, MergeSpec
    spec = ClusterSpec(merge=MergeSpec(k=8, iters=5, init="landmark"))
    out, _ = tcompress.make_grad_compressor(spec=spec)(
        {"a": torch.from_numpy(_leaves()["a"])})
    assert out["a"].unique().numel() <= 8
    want, _ = tcompress.quantize_leaf(torch.from_numpy(_leaves()["a"]), 8,
                                      iters=5)
    assert torch.equal(out["a"], want)


def test_compressor_hooked_into_the_train_step():
    """``compress_fn=lambda g: comp(g)[0]`` in both packages' steps: the
    same loss, and every parameter within the AdamW rule above."""
    cfg, js, _, tm, _ = _setup("adamw", 2)
    jcfg = jget_config(ARCH).reduced()
    jm = jbuild_model(jcfg)
    jopt = joptim.AdamW(lr=LR, master_weights=True)
    topt = toptim.AdamW(lr=LR, master_weights=True)
    jcomp = jcompress.make_grad_compressor(levels=16)
    tcomp = tcompress.make_grad_compressor(levels=16)
    jstep = jmake_train_step(jm, jopt, jcfg, JShape("t", SEQ, BATCH, "train"),
                             JPlan(n_micro=2, q_chunk=8),
                             compress_fn=lambda g: jcomp(g)[0])
    tstep = make_train_step(tm, topt, cfg, ShapeConfig("t", SEQ, BATCH,
                                                       "train"),
                            TrainPlan(n_micro=2, q_chunk=8),
                            compress_fn=lambda g: tcomp(g)[0])
    batch = token_stream(0, BATCH, SEQ, cfg.vocab)
    ts = _carried(js)
    js2, jmet = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
    ts, tmet = tstep(ts, batch)
    _compare_step("adamw", js, js2, jmet, ts, tmet)


# ---------------------------------------------------------------------------
# data, trainer, launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (11, 250)])
def test_token_stream_matches_the_reference(seed, step):
    want = jsyn.token_stream(step, 4, 32, 1000, seed=seed)
    got = token_stream(step, 4, 32, 1000, seed=seed)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def _trainer(steps, ckpt_dir, mesh=None):
    cfg = get_config(ARCH).reduced()
    shape = ShapeConfig("tiny", 32, 4, "train")
    tc = TrainerConfig(steps=steps, ckpt_every=2, ckpt_dir=str(ckpt_dir),
                       log_every=100)
    return Trainer(cfg, shape, mesh or make_host_mesh(1, 1, device="cpu"),
                   tc, plan=TrainPlan(n_micro=2, q_chunk=32))


def test_trainer_restart_continues(tmp_path):
    """The counterpart of the reference's restart test, and the resumed
    run's losses equal an uninterrupted run's."""
    state, hist = _trainer(4, tmp_path / "a").run()
    assert len(hist) == 4 and tckpt.steps(tmp_path / "a") == [2, 4]
    state2, hist2 = _trainer(6, tmp_path / "a").run()
    assert len(hist2) == 2                  # resumed from step 4
    assert int(state2["step"]) == 6
    assert tckpt.steps(tmp_path / "a") == [2, 4, 6]
    _, whole = _trainer(6, tmp_path / "b").run()
    assert hist + hist2 == whole
    assert all(np.isfinite(whole)) and whole[-1] < whole[0]


def test_trainer_keeps_the_last_checkpoints(tmp_path):
    t = _trainer(8, tmp_path)
    t.tcfg.keep_last = 2
    t.run()
    assert tckpt.steps(tmp_path) == [6, 8]


def test_trainer_refuses_a_larger_mesh(tmp_path):
    """A mesh whose data shards do not divide the plan's micro-batches (4
    shards, 2 micro-batches) is refused, not trained on another plan."""
    mesh = make_host_mesh(4, 1, device="cpu")
    with pytest.raises(ValueError, match="n_micro=2"):
        _trainer(2, tmp_path, mesh=mesh)


def test_trainer_trains_on_a_two_shard_mesh(tmp_path):
    """A (2, 1) mesh trains: one micro-batch a shard, so its loss is the
    one-shard trainer's bit for bit."""
    _, hist = _trainer(1, tmp_path / "two",
                       mesh=make_host_mesh(2, 1, device="cpu")).run()
    _, want = _trainer(1, tmp_path / "one").run()
    assert hist == want and all(np.isfinite(hist))
    assert tckpt.steps(tmp_path / "two") == [1]


def test_trainer_picks_the_reference_plan(tmp_path):
    """No plan: ``default_plan`` (AdamW with master weights below 3e10
    parameters; Adafactor, no master weights, bf16 accumulation for the
    MoE giants)."""
    cfg = get_config(ARCH).reduced()
    shape = ShapeConfig("tiny", 32, 4, "train")
    tr = Trainer(cfg, shape, make_host_mesh(1, 1, device="cpu"),
                 TrainerConfig(ckpt_dir=str(tmp_path)))
    assert tr.plan.optimizer == "adamw" and tr.plan.n_micro == 4
    assert isinstance(tr.optimizer, toptim.AdamW)
    assert tr.optimizer.master_weights
    from repro_torch.train.step import default_plan
    giant = default_plan(get_config("llama4-maverick-400b-a17b"), shape, 1)
    assert (giant.optimizer, giant.grad_dtype) == ("adafactor", "bfloat16")


def _on_cpu(monkeypatch):
    """Entry points that default to the card default to the CPU here."""
    import repro_torch.core.device as dv
    import repro_torch.launch.mesh as lm
    resolve, host_mesh = dv.resolve_device, lm.make_host_mesh
    monkeypatch.setattr(dv, "resolve_device",
                        lambda d=None: resolve("cpu" if d is None else d))
    monkeypatch.setattr(lm, "make_host_mesh",
                        lambda n_data=1, n_model=1, device=None:
                        host_mesh(n_data, n_model, device="cpu"))


def test_launchers_train_then_serve_the_checkpoint(tmp_path, monkeypatch,
                                                   capsys):
    """``launch.train`` writes its checkpoints; ``launch.serve
    --ckpt-dir`` serves exactly the newest one's parameters."""
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    _on_cpu(monkeypatch)
    d = str(tmp_path)
    _, hist = train_main(["--reduced", "--steps", "3", "--seq", "16",
                          "--batch", "4", "--ckpt-dir", d,
                          "--ckpt-every", "2"])
    assert len(hist) == 3 and tckpt.steps(d) == [2, 3]
    assert "done: loss" in capsys.readouterr().out
    out, model = serve_main(["--reduced", "--ckpt-dir", d, "--prompt-len",
                             "8", "--gen", "4", "--batch", "2"])
    assert out.shape == (2, 4)
    served = lm_params_to_stacked({n: p.detach() for n, p in
                                   model.named_parameters()})
    with np.load(tmp_path / "step_00000003" / "arrays.npz") as data:
        for path, leaf in tree.items(served):
            np.testing.assert_array_equal(
                leaf.numpy(), data["params/" + tree.key_of(path)])


def test_loss_prefill_and_serve_steps_match_the_reference():
    """``make_loss_fn``, ``make_prefill_step`` and ``make_serve_step`` on a
    stacked parameter tree carried across, against the reference's (loss
    rtol 1e-5; logits rtol 1e-4, atol 1e-5)."""
    from repro.train import step as jstep_mod
    from repro_torch.train import step as tstep_mod
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jshape = JShape("t", SEQ, BATCH, "train")
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tm = build_model(cfg, device="cpu")
    tp = _carried({"params": jp})["params"]
    batch = token_stream(5, BATCH, SEQ, cfg.vocab)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jstep_mod.make_loss_fn(jm, jcfg, jshape, JPlan(q_chunk=8),
                                  None)(jp, jb)
    got = tstep_mod.make_loss_fn(tm, cfg, shape, TrainPlan(q_chunk=8))(
        tp, batch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    want = jstep_mod.make_prefill_step(jm, jcfg, jshape, q_chunk=8)(
        jp, {"tokens": jb["tokens"]})
    got = tstep_mod.make_prefill_step(tm, cfg, shape, q_chunk=8)(
        tp, {"tokens": batch["tokens"]})
    assert got.shape == (BATCH, 1, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    dshape = ShapeConfig("d", SEQ, BATCH, "decode")
    jcaches = jm.init_caches(BATCH, JShape("d", SEQ, BATCH, "decode"), "full")
    tcaches = tm.init_caches(BATCH, dshape, "full")
    jserve = jstep_mod.make_serve_step(jm, jcfg, jshape, "full")
    tserve = tstep_mod.make_serve_step(tm, cfg, dshape, "full")
    for pos in range(3):
        tok = batch["tokens"][:, pos:pos + 1]
        want, jcaches = jserve(jp, jcaches, jnp.asarray(tok),
                               jnp.asarray(pos, jnp.int32))
        got, tcaches = tserve(tp, tcaches, torch.from_numpy(tok), pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
