"""The port's encoder-decoder (whisper) against the JAX package's on the
CPU, reduced whisper-base in f32: the same weights
(``convert.lm_params_from_jax``) and the same inputs (numpy, from a
seed).

Tolerances: ``encode``, ``forward``, ``loss`` and ``loss_embedded`` at
rtol 1e-4 (logits also atol 1e-5); each gradient leaf at rtol 1e-4 plus
1e-4 of the leaf's largest entry; decode logits at rtol 1e-4, atol 1e-5;
the port's decode against its own forward at atol 1e-4.  The reference
never fills the decode's cross-attention caches, so the decode is held
twice: on zero caches (what both engines serve) and on caches filled
with the same projected encoder output in both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import SHAPES as JSHAPES
from repro.configs import ShapeConfig as JShape
from repro.configs import get_config as jget_config
from repro.models import registry as jregistry
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train.step import TrainPlan as JPlan
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import optim as toptim
from repro_torch import tree
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig, get_config
from repro_torch.convert import (lm_params_from_jax, lm_params_to_stacked,
                                 stack_path, stacked_like, stacked_params,
                                 train_state_from_jax)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import EncDecLM, batch_like, build_model, input_specs
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train.step import TrainPlan, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCH = "whisper-base"
B, S, CHUNK, DEC = 2, 16, 8, 16


def _jflat(t) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(t)[0]}


def _tflat(t) -> dict:
    return {tree.key_of(p): v.detach().numpy() for p, v in tree.items(t)}


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {"frames": rng.normal(size=(B, cfg.encoder_ctx, cfg.d_model)
                                 ).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}


@pytest.fixture(scope="module")
def pair():
    """(cfg, reference model, its params, port model, batch, the two
    ctxs): reduced whisper with the same weights."""
    cfg, jcfg = get_config(ARCH).reduced(), jget_config(ARCH).reduced()
    jm = jregistry.build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    assert isinstance(tm, EncDecLM)
    tm.load_state_dict(lm_params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    jctx = jm.make_ctx(jnp.arange(S), q_chunk=CHUNK)
    tctx = tm.make_ctx(torch.arange(S), q_chunk=CHUNK)
    return cfg, jm, jp, tm, _batch(cfg), jctx, tctx


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_the_reference_tree_carries_across_both_ways(pair):
    """``lm_params_to_stacked`` of the carried parameters is the
    reference's tree, leaf for leaf; ``stack_path`` names its groups."""
    cfg, _, jp, tm, *_ = pair
    want = _jflat(jp)
    got = _tflat(lm_params_to_stacked(dict(tm.named_parameters())))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_array_equal(got[key], w, err_msg=key)
    assert stack_path("enc.1.attn.wq") == (("enc", "attn", "wq"), (1,))
    assert stack_path("dec.0.lnx") == (("dec", "lnx"), (0,))
    assert stack_path("enc_ln") == (("enc_ln",), ())
    like = _tflat(tree.map_(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                            stacked_like(cfg)))
    assert {k: v.shape for k, v in like.items()} == \
        {k: v.shape for k, v in want.items()}


def test_encode_matches(pair):
    cfg, jm, jp, tm, batch, jctx, tctx = pair
    want = jm.encode(jp, jnp.asarray(batch["frames"]), jctx)
    got = tm.encode(torch.from_numpy(batch["frames"]), tctx)
    assert got.shape == (B, cfg.encoder_ctx, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("last_only", [False, True])
def test_forward_matches(pair, last_only):
    cfg, jm, jp, tm, batch, jctx, tctx = pair
    want, _ = jax.jit(lambda p, b: jm.forward(p, b, jctx,
                                              last_only=last_only))(
        jp, _j(batch))
    got, aux = tm.forward(_t(batch), tctx, last_only=last_only)
    assert got.shape == (B, 1 if last_only else S, cfg.padded_vocab)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def _port_grads(tm, fn):
    named = dict(tm.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    try:
        loss = fn()
        gs = torch.autograd.grad(loss, list(named.values()),
                                 allow_unused=True)
    finally:
        for p in named.values():
            p.requires_grad_(False)
    return float(loss.detach()), {
        n: (torch.zeros_like(p) if g is None else g)
        for (n, p), g in zip(named.items(), gs)}


@pytest.mark.parametrize("entry", ["loss", "loss_embedded"])
def test_loss_and_gradients_match_the_reference(pair, entry):
    _, jm, jp, tm, batch, jctx, tctx = pair
    jb, tb = _j(batch), _t(batch)
    if entry == "loss":
        jloss, jg = jax.jit(jax.value_and_grad(
            lambda p: jm.loss(p, jb, jctx, remat=True)))(jp)
        tloss, tg = _port_grads(tm, lambda: tm.loss(tb, tctx, remat=True))
    else:
        rest = {"frames": jb["frames"], "labels": jb["labels"]}
        x = jm.embed_in(jp, jb, jctx)
        jloss, jg = jax.jit(jax.value_and_grad(
            lambda p: jm.loss_embedded(p, x, rest, jctx, remat=True)))(jp)
        with torch.no_grad():
            tx = tm.embed_in(tb)
        tloss, tg = _port_grads(tm, lambda: tm.loss_embedded(
            tx, {"frames": tb["frames"], "labels": tb["labels"]}, tctx,
            remat=True))
    np.testing.assert_allclose(tloss, float(jloss), rtol=1e-4)
    want, got = _jflat(jg), _tflat(lm_params_to_stacked(tg))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=key)
    if entry == "loss_embedded":     # the embedding is an input here
        assert not want["embed"].any() and not got["embed"].any()


def test_remat_gives_the_same_gradients_and_serving_no_graph(pair):
    _, _, _, tm, batch, _, tctx = pair
    tb = _t(batch)
    l_on, g_on = _port_grads(tm, lambda: tm.loss(tb, tctx, remat=True))
    l_off, g_off = _port_grads(tm, lambda: tm.loss(tb, tctx, remat=False))
    assert l_on == l_off
    for name in g_on:
        torch.testing.assert_close(g_on[name], g_off[name], rtol=0, atol=0)
    logits, _ = tm.forward(tb, tctx)
    assert logits.grad_fn is None and not logits.requires_grad


def _cross(jm, jp, frames, jctx):
    """Each decoder layer's cross keys and values of the reference's
    encoding of ``frames``, as the caches hold them: (L, B, kv, T, dh)."""
    enc = np.asarray(jm.encode(jp, jnp.asarray(frames), jctx))
    dec = jax.tree.map(np.asarray, jp["dec"])
    b, t, _ = enc.shape
    kv, dh = jm.dims.n_kv, jm.dims.dh

    def proj(w):
        return np.stack([(enc @ w[i]).reshape(b, t, kv, dh).transpose(
            0, 2, 1, 3) for i in range(w.shape[0])])

    return proj(dec["xattn"]["wk"]), proj(dec["xattn"]["wv"])


@pytest.mark.parametrize("filled", [False, True])
def test_decode_step_matches_the_reference(pair, filled):
    """``DEC`` tokens through both decoders: the logits of every step,
    and the self-attention caches at the end."""
    cfg, jm, jp, tm, batch, jctx, _ = pair
    jshape = JShape("d", DEC, B, "decode")
    jc = jm.init_caches(B, jshape, "full")
    tc = tm.init_caches(B, ShapeConfig("d", DEC, B, "decode"), "full")
    assert tc["xk"].shape == (cfg.n_layers, B, cfg.n_kv_heads,
                              cfg.encoder_ctx, cfg.dh)
    if filled:
        xk, xv = _cross(jm, jp, batch["frames"], jctx)
        jc = dict(jc, xk=jnp.asarray(xk), xv=jnp.asarray(xv))
        tc["xk"].copy_(torch.from_numpy(xk))
        tc["xv"].copy_(torch.from_numpy(xv))
    step = jax.jit(lambda c, t, pos: jm.decode_step(jp, c, t, pos))
    for pos in range(DEC):
        tok = batch["tokens"][:, pos:pos + 1]
        want, jc = step(jc, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
        got, tc = tm.decode_step(torch.from_numpy(tok), tc, pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5, err_msg=f"pos {pos}")
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["self"][name].numpy(),
                                   np.asarray(jc["self"][name]), rtol=1e-4,
                                   atol=1e-5)


def test_decode_matches_the_ports_forward(pair):
    """With the cross caches filled from the port's own encoding, the
    decode's logits at every position are the forward's."""
    _, _, _, tm, batch, _, tctx = pair
    tb = _t(batch)
    fwd, _ = tm.forward(tb, tctx)
    caches = tm.init_caches(B, ShapeConfig("d", S, B, "decode"), "full")
    enc = tm.encode(tb["frames"], tctx)
    for i, blk in enumerate(tm.dec):
        k, v = blk.cross_kv(enc)
        caches["xk"][i] = k.transpose(1, 2)
        caches["xv"][i] = v.transpose(1, 2)
    dec = torch.cat([tm.decode_step(tb["tokens"][:, t:t + 1], caches, t)[0]
                     for t in range(S)], 1)
    np.testing.assert_allclose(dec.numpy(), fwd.numpy(), atol=1e-4)


def test_init_params_draws_every_weight_at_the_reference_scales():
    cfg = get_config(ARCH).reduced()
    tm = build_model(cfg, device="cpu").init_params(3)
    assert abs(float(tm.embed.std()) - 0.02) < 2e-3
    for name, p in tm.named_parameters():
        if p.dim() >= 2 and name != "embed":
            want = p.shape[-2] ** -0.5
            assert abs(float(p.std()) / want - 1) < 0.15, name
        elif p.dim() == 1:
            assert not p.any(), name
    again = build_model(cfg, device="cpu").init_params(3)
    for (n, a), (_, b) in zip(tm.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n


def test_init_caches_refuses_a_clustered_cache():
    tm = build_model(get_config(ARCH).reduced(), device="cpu")
    with pytest.raises(ValueError, match="full cache"):
        tm.init_caches(1, SHAPES["long_500k"], "clustered")


def test_train_step_matches_the_reference():
    """One ``make_train_step`` step (Adafactor, 2 micro-batches) from the
    reference's state carried across: loss at rtol 1e-5, parameters at
    rtol 1e-5 / atol 1e-6, moments at rtol 1e-4 plus 1e-5 of the leaf's
    largest entry; ``frames`` travel with the labels."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jshape, shape = JShape("t", S, 4, "train"), ShapeConfig("t", S, 4,
                                                            "train")
    jopt, topt = joptim.Adafactor(lr=1e-2), toptim.Adafactor(lr=1e-2)
    jm = jregistry.build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    js = {"params": jp, "opt": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
    ts = train_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    rng = np.random.default_rng(2)
    batch = {"frames": rng.normal(size=(4, cfg.encoder_ctx, cfg.d_model)
                                  ).astype(np.float32),
             "tokens": rng.integers(0, cfg.vocab, (4, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (4, S)).astype(np.int32)}
    jstep = jax.jit(jmake_train_step(jm, jopt, jcfg, jshape,
                                     JPlan(n_micro=2, q_chunk=CHUNK)))
    js, jmet = jstep(js, _j(batch))
    tm = build_model(cfg, device="cpu")
    tstep = make_train_step(tm, topt, cfg, shape,
                            TrainPlan(n_micro=2, q_chunk=CHUNK))
    ts, tmet = tstep(ts, batch)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    want, got = _jflat(js), _tflat(ts)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if key.startswith("opt/"):
            np.testing.assert_allclose(
                got[key], w, rtol=1e-4, atol=1e-5 * float(np.abs(w).max()),
                err_msg=key)
        else:
            np.testing.assert_allclose(got[key], w, rtol=1e-5, atol=1e-6,
                                       err_msg=key)


def test_train_state_checkpoint_round_trip(tmp_path):
    """A whisper train state (bf16 parameters, AdamW with f32 master
    weights) written and read back bit for bit through the ``like`` of
    ``stacked_like``."""
    import dataclasses
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="bfloat16")
    opt = toptim.AdamW(lr=1e-3, master_weights=True)
    params = stacked_params(build_model(cfg, device="cpu").init_params(5))
    state = {"params": params, "opt": opt.init(params),
             "step": torch.tensor(3, dtype=torch.int32)}
    tckpt.save(tmp_path, 3, state)
    like_p = stacked_like(cfg)
    like = {"params": like_p, "opt": opt.init(like_p),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}
    got, _ = tckpt.restore(tmp_path, 3, like, device="cpu")
    want = dict(tree.items(state))
    assert sorted(map(tree.key_of, dict(tree.items(got)))) == \
        sorted(map(tree.key_of, want))
    for path, g in tree.items(got):
        w = want[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(g.view(torch.int16) if g.dtype == torch.bfloat16
                           else g, w.view(torch.int16)
                           if w.dtype == torch.bfloat16 else w), path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_batch_like_match_the_reference(arch):
    """``input_specs`` at every shape (full size, on ``meta``), and
    ``batch_like`` at each shape cut to batch 2 and 8 tokens: names,
    shapes and dtypes as the reference's, ids within the vocabulary."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, shape in SHAPES.items():
        want = jregistry.input_specs(jcfg, JSHAPES[name])
        got = input_specs(cfg, shape)
        assert list(got) == list(want), (arch, name)
        for k, sds in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(sds.shape), (arch, name, k)
            assert str(got[k].dtype).split(".")[1] == sds.dtype.name
        cut = ShapeConfig(name, 8, 2, shape.kind)
        want = jregistry.batch_like(jcfg, JShape(name, 8, 2, shape.kind),
                                    jax.random.PRNGKey(0))
        got = batch_like(cfg, cut, 0, device="cpu")
        again = batch_like(cfg, cut, 0, device="cpu")
        assert list(got) == list(want)
        for k, w in want.items():
            g = got[k]
            assert tuple(g.shape) == w.shape and g.device.type == "cpu"
            assert str(g.dtype).split(".")[1] == w.dtype.name, (arch, k)
            assert torch.equal(g, again[k])
            if k == "pos":
                assert int(g) == int(w) == 7
            elif g.dtype == torch.int32:
                assert 0 <= int(g.min()) and int(g.max()) < cfg.vocab


def test_serve_engine_greedy_tokens_match_the_reference(pair):
    """Both engines on zero cross caches (neither fills them): the same
    greedy tokens."""
    cfg, _, jp, tm, batch, _, _ = pair
    jcfg = jget_config(ARCH).reduced()
    prompt = batch["tokens"][:, :8]
    want = JServeEngine(jcfg, JShape("s", 16, B, "decode"), jp,
                        JServeConfig(max_tokens=8)).generate(
                            jnp.asarray(prompt))
    eng = ServeEngine(cfg, ShapeConfig("s", 16, B, "decode"), tm,
                      ServeConfig(max_tokens=8))
    assert eng.kind == "full"
    got = eng.generate(prompt)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_trainer_refuses_whisper(tmp_path):
    with pytest.raises(ValueError, match="batch_like"):
        Trainer(get_config(ARCH).reduced(), ShapeConfig("t", 16, 2, "train"),
                make_host_mesh(1, 1, device="cpu"),
                TrainerConfig(ckpt_dir=str(tmp_path)))


def test_serve_launcher_serves_whisper(monkeypatch):
    import repro_torch.core.device as dv
    from repro_torch.launch.serve import main as serve_main
    resolve = dv.resolve_device
    monkeypatch.setattr(dv, "resolve_device",
                        lambda d=None: resolve("cpu" if d is None else d))
    out, model = serve_main(["--arch", ARCH, "--reduced", "--prompt-len",
                             "8", "--gen", "4", "--batch", "2"])
    assert isinstance(model, EncDecLM) and out.shape == (2, 4)
    assert int(out.min()) >= 0 and int(out.max()) < model.cfg.padded_vocab
