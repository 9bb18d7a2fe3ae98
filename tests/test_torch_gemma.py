"""gemma3's local/global superblocks on the port against the JAX package,
at the reduced gemma3-12b (CPU, f32, 2 superblocks of 1 sliding-window
layer of window 32 + 1 global layer, head dim 16) with the JAX package's
weights carried across by ``convert.lm_params_from_jax``: the chunked
forward and loss, token-by-token decode for 48 > 32 positions (the local
rings wrap) with the full and the clustered cache, the decode against the
port's own forward, and the serving engine's greedy tokens.
Tolerances: rtol 1e-4 (atol 1e-5) unless stated."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeConfig as JShape
from repro.configs import get_config as jget_config
from repro.models.registry import build_model as jbuild_model
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import build_model
from repro_torch.serve import ServeConfig, ServeEngine

TOL = dict(rtol=1e-4, atol=1e-5)
S = 48                     # > the reduced window of 32: the rings wrap


@pytest.fixture(scope="module")
def gemma():
    jcfg = jget_config("gemma3-12b").reduced()
    cfg = get_config("gemma3-12b").reduced()
    assert cfg.window == 32 and cfg.local_per_global == 1 and cfg.dh == 16
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(lm_params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    return cfg, jm, jp, tm


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


def test_gemma_builds_superblocks(gemma):
    cfg, _, _, tm = gemma
    assert tm.group == "super" and len(tm.layers()) == 2
    assert [b.window for b in tm.attn_blocks()] == [32, 0, 32, 0]
    names = set(tm.state_dict())
    assert {"super.0.local.0.attn.wq", "super.1.global.w2"} <= names


def test_gemma_forward_and_loss_match(gemma):
    cfg, jm, jp, tm = gemma
    toks = _tokens(cfg, 2, S, 1)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    jctx = jm.make_ctx(jnp.arange(S), q_chunk=16)
    want, aux = jm.forward(jp, batch, jctx, remat=False)
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    tctx = tm.make_ctx(torch.arange(S), q_chunk=16)
    got, taux = tm.forward(tb, tctx)
    assert got.shape == (2, S, cfg.padded_vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(taux) == float(aux) == 0.0
    last, _ = tm.forward(tb, tctx, last_only=True)
    assert last.shape == (2, 1, cfg.padded_vocab)
    np.testing.assert_allclose(last.numpy(), got[:, -1:].numpy(), **TOL)
    np.testing.assert_allclose(float(tm.loss(tb, tctx)),
                               float(jm.loss(jp, batch, jctx, remat=False)),
                               rtol=1e-5)


@pytest.mark.parametrize("kind", ["full", "clustered"])
def test_gemma_decode_step_logits_match(gemma, kind):
    """48 steps; the local layers' 32-slot rings wrap.  The clustered
    cache of the global layers holds live centroids (some dead) beside a
    ring as long as the head dim, where the reference's ring is right
    (ROADMAP §3)."""
    cfg, jm, jp, tm = gemma
    b = 2
    extra = dict(cluster_compression=4, cluster_window=cfg.dh) \
        if kind == "clustered" else {}
    jc = jm.init_caches(b, JShape("s", 64, b, "decode", **extra), kind)
    tc = tm.init_caches(b, ShapeConfig("s", 64, b, "decode", **extra), kind)
    assert jax.tree.map(lambda a: a.shape, jc) == jax.tree.map(
        lambda t: tuple(t.shape), tc)
    if kind == "clustered":
        glob = jc["super"]["global"]
        rng = np.random.default_rng(2)
        live = {"kc": rng.normal(size=glob["kc"].shape),
                "vc": rng.normal(size=glob["vc"].shape),
                "counts": rng.integers(0, 5, glob["counts"].shape)}
        live = {n: a.astype(np.float32) for n, a in live.items()}
        jc["super"]["global"] = dict(glob, **{n: jnp.asarray(a)
                                              for n, a in live.items()})
        tc["super"]["global"].update({n: torch.from_numpy(a)
                                      for n, a in live.items()})
    toks = _tokens(cfg, b, S, 3)
    jdecode = jax.jit(lambda p, c, t, pos: jm.decode_step(
        p, c, t, pos, ctx_extra={"cache_kind": kind}))
    for i in range(S):
        lj, jc = jdecode(jp, jc, jnp.asarray(toks[:, i:i + 1], jnp.int32),
                         jnp.asarray(i, jnp.int32))
        lt, tc = tm.decode_step(torch.from_numpy(toks[:, i:i + 1]), tc, i,
                                cache_kind=kind)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    local = tc["super"]["local"]
    np.testing.assert_allclose(local["k"].numpy(),
                               np.asarray(jc["super"]["local"]["k"]), **TOL)
    assert local["slot_pos"][0, 0].tolist() == list(range(32, 48)) + list(
        range(16, 32))


def test_gemma_decode_matches_own_forward(gemma):
    """The reference's ``test_decode_matches_forward`` on the port: decode
    logits at every position equal the forward's (rtol/atol 2e-2, its
    tolerance), through the local rings' wrap."""
    cfg, _, _, tm = gemma
    toks = torch.from_numpy(_tokens(cfg, 1, S, 4))
    fwd, _ = tm.forward({"tokens": toks},
                        tm.make_ctx(torch.arange(S), q_chunk=S))
    caches = tm.init_caches(1, ShapeConfig("d", S, 1, "decode"), "full")
    dec = torch.cat([tm.decode_step(toks[:, t:t + 1], caches, t)[0]
                     for t in range(S)], 1)
    np.testing.assert_allclose(dec.numpy(), fwd.numpy(), rtol=2e-2,
                               atol=2e-2)


def test_gemma_clustered_ring_of_any_length(gemma):
    """The global layers' ring holds the last ``cluster_window`` tokens
    whatever the head dim: with no live centroid and a 24-slot ring (not
    the head dim, 16) longer than the 20 tokens, clustered decode is
    full-cache decode."""
    cfg, _, _, tm = gemma
    toks = torch.from_numpy(_tokens(cfg, 2, 20, 5))
    full = tm.init_caches(2, ShapeConfig("f", 48, 2, "decode"), "full")
    ring = tm.init_caches(2, ShapeConfig("c", 48, 2, "decode",
                                         cluster_compression=4,
                                         cluster_window=24), "clustered")
    assert ring["super"]["global"]["wk"].shape[3] == 24
    for i in range(20):
        lf, _ = tm.decode_step(toks[:, i:i + 1], full, i)
        lc, _ = tm.decode_step(toks[:, i:i + 1], ring, i,
                               cache_kind="clustered")
        torch.testing.assert_close(lc, lf, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["full", "clustered"])
def test_gemma_greedy_tokens_equal_reference_engine(gemma, kind):
    """Greedy generation after a 40-token prompt (> the window): the same
    tokens as the JAX engine.  The clustered case refreshes the global
    layers every 8 tokens into 16 centroids; the local rings are never
    folded."""
    cfg, jm, jp, tm = gemma
    jcfg = jm.cfg
    extra = dict(cluster_compression=4, cluster_window=cfg.dh) \
        if kind == "clustered" else {}
    every = 8 if kind == "clustered" else 0
    prompt = _tokens(cfg, 2, 40, 6)
    want = JServeEngine(jcfg, JShape("s", 64, 2, "decode", **extra), jp,
                        JServeConfig(max_tokens=6, recompress_every=every)
                        ).generate(jnp.asarray(prompt, jnp.int32))
    eng = ServeEngine(cfg, ShapeConfig("s", 64, 2, "decode", **extra), tm,
                      ServeConfig(max_tokens=6, recompress_every=every))
    assert eng.kind == kind
    got = eng.generate(torch.from_numpy(prompt))
    np.testing.assert_array_equal(got, np.asarray(want))
    if kind == "clustered":
        caches, _, _ = eng.prefill(torch.from_numpy(prompt))
        glob, local = caches["super"]["global"], caches["super"]["local"]
        # five refreshes of 8 tokens into every global (batch, kv head)
        np.testing.assert_allclose(glob["counts"].sum(-1).numpy(), 40.0)
        assert torch.all(glob["slot_pos"] == -1)
        assert sorted(local["slot_pos"][0, 0].tolist()) == list(range(8, 40))


def test_lm_params_from_jax_checks_the_stacks(gemma):
    """A tree stacked for another depth is refused, naming the leaf."""
    cfg, _, jp, _ = gemma
    tree = jax.tree.map(np.asarray, jp)
    tree["g_super"]["local"] = jax.tree.map(lambda a: a[:, :0],
                                            tree["g_super"]["local"])
    with pytest.raises(ValueError, match="g_super local"):
        lm_params_from_jax(cfg, tree)
