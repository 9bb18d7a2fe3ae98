"""The port's MoE FFN and the MoE decoders against the JAX package's, on the
CPU in f32 with the same numpy inputs and weights: routing, the capacity
drops (the dropped set itself, not only the output), ``moe_ffn`` and
``moe_ffn_decode``, and the reduced dbrx-132b (16 -> 4 experts, top 4 ->
2) and llama4-maverick (4 experts, top 1, with the shared expert):
forward, loss and decode, their weights carried across by
``convert.lm_params_from_jax``.  Tolerances: rtol 1e-4 (atol 1e-5);
routing and dispatch exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeConfig as JShape
from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro.models.registry import build_model as jbuild_model
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe

TOL = dict(rtol=1e-4, atol=1e-5)
D, F, E = 32, 48, 8


def _np(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)
            ).astype(np.float32)


def _moe_params(shared, seed=0, router_scale=None):
    p = {"router": _np(D, E, seed=seed, scale=router_scale or D ** -0.5),
         "we1": _np(E, D, F, seed=seed + 1, scale=D ** -0.5),
         "we3": _np(E, D, F, seed=seed + 2, scale=D ** -0.5),
         "we2": _np(E, F, D, seed=seed + 3, scale=F ** -0.5)}
    if shared:
        p.update(w1=_np(D, F, seed=seed + 4, scale=D ** -0.5),
                 w3=_np(D, F, seed=seed + 5, scale=D ** -0.5),
                 w2=_np(F, D, seed=seed + 6, scale=F ** -0.5))
    return p


def _kept(slot_src, t):
    """The set of (batch, entry) a dispatch keeps."""
    s = np.asarray(slot_src)
    return {(b, int(e)) for b in range(s.shape[0]) for e in s[b] if e < t}


# a skewed router (large logits) overfills the favourite experts at
# capacity factor 1.0; a zero router ties every gate, so top_k takes the
# lowest expert ids and every token lands on the same experts
ROUTERS = {"skewed": dict(router_scale=1.0, factor=1.0),
           "tied": dict(router_scale=0.0, factor=1.25),
           "ample": dict(router_scale=None, factor=4.0)}


@pytest.mark.parametrize("router", sorted(ROUTERS))
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_output_aux_and_dropped_set_match(router, top_k):
    opts = ROUTERS[router]
    p = _moe_params(shared=False, seed=1, router_scale=opts["router_scale"])
    if router == "tied":
        p["router"][:] = 0.0
    x = _np(2, 40, D, seed=9)
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    kw = dict(n_experts=E, top_k=top_k, capacity_factor=opts["factor"])
    want_y, want_aux = jmoe.moe_ffn(jp, jnp.asarray(x), **kw)
    got_y, got_aux = tmoe.moe_ffn(tp, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)
    # the routing and the dispatch, exactly
    _, jg, jids, _ = jmoe._route(jnp.asarray(x), jp["router"], top_k)
    _, tg, tids, _ = tmoe._route(torch.from_numpy(x), tp["router"], top_k)
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    t = 40 * top_k
    c = tmoe.capacity(t, E, opts["factor"], 4)
    expert = np.array(jids).reshape(2, t)
    want_src = jmoe._dispatch_indices(jnp.asarray(expert), E, c)
    got_src = tmoe._dispatch_indices(torch.from_numpy(expert), E, c)
    assert np.array_equal(got_src.numpy(), np.asarray(want_src))
    kept = _kept(want_src, t)
    assert kept == _kept(got_src, t)
    if router != "ample":
        assert len(kept) < 2 * t            # the case drops entries
    else:
        assert len(kept) == 2 * t


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("shared", [False, True])
def test_moe_ffn_decode_matches(b, shared):
    """The (B, 1) batch routed across the sequences with the capacity
    floor ``max(top_k + 4, 2 * ceil(B * top_k / E))``."""
    p = _moe_params(shared=shared, seed=20)
    x = _np(b, 1, D, seed=21)
    want = jmoe.moe_ffn_decode({n: jnp.asarray(a) for n, a in p.items()},
                               jnp.asarray(x), n_experts=E, top_k=2)
    got = tmoe.moe_ffn_decode({n: torch.from_numpy(a) for n, a in p.items()},
                              torch.from_numpy(x), n_experts=E, top_k=2)
    assert got.shape == (b, 1, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tmoe.decode_capacity(b, E, 2) == max(6, 2 * -(-b * 2 // E))


# ---------------------------------------------------------------------------
# dbrx and llama4, reduced
# ---------------------------------------------------------------------------

MOE_ARCHS = ["dbrx-132b", "llama4-maverick-400b-a17b"]


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_pair(request):
    jcfg = jget_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(lm_params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    return cfg, jm, jp, tm


def test_moe_model_forward_and_loss_match(moe_pair):
    cfg, jm, jp, tm = moe_pair
    shared = cfg.name.startswith("llama4")
    assert ("moe.w1" in dict(tm.blocks[0].named_parameters())) == shared
    assert tm.blocks[0].moe["router"].dtype == torch.float32
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 32))
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    jctx = jm.make_ctx(jnp.arange(32), q_chunk=16)
    want, want_aux = jm.forward(jp, batch, jctx, remat=False)
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    tctx = tm.make_ctx(torch.arange(32), q_chunk=16)
    got, aux = tm.forward(tb, tctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) > 0.0
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    np.testing.assert_allclose(float(tm.loss(tb, tctx)),
                               float(jm.loss(jp, batch, jctx, remat=False)),
                               rtol=1e-5)


@pytest.mark.parametrize("kind", ["full", "clustered"])
def test_moe_model_decode_matches(moe_pair, kind):
    cfg, jm, jp, tm = moe_pair
    b, steps = 2, 20
    extra = dict(cluster_compression=4, cluster_window=cfg.dh) \
        if kind == "clustered" else {}
    jc = jm.init_caches(b, JShape("s", 48, b, "decode", **extra), kind)
    tc = tm.init_caches(b, ShapeConfig("s", 48, b, "decode", **extra), kind)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (b, steps))
    jdecode = jax.jit(lambda p, c, t, pos: jm.decode_step(
        p, c, t, pos, ctx_extra={"cache_kind": kind}))
    for i in range(steps):
        lj, jc = jdecode(jp, jc, jnp.asarray(toks[:, i:i + 1], jnp.int32),
                         jnp.asarray(i, jnp.int32))
        lt, tc = tm.decode_step(torch.from_numpy(toks[:, i:i + 1]), tc, i,
                                cache_kind=kind)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
