"""The port's loss and its gradients against ``jax.value_and_grad`` of the
JAX package's ``loss`` and ``loss_embedded``, on the CPU in f32, for every
family the port builds: the same weights (``convert.lm_params_from_jax``)
and the same batch (numpy, from a seed).  The gradients are compared in
the reference's stacked layout (``convert.lm_params_to_stacked``).

Query chunks of 8 and recurrent chunks of 8 over 16 tokens make the
chunked attention and the chunk scan take several steps.  Tolerances: the
loss at rtol 1e-5; each gradient leaf at rtol 1e-3 plus an atol of 1e-4
of the leaf's largest entry (float32 sums in another order, through up to
four layers and the backward)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.registry import build_model as jbuild_model
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax, lm_params_to_stacked
from repro_torch.models import build_model

ARCHS = ["llama3-8b", "gemma3-12b", "dbrx-132b", "internvl2-2b",
         "xlstm-1.3b", "zamba2-2.7b"]
B, S, CHUNK = 2, 16, 8


def _flat_jax(t) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(t)[0]}


def _flat_port(named: dict) -> dict:
    return {tree.key_of(p): v.detach().numpy()
            for p, v in tree.items(lm_params_to_stacked(named))}


def assert_tree_close(got: dict, want: dict, rtol=1e-3, rel_atol=1e-4):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        atol = rel_atol * float(np.abs(w).max()) + 1e-12
        np.testing.assert_allclose(got[key], w, rtol=rtol, atol=atol,
                                   err_msg=key)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.n_patches:
        batch["patches"] = rng.normal(
            size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(cfg, reference model, its params, port model, batch, the two
    ctxs) for one arch, reduced, with the same weights."""
    arch = request.param
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(lm_params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    n = S + (cfg.n_patches or 0)
    jctx = jm.make_ctx(jnp.arange(n), q_chunk=CHUNK)
    tctx = tm.make_ctx(torch.arange(n), q_chunk=CHUNK)
    jctx["ssm_chunk"] = tctx["ssm_chunk"] = CHUNK
    return cfg, jm, jp, tm, _batch(cfg), jctx, tctx


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
    grads = {n: (torch.zeros_like(p) if g is None else g)
             for (n, p), g in zip(named.items(), gs)}
    return float(loss.detach()), grads


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("entry", ["loss", "loss_embedded"])
def test_loss_and_gradients_match_the_reference(pair, entry):
    cfg, jm, jp, tm, batch, jctx, tctx = pair
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = _tbatch(batch)
    if entry == "loss":
        jloss, jg = jax.value_and_grad(
            lambda p: jm.loss(p, jb, jctx, remat=True))(jp)
        tloss, tg = _port_grads(tm, lambda: tm.loss(tb, tctx, remat=True))
    else:
        rest = {"labels": jb["labels"]}
        x = jm.embed_in(jp, jb, jctx)
        jloss, jg = jax.value_and_grad(
            lambda p: jm.loss_embedded(p, x, rest, jctx, remat=True))(jp)
        with torch.no_grad():
            tx = tm.embed_in(tb)
        tloss, tg = _port_grads(tm, lambda: tm.loss_embedded(
            tx, {"labels": tb["labels"]}, tctx, remat=True))
    np.testing.assert_allclose(tloss, float(jloss), rtol=1e-5)
    got, want = _flat_port(tg), _flat_jax(jg)
    assert_tree_close(got, want)
    if entry == "loss_embedded" and not cfg.tie_embeddings:
        # the embedding is an input here (a tied one is the head too)
        assert not want["embed"].any() and not got["embed"].any()


def test_remat_gives_the_same_gradients(pair):
    """Recomputing each layer in the backward pass changes nothing."""
    cfg, _, _, tm, batch, _, tctx = pair
    tb = _tbatch(batch)
    l_on, g_on = _port_grads(tm, lambda: tm.loss(tb, tctx, remat=True))
    l_off, g_off = _port_grads(tm, lambda: tm.loss(tb, tctx, remat=False))
    assert l_on == l_off
    for name in g_on:
        torch.testing.assert_close(g_on[name], g_off[name], rtol=0, atol=0)


def test_serving_builds_no_graph(pair):
    """The parameters are made without gradients, so ``forward`` outside
    ``no_grad`` records nothing (serving's peak memory is unchanged)."""
    _, _, _, tm, batch, _, tctx = pair
    logits, _ = tm.forward(_tbatch(batch), tctx)
    assert logits.grad_fn is None and not logits.requires_grad


# ---------------------------------------------------------------------------
# the MoE dispatch's gradient through its capacity drops
# ---------------------------------------------------------------------------

D, F, E = 32, 48, 8
# a skewed router (large logits) overfills the favourite experts at
# capacity factor 1.0; a zero router ties every gate (top_k takes the
# lowest ids); an ample capacity drops nothing
ROUTERS = {"skewed": (1.0, 1.0), "tied": (0.0, 1.25), "ample": (None, 4.0)}


@pytest.mark.parametrize("router", sorted(ROUTERS))
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_gradients_through_the_drops(router, top_k):
    """d/d(x, params) of ``sum(y * r) + aux`` for a fixed random ``r``,
    against ``jax.grad`` of the reference's ``moe_ffn``, where the
    dispatch drops entries (a dropped entry passes no gradient to its
    expert) and where it drops none."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    scale, factor = ROUTERS[router]
    rng = np.random.default_rng(3)

    def w(*shape, s):
        return (s * rng.normal(size=shape)).astype(np.float32)

    p = {"router": w(D, E, s=D ** -0.5 if scale is None else scale),
         "we1": w(E, D, F, s=D ** -0.5), "we3": w(E, D, F, s=D ** -0.5),
         "we2": w(E, F, D, s=F ** -0.5)}
    x, r = w(2, 40, D, s=1.0), w(2, 40, D, s=1.0)
    kw = dict(n_experts=E, top_k=top_k, capacity_factor=factor)

    def jloss(p, x):
        y, aux = jmoe.moe_ffn(p, x, **kw)
        return jnp.sum(y * r) + aux

    jg = jax.grad(jloss, argnums=(0, 1))(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x))
    tp = {n: torch.tensor(a, requires_grad=True) for n, a in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, aux = tmoe.moe_ffn(tp, tx, **kw)
    tg = torch.autograd.grad((y * torch.from_numpy(r)).sum() + aux,
                             [*tp.values(), tx])
    want = {**{n: np.asarray(jg[0][n]) for n in p}, "x": np.asarray(jg[1])}
    got = {**{n: g.numpy() for n, g in zip(tp, tg)}, "x": tg[-1].numpy()}
    assert_tree_close(got, want)
    _, _, ids, _ = tmoe._route(tx.detach(), tp["router"].detach(), top_k)
    t = 40 * top_k
    src = tmoe._dispatch_indices(ids.reshape(2, t), E,
                                 tmoe.capacity(t, E, factor, 4))
    kept = int((src < t).sum())
    assert (kept < 2 * t) == (router != "ample")
