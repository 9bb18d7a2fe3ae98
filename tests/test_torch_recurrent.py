"""The recurrent families on the port against the JAX package, at the
reduced configs (CPU, f32) with the JAX package's weights carried across by
``convert.lm_params_from_jax``: xlstm-1.3b (1 superblock of 3 mLSTM + 1
sLSTM) and zamba2-2.7b (2 superblocks of 2 Mamba2 + the shared attention,
head dim 16).  The state-dict names, the cache layouts, the chunked
forward (over several chunks of the recurrence) and loss, 16 decode steps
with the full cache, zamba2's clustered decode with live centroids, and
the serving engine's greedy tokens (zamba2's clustered run folds its
window once).  The clustered runs use ``cluster_window = dh``, where the
reference's ring is right (ROADMAP §3).

Tolerances: rtol 1e-4 (atol 1e-5) unless stated; decode logits rtol
1e-4 with atol 1e-4 (``DEC_TOL``): the recurrent states carry each step's
f32 rounding into the next (a few ulps a layer, growing about 2x a layer
at this depth: 1e-5 at logits of magnitude 4 after 5 layers), so logits
near zero miss a relative 1e-4."""
import functools

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
from repro_torch.models import XLSTMSuper, ZambaSuper, build_model
from repro_torch.serve import ServeConfig, ServeEngine

TOL = dict(rtol=1e-4, atol=1e-5)
DEC_TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["xlstm-1.3b", "zamba2-2.7b"]
S = 32
CHUNK = 8              # the recurrence's chunk in the forward: 4 chunks


@functools.lru_cache(maxsize=None)
def _models(arch, seed):
    """(cfg, the JAX model, its parameters, the port's model holding them)
    for the reduced ``arch``, drawn from ``PRNGKey(seed)``."""
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(lm_params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    return cfg, jm, jp, tm


@pytest.fixture(params=ARCHS)
def pair(request):
    return _models(request.param, 0)


@pytest.fixture
def zamba():
    return _models("zamba2-2.7b", 1)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(a.shape), tree)


def test_names_and_superblocks(pair):
    cfg, _, _, tm = pair
    names = set(tm.state_dict())
    assert tm.group == "super"
    if cfg.family == "ssm":
        assert [type(s) for s in tm.layers()] == [XLSTMSuper]
        assert len(tm.layers()[0].mlstm) == 3 and tm.attn_blocks() == []
        assert {"super.0.mlstm.2.wq", "super.0.mlstm.0.wi",
                "super.0.slstm.rz", "super.0.slstm.down"} <= names
        assert tm.layers()[0].mlstm[0].wi.dtype == torch.float32
    else:
        assert [type(s) for s in tm.layers()] == [ZambaSuper] * 2
        assert tm.attn_blocks() == [tm.shared]
        assert all(s.shared is tm.shared for s in tm.layers())
        assert {"shared.attn.wq", "shared.w2", "super.0.mamba.1.in_proj",
                "super.1.mamba.0.conv", "super.1.mamba.1.D"} <= names
        # the shared block is one set of parameters, not one per superblock
        assert not any(n.startswith("super.") and ".shared." in n
                       for n in names)


@pytest.mark.parametrize("kind", ["full", "clustered"])
def test_cache_layouts_equal_reference(pair, kind):
    cfg, jm, _, tm = pair
    extra = dict(cluster_compression=4, cluster_window=cfg.dh) \
        if kind == "clustered" else {}
    jc = jm.init_caches(2, JShape("s", 64, 2, "decode", **extra), kind)
    tc = tm.init_caches(2, ShapeConfig("s", 64, 2, "decode", **extra), kind)
    assert _shapes(jc) == _shapes(tc)
    assert jax.tree.map(lambda a: str(a.dtype), jc) == jax.tree.map(
        lambda t: str(t.dtype).replace("torch.", ""), tc)


def test_forward_and_loss_match(pair):
    cfg, jm, jp, tm = pair
    toks = _tokens(cfg, 2, S, 1)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    jctx = dict(jm.make_ctx(jnp.arange(S), q_chunk=16), ssm_chunk=CHUNK)
    want, aux = jm.forward(jp, batch, jctx, remat=False)
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    tctx = dict(tm.make_ctx(torch.arange(S), q_chunk=16), ssm_chunk=CHUNK)
    got, taux = tm.forward(tb, tctx)
    assert got.shape == (2, S, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(taux) == float(aux) == 0.0
    np.testing.assert_allclose(float(tm.loss(tb, tctx)),
                               float(jm.loss(jp, batch, jctx, remat=False)),
                               rtol=1e-5)
    # the default chunk (256 > S: one chunk) computes the same logits
    dflt, _ = tm.forward(tb)
    np.testing.assert_allclose(dflt.numpy(), got.numpy(), rtol=2e-4,
                               atol=2e-4)


def _decode_both(cfg, jm, jp, tm, kind, steps, extra, seed, live=False):
    """``steps`` decode steps of both models from zeroed caches (with
    ``live``, random live centroids in zamba2's clustered cache), the
    logits held together at every step; -> both final caches."""
    b = 2
    jc = jm.init_caches(b, JShape("s", 64, b, "decode", **extra), kind)
    tc = tm.init_caches(b, ShapeConfig("s", 64, b, "decode", **extra), kind)
    if live:
        attn = jc["super"]["attn"]
        rng = np.random.default_rng(seed)
        arrs = {"kc": rng.normal(size=attn["kc"].shape),
                "vc": rng.normal(size=attn["vc"].shape),
                "counts": rng.integers(0, 5, attn["counts"].shape)}
        arrs = {n: a.astype(np.float32) for n, a in arrs.items()}
        jc["super"]["attn"] = dict(attn, **{n: jnp.asarray(a)
                                            for n, a in arrs.items()})
        tc["super"]["attn"].update({n: torch.from_numpy(a)
                                    for n, a in arrs.items()})
    toks = _tokens(cfg, b, steps, seed)
    jdecode = jax.jit(lambda p, c, t, pos: jm.decode_step(
        p, c, t, pos, ctx_extra={"cache_kind": kind}))
    for i in range(steps):
        lj, jc = jdecode(jp, jc, jnp.asarray(toks[:, i:i + 1], jnp.int32),
                         jnp.asarray(i, jnp.int32))
        lt, tc = tm.decode_step(torch.from_numpy(toks[:, i:i + 1]), tc, i,
                                cache_kind=kind)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **DEC_TOL)
    return jc, tc


def test_decode_steps_full_cache_match(pair):
    """16 steps with the full cache; the recurrent states (updated in
    place) equal the reference's after the last."""
    cfg, jm, jp, tm = pair
    jc, tc = _decode_both(cfg, jm, jp, tm, "full", 16, {}, 3)
    for jleaf, tleaf in zip(jax.tree.leaves(jc), jax.tree.leaves(tc)):
        np.testing.assert_allclose(tleaf.numpy(), np.asarray(jleaf),
                                   rtol=1e-4, atol=1e-4)


def test_zamba_clustered_decode_matches(zamba):
    """The shared attention on the clustered cache with live (and dead)
    centroids beside a ring as long as the head dim; 20 steps wrap the
    16-slot ring."""
    cfg, jm, jp, tm = zamba
    _decode_both(cfg, jm, jp, tm, "clustered", 20,
                 dict(cluster_compression=4, cluster_window=cfg.dh), 4,
                 live=True)


def test_decode_matches_own_forward(pair):
    """Decode logits at every position equal the port's own forward (the
    reference's ``test_decode_matches_forward`` tolerance, 2e-2)."""
    cfg, _, _, tm = pair
    toks = torch.from_numpy(_tokens(cfg, 1, S, 5))
    fwd, _ = tm.forward({"tokens": toks},
                        dict(tm.make_ctx(torch.arange(S)), ssm_chunk=CHUNK))
    caches = tm.init_caches(1, ShapeConfig("d", S, 1, "decode"), "full")
    dec = torch.cat([tm.decode_step(toks[:, t:t + 1], caches, t)[0]
                     for t in range(S)], 1)
    np.testing.assert_allclose(dec.numpy(), fwd.numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("arch,kind", [("xlstm-1.3b", "full"),
                                       ("zamba2-2.7b", "full"),
                                       ("zamba2-2.7b", "clustered")])
def test_greedy_tokens_equal_reference_engine(arch, kind):
    """Greedy generation after a 12-token prompt: the same tokens as the
    JAX engine.  zamba2's clustered run folds the shared attention's
    window into 4 centroids a (superblock, batch, kv head) at position 8
    (one refresh, which leaves the Mamba2 states alone)."""
    cfg, jm, jp, tm = _models(arch, 0)
    extra = dict(cluster_compression=4, cluster_window=cfg.dh) \
        if kind == "clustered" else {}
    every = 8 if kind == "clustered" else 0
    prompt = _tokens(cfg, 2, 12, 6)
    want = JServeEngine(jm.cfg, JShape("s", 16, 2, "decode", **extra), jp,
                        JServeConfig(max_tokens=4, recompress_every=every)
                        ).generate(jnp.asarray(prompt, jnp.int32))
    eng = ServeEngine(cfg, ShapeConfig("s", 16, 2, "decode", **extra), tm,
                      ServeConfig(max_tokens=4, recompress_every=every))
    assert eng.kind == kind
    got = eng.generate(torch.from_numpy(prompt))
    np.testing.assert_array_equal(got, np.asarray(want))
    if kind == "clustered":
        caches, _, _ = eng.prefill(torch.from_numpy(prompt))
        attn, mamba = caches["super"]["attn"], caches["super"]["mamba"]
        # one refresh at 8 folded 8 tokens into every lane; the 4 after it
        # wait in the ring
        np.testing.assert_allclose(attn["counts"].sum(-1).numpy(), 8.0)
        assert sorted(attn["slot_pos"][0].tolist()) == [-1] * 12 + list(
            range(8, 12))
        assert mamba["state"].abs().sum() > 0


def test_refresh_tree_folds_only_the_shared_attention(zamba):
    """``ServeEngine._refresh_tree`` finds zamba2's clustered caches under
    ``super.attn`` and passes the Mamba2 states through untouched."""
    cfg, _, _, tm = zamba
    shape = ShapeConfig("s", 16, 1, "decode", cluster_compression=4,
                        cluster_window=cfg.dh)
    eng = ServeEngine(cfg, shape, tm, ServeConfig(recompress_every=8))
    caches = tm.init_caches(1, shape, "clustered")
    for i in range(8):
        tm.decode_step(torch.tensor([[i + 1]]), caches, i,
                       cache_kind="clustered")
    out = eng._refresh_tree(caches, 7)
    for n in ("state", "conv"):
        assert out["super"]["mamba"][n] is caches["super"]["mamba"][n]
    assert out["super"]["attn"]["kc"] is not caches["super"]["attn"]["kc"]
    np.testing.assert_allclose(out["super"]["attn"]["counts"].sum(-1)
                               .numpy(), 8.0)
    assert torch.all(out["super"]["attn"]["slot_pos"] == -1)


def test_lm_params_from_jax_checks_the_recurrent_stacks(pair):
    cfg, _, jp, _ = pair
    tree = jax.tree.map(np.asarray, jp)
    stack = "mlstm" if cfg.family == "ssm" else "mamba"
    tree["g_super"][stack] = jax.tree.map(lambda a: a[:, :1],
                                          tree["g_super"][stack])
    with pytest.raises(ValueError, match=f"g_super {stack}"):
        lm_params_from_jax(cfg, tree)
