"""The port's model layers, decode attention and DecoderLM against the JAX
package's, on the CPU in f32, with the same weights and caches carried
across as numpy arrays (``convert.lm_params_from_jax`` for whole models).
Tolerances: rtol 1e-4 (atol 1e-5 for values that cross zero); the
offline cache compression is held to the reference tests' properties.
The bf16 cases state their own tolerances."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeConfig as JShape
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.registry import build_model as jbuild_model
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import build_model, layers as tlayers

TOL = dict(rtol=1e-4, atol=1e-5)


def _np(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)
            ).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_and_swiglu_match():
    x, s = _np(3, 5, 64, seed=1), _np(64, seed=2, scale=0.1)
    _close(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(s)),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(s)))
    w1, w3, w2 = _np(64, 128, seed=3), _np(64, 128, seed=4), _np(128, 64,
                                                                 seed=5)
    _close(tlayers.swiglu(*map(torch.from_numpy, (x, w1, w3, w2))),
           jlayers.swiglu(*map(jnp.asarray, (x, w1, w3, w2))))


def test_rope_matches():
    pos = np.array([0, 3, 17, 511], np.int32)
    cos_t, sin_t = tlayers.rope_tables(torch.from_numpy(pos), 16, 500000.0)
    cos_j, sin_j = jlayers.rope_tables(jnp.asarray(pos), 16, 500000.0)
    _close(cos_t, cos_j)
    _close(sin_t, sin_j)
    x = _np(2, 4, 3, 16, seed=6)
    _close(tlayers.apply_rope(torch.from_numpy(x), cos_t, sin_t),
           jlayers.apply_rope(jnp.asarray(x), cos_j, sin_j))


def test_param_draws_follow_the_reference_scales():
    cfg = get_config("llama3-8b").reduced()
    model = build_model(cfg, device="cpu").init_params(0)
    blk = model.blocks[0]
    assert torch.all(blk.ln1 == 0) and torch.all(model.final_ln == 0)
    assert abs(float(model.embed.std()) - 0.02) < 0.002
    assert abs(float(blk.w2.std()) - cfg.d_ff ** -0.5) < 0.01
    again = build_model(cfg, device="cpu").init_params(0)
    assert all(torch.equal(a, b) for a, b in
               zip(model.state_dict().values(), again.state_dict().values()))
    # the router (f32) and the experts at d^-0.5, we2 at d_ff^-0.5 (as the
    # reference's init_moe), the shared expert like a dense FFN, and the
    # VLM's patch projection at d^-0.5
    import dataclasses
    llama4 = dataclasses.replace(
        get_config("llama4-maverick-400b-a17b").reduced(), d_ff=256)
    moe = build_model(llama4, device="cpu").init_params(0).blocks[0].moe
    d, f = llama4.d_model, llama4.d_ff
    assert moe["router"].dtype == torch.float32
    for name, scale in (("router", d), ("we1", d), ("we3", d), ("we2", f),
                        ("w1", d), ("w2", f)):
        assert abs(float(moe[name].std()) - scale ** -0.5) < 0.1 * \
            scale ** -0.5, name
    vlm = get_config("internvl2-2b").reduced()
    proj = build_model(vlm, device="cpu").init_params(0).patch_proj
    assert abs(float(proj.std()) - vlm.d_model ** -0.5) < 0.1 * \
        vlm.d_model ** -0.5


# ---------------------------------------------------------------------------
# decode attention, one layer
# ---------------------------------------------------------------------------

DIMS = (8, 2, 16)          # heads, kv heads, head dim
D = 32


def _attn_params(seed):
    h, kv, dh = DIMS
    shapes = {"wq": (D, h * dh), "wk": (D, kv * dh), "wv": (D, kv * dh),
              "wo": (h * dh, D)}
    return {k: _np(*s, seed=seed + i, scale=s[0] ** -0.5)
            for i, (k, s) in enumerate(shapes.items())}


def _ctx_pair(pos, dh):
    cos_j, sin_j = jlayers.rope_tables(jnp.asarray([pos], jnp.int32), dh,
                                       500000.0)
    jctx = {"pos": jnp.asarray(pos, jnp.int32), "rope": (cos_j, sin_j)}
    tctx = {"pos": pos, "rope": tlayers.rope_tables(torch.tensor([pos]), dh,
                                                    500000.0)}
    return jctx, tctx


@pytest.mark.parametrize("pos", [0, 5, 11])
def test_attention_decode_full_matches(pos):
    h, kv, dh = DIMS
    p = _attn_params(10)
    x = _np(2, 1, D, seed=20)
    k, v = _np(2, kv, 12, dh, seed=21), _np(2, kv, 12, dh, seed=22)
    jctx, tctx = _ctx_pair(pos, dh)
    jout, jc = jattn.attention_decode(
        {n: jnp.asarray(a) for n, a in p.items()},
        {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(x),
        jattn.AttnDims(*DIMS), jctx)
    tc = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    tout, tc = tattn.attention_decode(
        {n: torch.from_numpy(a) for n, a in p.items()}, tc,
        torch.from_numpy(x), tattn.AttnDims(*DIMS), tctx)
    _close(tout, jout)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


@pytest.mark.parametrize("pos,live", [(3, 0.0), (21, 0.6), (40, 1.0)])
def test_attention_decode_clustered_matches(pos, live):
    """Centroids with some dead slots (``live`` of them alive) beside a
    16-slot ring: the kernel's state merged with the window by
    log-sum-exp equals the reference's merged softmax."""
    h, kv, dh = DIMS
    nc, w = 24, 16
    p = _attn_params(30)
    x = _np(2, 1, D, seed=40)
    rng = np.random.default_rng(41)
    cache = {
        "kc": _np(2, kv, nc, dh, seed=42), "vc": _np(2, kv, nc, dh, seed=43),
        "counts": (rng.integers(1, 9, (2, kv, nc))
                   * (rng.random((2, kv, nc)) < live)).astype(np.float32),
        "wk": _np(2, kv, w, dh, seed=44), "wv": _np(2, kv, w, dh, seed=45),
        "slot_pos": np.where(np.arange(w) < pos % w, np.arange(w) + pos
                             - pos % w, np.arange(w) + pos - pos % w - w
                             ).astype(np.int32)}
    jctx, tctx = _ctx_pair(pos, dh)
    jout, jc = jattn.attention_decode_clustered(
        {n: jnp.asarray(a) for n, a in p.items()},
        {n: jnp.asarray(a) for n, a in cache.items()}, jnp.asarray(x),
        jattn.AttnDims(*DIMS), jctx)
    tc = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    tout, tc = tattn.attention_decode_clustered(
        {n: torch.from_numpy(a) for n, a in p.items()}, tc,
        torch.from_numpy(x), tattn.AttnDims(*DIMS), tctx)
    _close(tout, jout)
    for name in ("wk", "wv"):
        _close(tc[name], jc[name])
    assert tc["slot_pos"].tolist() == np.asarray(jc["slot_pos"]).tolist()


def test_window_valid_mask_matches():
    slot_pos = np.array([-1, 0, 5, 9, 12, 20], np.int32)
    for pos in (5, 12, 20):
        want = jattn.window_valid_mask(jnp.asarray(slot_pos), pos, 8)
        got = tattn.window_valid_mask(torch.from_numpy(slot_pos), pos, 8)
        assert got.tolist() == np.asarray(want).tolist()


# ---------------------------------------------------------------------------
# the whole model: decode logits for both cache kinds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llama_pair():
    jcfg = jget_config("llama3-8b").reduced()
    cfg = get_config("llama3-8b").reduced()
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(lm_params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    return jcfg, cfg, jm, jp, tm


@pytest.mark.parametrize("kind", ["full", "clustered"])
def test_decode_step_logits_match(llama_pair, kind):
    """20 steps; the clustered ring has 16 slots, so it wraps.  The ring
    is as long as the head dim here: the reference reads its ring length
    from the head-dim axis (ROADMAP §3), and the two agree only there."""
    jcfg, cfg, jm, jp, tm = llama_pair
    b, steps = 2, 20
    assert cfg.dh == 16
    shape = dict(cluster_compression=4, cluster_window=16) \
        if kind == "clustered" else {}
    jc = jm.init_caches(b, JShape("s", 48, b, "decode", **shape), kind)
    tc = tm.init_caches(b, ShapeConfig("s", 48, b, "decode", **shape), kind)
    if kind == "clustered":          # live centroids with some dead slots
        rng = np.random.default_rng(1)
        blk = jc["blocks"]
        kc = _np(*blk["kc"].shape, seed=2)
        vc = _np(*blk["vc"].shape, seed=3)
        cnt = (rng.integers(0, 5, blk["counts"].shape)).astype(np.float32)
        jc["blocks"] = dict(blk, kc=jnp.asarray(kc), vc=jnp.asarray(vc),
                            counts=jnp.asarray(cnt))
        tc["blocks"].update(kc=torch.from_numpy(kc), vc=torch.from_numpy(vc),
                            counts=torch.from_numpy(cnt))
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (b, steps))
    jdecode = jax.jit(lambda p, c, t, pos: jm.decode_step(
        p, c, t, pos, ctx_extra={"cache_kind": kind}))
    for i in range(steps):
        lj, jc = jdecode(jp, jc, jnp.asarray(toks[:, i:i + 1], jnp.int32),
                         jnp.asarray(i, jnp.int32))
        lt, tc = tm.decode_step(torch.from_numpy(toks[:, i:i + 1]), tc, i,
                                cache_kind=kind)
        assert lt.shape == (b, 1, cfg.padded_vocab)
        assert lt.dtype == torch.float32
        _close(lt, lj)
    for name, t in tc["blocks"].items():
        _close(t, jc["blocks"][name])


def test_clustered_ring_of_any_length():
    """The clustered cache's ring holds the last ``cluster_window`` tokens
    whatever the head dim: with no live centroid and a ring longer than the
    prompt, clustered decode is full-cache decode; a shorter ring keeps
    positions ``pos - W + 1 .. pos`` at slots ``pos % W``."""
    cfg = get_config("llama3-8b").reduced()
    model = build_model(cfg, device="cpu").init_params(3)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab,
                                                              (2, 20)))
    full = model.init_caches(2, ShapeConfig("f", 24, 2, "decode"), "full")
    ring = model.init_caches(2, ShapeConfig("c", 48, 2, "decode",
                                            cluster_compression=4,
                                            cluster_window=24), "clustered")
    short = model.init_caches(2, ShapeConfig("c", 48, 2, "decode",
                                             cluster_compression=4,
                                             cluster_window=8), "clustered")
    for i in range(20):
        lf, _ = model.decode_step(toks[:, i:i + 1], full, i)
        lc, _ = model.decode_step(toks[:, i:i + 1], ring, i,
                                  cache_kind="clustered")
        model.decode_step(toks[:, i:i + 1], short, i, cache_kind="clustered")
        torch.testing.assert_close(lc, lf, rtol=1e-5, atol=1e-5)
    assert short["blocks"]["slot_pos"][0].tolist() == [16, 17, 18, 19, 12,
                                                       13, 14, 15]
    # layer 0's keys depend on the tokens alone: slot 4 holds position 12
    torch.testing.assert_close(short["blocks"]["wk"][0, :, :, 4],
                               full["blocks"]["k"][0, :, :, 12])


def test_head_out_matches(llama_pair):
    jcfg, cfg, jm, jp, tm = llama_pair
    x = _np(2, 1, cfg.d_model, seed=7)
    _close(tm.head_out(torch.from_numpy(x)), jm.head_out(jp, jnp.asarray(x)))


# ---------------------------------------------------------------------------
# bf16, the type of the full-width models
# ---------------------------------------------------------------------------

BF16_U = 2.0 ** -8     # bf16's unit roundoff (8 significant bits)


def test_head_out_bf16_logits_are_f32_products():
    """At the reduced llama3-8b in bf16 the logits are the f32 product of
    the bf16 activations and head, as the reference's ``dot_general(...,
    preferred_element_type=f32)`` returns them: they differ only in the
    order of the f32 sums (rtol/atol 1e-5), never by a bf16 rounding of
    the product (about 1e-2 at these magnitudes)."""
    jcfg = dataclasses.replace(jget_config("llama3-8b").reduced(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="bfloat16")
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(lm_params_from_jax(cfg, jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), jp)))
    x = _np(2, 1, cfg.d_model, seed=7)
    want = jm.head_out(jp, jnp.asarray(x, jnp.bfloat16))
    got = tm.head_out(torch.from_numpy(x).bfloat16())
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pos", [0, 5, 21, 40])
def test_attention_decode_clustered_bf16_within_weight_rounding(pos):
    """The clustered decode in bf16 against the reference's, with the ring
    as long as the head dim (ROADMAP §3).  The reference rounds its merged
    softmax weights to bf16 before the value products; the port keeps them
    in f32.  Each output row is a convex combination of value rows, so
    weights rounded by at most ``u`` (bf16's unit roundoff) move it by at
    most ``u * max|v|``; both sides then round the output to bf16, up to
    one ulp (``2u`` relative) apart.  The projections are exact (identity
    and selection matrices), so the tolerance is that rounding alone:
    ``atol = u * max|v|``, ``rtol = 2u``."""
    h, kv, dh = DIMS
    d, nc, w = h * dh, 24, dh
    eye = np.eye(d, dtype=np.float32)
    p = {"wq": eye, "wk": eye[:, :kv * dh], "wv": eye[:, d - kv * dh:],
         "wo": eye}
    x = _np(2, 1, d, seed=40)
    rng = np.random.default_rng(41)
    cache = {
        "kc": _np(2, kv, nc, dh, seed=42), "vc": _np(2, kv, nc, dh, seed=43),
        "counts": (rng.integers(1, 9, (2, kv, nc))
                   * (rng.random((2, kv, nc)) < 0.7)).astype(np.float32),
        "wk": _np(2, kv, w, dh, seed=44), "wv": _np(2, kv, w, dh, seed=45),
        "slot_pos": np.where(np.arange(w) < pos % w, np.arange(w) + pos
                             - pos % w, np.arange(w) + pos - pos % w - w
                             ).astype(np.int32)}
    floats = ("kc", "vc", "wk", "wv")
    jctx, tctx = _ctx_pair(pos, dh)
    jout, _ = jattn.attention_decode_clustered(
        {n: jnp.asarray(a, jnp.bfloat16) for n, a in p.items()},
        {n: jnp.asarray(a, jnp.bfloat16 if n in floats else a.dtype)
         for n, a in cache.items()}, jnp.asarray(x, jnp.bfloat16),
        jattn.AttnDims(*DIMS), jctx)
    tc = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    tc.update({n: tc[n].bfloat16() for n in floats})
    tout, _ = tattn.attention_decode_clustered(
        {n: torch.from_numpy(a).bfloat16() for n, a in p.items()}, tc,
        torch.from_numpy(x).bfloat16(), tattn.AttnDims(*DIMS), tctx)
    assert tout.dtype == torch.bfloat16
    v_max = float(max(tc["vc"].float().abs().max(),
                      tc["wv"].float().abs().max(),
                      torch.from_numpy(x).bfloat16().float().abs().max()))
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               rtol=2 * BF16_U, atol=BF16_U * v_max)


# ---------------------------------------------------------------------------
# offline compression (ports of tests/test_serve.py's)
# ---------------------------------------------------------------------------

def test_compress_kv_cache_counts_conserved():
    b, kv, s, dh = 2, 2, 256, 16
    k = torch.from_numpy(_np(b, kv, s, dh, seed=8))
    v = torch.from_numpy(_np(b, kv, s, dh, seed=9))
    kc, vc, counts = tattn.compress_kv_cache(k, v, chunk=64, compression=8)
    assert kc.shape == (b, kv, s // 8, dh) and vc.shape == kc.shape
    # member counts per (b, h) must sum to S — every key lands somewhere
    np.testing.assert_allclose(counts.sum(-1).numpy(), s, rtol=1e-5)


def test_compress_kv_cache_identical_keys_exact():
    """If all keys in a chunk are identical, compression is lossless."""
    k = torch.ones((1, 1, 128, 8)) * 0.3
    v = torch.ones((1, 1, 128, 8)) * 2.0
    kc, vc, counts = tattn.compress_kv_cache(k, v, chunk=32, compression=4)
    live = counts[0, 0] > 0
    np.testing.assert_allclose(vc[0, 0][live].numpy(), 2.0, rtol=1e-5)
    np.testing.assert_allclose(kc[0, 0][live].numpy(), 0.3, rtol=1e-5)


def test_compress_kv_cache_value_means():
    """Value centroids are the means of the values whose keys joined each
    centroid, and a centroid's key is the mean of its keys."""
    k = torch.from_numpy(_np(1, 2, 64, 8, seed=10))
    v = torch.from_numpy(_np(1, 2, 64, 8, seed=11))
    kc, vc, counts = tattn.compress_kv_cache(k, v, chunk=32, compression=8,
                                             iters=6)
    assert torch.all(counts >= 0) and float(counts.sum()) == 128.0
    for h in range(2):
        for c0 in (0, 1):
            keys, vals = k[0, h, 32 * c0:32 * (c0 + 1)], v[0, h, 32 * c0:
                                                          32 * (c0 + 1)]
            cent = kc[0, h, 4 * c0:4 * (c0 + 1)]
            nearest = ((keys[:, None] - cent[None]) ** 2).sum(-1).argmin(1)
            for j in range(4):
                sel = nearest == j
                if sel.any():
                    torch.testing.assert_close(vc[0, h, 4 * c0 + j],
                                               vals[sel].mean(0), rtol=1e-4,
                                               atol=1e-5)
