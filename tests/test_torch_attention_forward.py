"""The port's chunked training/prefill attention, sliding-window decode and
cross entropy against the JAX package's, on the CPU with the same numpy
inputs.  Tolerances: rtol 1e-4 (atol 1e-5 for values that cross zero) in
f32; the bf16 case states its own."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

TOL = dict(rtol=1e-4, atol=1e-5)
DIMS = (8, 2, 16)          # heads, kv heads, head dim
D = 32
THETA = 10000.0


def _np(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)
            ).astype(np.float32)


def _params(seed):
    h, kv, dh = DIMS
    shapes = {"wq": (D, h * dh), "wk": (D, kv * dh), "wv": (D, kv * dh),
              "wo": (h * dh, D)}
    return {k: _np(*s, seed=seed + i, scale=s[0] ** -0.5)
            for i, (k, s) in enumerate(shapes.items())}


def _ctx(positions, q_chunk):
    pos = np.asarray(positions, np.int32)
    return ({"rope": jlayers.rope_tables(jnp.asarray(pos), DIMS[2], THETA),
             "q_chunk": q_chunk},
            {"rope": tlayers.rope_tables(torch.from_numpy(pos), DIMS[2],
                                         THETA),
             "q_chunk": q_chunk})


def _both(p, x, s, q_chunk, jdtype=jnp.float32, tdtype=torch.float32,
          kv=None, **kw):
    jctx, tctx = _ctx(np.arange(s), q_chunk)
    jkw, tkw = dict(kw), dict(kw)
    if kv is not None:
        jkw["kv_override"] = tuple(jnp.asarray(a, jdtype) for a in kv)
        tkw["kv_override"] = tuple(torch.from_numpy(a).to(tdtype)
                                   for a in kv)
    want = jattn.attention({n: jnp.asarray(a, jdtype) for n, a in p.items()},
                           jnp.asarray(x, jdtype), jattn.AttnDims(*DIMS),
                           jctx, **jkw)
    got = tattn.attention({n: torch.from_numpy(a).to(tdtype)
                           for n, a in p.items()},
                          torch.from_numpy(x).to(tdtype),
                          tattn.AttnDims(*DIMS), tctx, **tkw)
    return got, want


CASES = {
    "causal": dict(s=24, q_chunk=8),
    "causal_one_chunk": dict(s=24, q_chunk=2048),
    "windowed": dict(s=24, q_chunk=8, window=5),
    # 21 tokens in chunks of at most 8: the chunk becomes 7
    "ragged_chunk": dict(s=21, q_chunk=8),
    "ragged_windowed": dict(s=21, q_chunk=8, window=4),
    "no_rope": dict(s=24, q_chunk=8, use_rope=False),
    "not_causal": dict(s=24, q_chunk=8, causal=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_attention_matches(case):
    kw = dict(CASES[case])
    s, q_chunk = kw.pop("s"), kw.pop("q_chunk")
    got, want = _both(_params(1), _np(2, s, D, seed=2), s, q_chunk, **kw)
    assert got.shape == (2, s, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_kv_override_matches(causal):
    """Cross attention: 10 encoder keys and values for 16 queries (the
    mask compares query and key positions as the reference does)."""
    h, kv, dh = DIMS
    enc = (_np(2, 10, kv, dh, seed=3), _np(2, 10, kv, dh, seed=4))
    got, want = _both(_params(5), _np(2, 16, D, seed=6), 16, 8, kv=enc,
                      causal=causal, use_rope=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_chunked_attention_bf16_rounds_the_probabilities():
    """In bf16 the reference casts the f32 softmax to bf16 before the value
    product; the port does the same, so the two agree to one bf16 ulp of
    the output (rtol 2u, u = 2^-8), where f32 probabilities would move
    the output by up to u * max|v|."""
    got, want = _both(_params(7), _np(2, 24, D, seed=8), 24, 8,
                      jdtype=jnp.bfloat16, tdtype=torch.bfloat16, window=5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 * 2.0 ** -8, atol=1e-5)


def test_largest_divisor_chunk():
    assert tattn._largest_divisor(21, 8) == 7
    assert tattn._largest_divisor(32768 + 256, 2048) == 1376   # 24 chunks
    assert tattn._largest_divisor(24, 2048) == 24


# ---------------------------------------------------------------------------
# sliding-window decode through a ring wrap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,ring", [(8, 8), (64, 20)])
def test_attention_decode_window_matches_through_a_wrap(window, ring):
    """20 steps: an 8-slot ring wraps twice; a 64-token window over a
    20-slot ring (``min(window, seq_len)``) never wraps.  Logits, ring
    contents and slot positions equal the reference's at every step."""
    h, kv, dh = DIMS
    p = _params(10)
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    jc = jattn.init_window_cache(1, 2, ring, jattn.AttnDims(*DIMS),
                                 jnp.float32)
    jc = {n: a[0] for n, a in jc.items()}
    tc = tattn.init_window_cache(1, 2, ring, tattn.AttnDims(*DIMS),
                                 torch.float32, "cpu")
    tc = {n: a[0] for n, a in tc.items()}
    xs = _np(20, 2, 1, D, seed=11)
    for pos in range(20):
        jctx, tctx = _ctx([pos], 1)
        jctx["pos"] = jnp.asarray(pos, jnp.int32)
        tctx["pos"] = pos
        jout, jc = jattn.attention_decode_window(
            jp, jc, jnp.asarray(xs[pos]), jattn.AttnDims(*DIMS), jctx,
            window)
        tout, tc = tattn.attention_decode_window(
            tp, tc, torch.from_numpy(xs[pos]), tattn.AttnDims(*DIMS), tctx,
            window)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        assert tc["slot_pos"].tolist() == np.asarray(jc["slot_pos"]).tolist()
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)
    if ring == 8:
        assert tc["slot_pos"].tolist() == [16, 17, 18, 19, 12, 13, 14, 15]


def test_init_window_cache_stacks_like_the_reference():
    j = jattn.init_window_cache(3, 2, 5, jattn.AttnDims(*DIMS), jnp.float32)
    t = tattn.init_window_cache((3,), 2, 5, tattn.AttnDims(*DIMS),
                                torch.float32, "cpu")
    assert {n: tuple(a.shape) for n, a in t.items()} == \
        {n: tuple(a.shape) for n, a in j.items()}
    assert torch.all(t["slot_pos"] == -1)
    two = tattn.init_window_cache((3, 4), 2, 5, tattn.AttnDims(*DIMS),
                                  torch.float32, "cpu")
    assert two["k"].shape == (3, 4, 2, 2, 5, 16)
    assert two["slot_pos"].shape == (3, 4, 5)


# ---------------------------------------------------------------------------
# cross entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches(masked):
    logits = _np(2, 7, 50, seed=12, scale=3.0)
    labels = np.random.default_rng(13).integers(0, 50, (2, 7))
    mask = (np.random.default_rng(14).random((2, 7)) > 0.4).astype(
        np.float32) if masked else None
    want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if mask is None else jnp.asarray(mask))
    got = tlayers.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels),
                                None if mask is None else
                                torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
