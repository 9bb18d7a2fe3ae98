"""The port's recurrent blocks (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm`` on the CPU, in f32, with the same inputs
made by numpy from a seed and the JAX blocks' parameters carried across:
``chunked_lin_attn`` at chunks 4, 16 and 32 (and against the port's own
sequential ``lin_attn_step``), the decay-zero case, each block's forward
and decode, and each block's decode against its own forward.

Tolerances, f32: rtol 1e-4 / atol 1e-5 against the JAX package; 2e-4
where the reference's own chunked-against-sequential check uses it; 2e-3
for decode against forward (the reference's ``test_ssm.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm

TOL = dict(rtol=1e-4, atol=1e-5)
SEQ_TOL = dict(rtol=2e-4, atol=2e-4)
DEC_TOL = dict(rtol=2e-3, atol=2e-3)


def _lin_inputs(seed, b=2, s=32, h=3, dk=8, dv=5):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, dk)).astype(np.float32)
    k = rng.normal(size=(b, s, h, dk)).astype(np.float32)
    v = rng.normal(size=(b, s, h, dv)).astype(np.float32)
    logf = (-np.abs(rng.normal(size=(b, s, h)))).astype(np.float32)
    return q, k, v, logf


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _sequential(q, k, v, logf):
    b, s, h, dk = q.shape
    state = torch.zeros((b, h, dk, v.shape[-1]))
    ys = []
    for t in range(s):
        _, y = ssm.lin_attn_step(state, q[:, t], k[:, t], v[:, t],
                                 torch.exp(logf[:, t]))
        ys.append(y)
    return torch.stack(ys, 1)


@pytest.mark.parametrize("chunk", [4, 16, 32])
def test_chunked_lin_attn_matches_reference(chunk):
    q, k, v, logf = _lin_inputs(chunk)
    want = jssm.chunked_lin_attn(*map(jnp.asarray, (q, k, v, logf)),
                                 chunk=chunk)
    got = ssm.chunked_lin_attn(*_t(q, k, v, logf), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(),
                               _sequential(*_t(q, k, v, logf)).numpy(),
                               **SEQ_TOL)


def test_chunked_lin_attn_chunk_capped_and_divides():
    q, k, v, logf = _t(*_lin_inputs(7, s=12))
    full = ssm.chunked_lin_attn(q, k, v, logf, chunk=256)   # chunk = S
    np.testing.assert_allclose(full.numpy(),
                               ssm.chunked_lin_attn(q, k, v, logf,
                                                    chunk=4).numpy(),
                               **SEQ_TOL)
    with pytest.raises(AssertionError):
        ssm.chunked_lin_attn(q, k, v, logf, chunk=5)


def test_lin_attn_step_matches_reference_in_place():
    rng = np.random.default_rng(3)
    st = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    q, k = (rng.normal(size=(2, 3, 4)).astype(np.float32) for _ in "qk")
    v = rng.normal(size=(2, 3, 5)).astype(np.float32)
    f = rng.uniform(0.1, 0.9, (2, 3)).astype(np.float32)
    ws, wy = jssm.lin_attn_step(*map(jnp.asarray, (st, q, k, v, f)))
    state = torch.from_numpy(st.copy())
    gs, gy = ssm.lin_attn_step(state, *_t(q, k, v, f))
    assert gs is state
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **TOL)


def test_decay_zero_means_no_history():
    """logf = -60 everywhere (f = 0 up to e^-60): y_t = (q_t . k_t) v_t,
    against the reference's chunked form and the closed form."""
    q, k, v, _ = _lin_inputs(0, b=1, s=16, h=1, dk=4, dv=4)
    logf = np.full((1, 16, 1), -60.0, np.float32)
    got = ssm.chunked_lin_attn(*_t(q, k, v, logf), chunk=8)
    want = jssm.chunked_lin_attn(*map(jnp.asarray, (q, k, v, logf)),
                                 chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    expect = np.einsum("bshd,bshd->bsh", q, k)[..., None] * v
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The blocks, with the JAX blocks' parameters carried across
# ---------------------------------------------------------------------------

D, NH, D_STATE, S, EPS = 32, 2, 8, 16, 1e-5


def _load(block, p):
    """``block``'s parameters from the JAX dict ``p`` (same names)."""
    block.load_state_dict({n: torch.from_numpy(np.array(a, np.float32))
                           for n, a in p.items()})
    return block


def _perturb(p, seed):
    """The reference's zero norms and unit/zero Mamba2 constants moved off
    their initial values, so every parameter takes part."""
    rng = np.random.default_rng(seed)
    out = dict(p)
    for n in ("ln", "A_log", "dt_bias"):
        if n in p:
            out[n] = jnp.asarray(0.3 * rng.normal(size=p[n].shape),
                                 jnp.float32)
    if "D" in p:
        out["D"] = jnp.asarray(rng.uniform(0.5, 1.5, p["D"].shape),
                               jnp.float32)
    return out


def _x(seed, s=S):
    return (0.3 * np.random.default_rng(seed).normal(size=(2, s, D))
            ).astype(np.float32)


def _blocks():
    key = jax.random.PRNGKey(0)
    return {
        "mlstm": (_perturb(jssm.init_mlstm(key, D, NH, jnp.float32), 1),
                  lambda: ssm.MLSTMBlock(D, NH, EPS, torch.float32, "cpu"),
                  lambda p, x, c: jssm.mlstm_block(p, x, c, n_heads=NH,
                                                   eps=EPS),
                  lambda p, cl, x, c: jssm.mlstm_decode(p, cl, x, c,
                                                        n_heads=NH, eps=EPS),
                  lambda: jssm.init_mlstm_cache(1, 2, D, NH, jnp.float32)),
        "slstm": (_perturb(jssm.init_slstm(key, D, NH, jnp.float32), 2),
                  lambda: ssm.SLSTMBlock(D, NH, EPS, torch.float32, "cpu"),
                  lambda p, x, c: jssm.slstm_block(p, x, c, n_heads=NH,
                                                   eps=EPS),
                  lambda p, cl, x, c: jssm.slstm_decode(p, cl, x, c,
                                                        n_heads=NH, eps=EPS),
                  lambda: jssm.init_slstm_cache(1, 2, D)),
        "mamba2": (_perturb(jssm.init_mamba2(key, D, D_STATE, jnp.float32),
                            3),
                   lambda: ssm.Mamba2Block(D, D_STATE, EPS, torch.float32,
                                           "cpu"),
                   lambda p, x, c: jssm.mamba2_block(p, x, c,
                                                     d_state=D_STATE,
                                                     eps=EPS),
                   lambda p, cl, x, c: jssm.mamba2_decode(
                       p, cl, x, c, d_state=D_STATE, eps=EPS),
                   lambda: jssm.init_mamba2_cache(1, 2, D, D_STATE)),
    }


BLOCKS = _blocks()


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_forward_matches_reference(name):
    p, make, jfwd, _, _ = BLOCKS[name]
    x = _x(10)
    ctx = {"ssm_chunk": 4}
    want = jfwd(p, jnp.asarray(x), ctx)
    got = _load(make(), p)(torch.from_numpy(x), ctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_decode_matches_reference(name):
    """Token by token from a zero cache: the outputs and the cache (updated
    in place) after every step."""
    p, make, _, jdec, jcache = BLOCKS[name]
    x = _x(11)
    blk = _load(make(), p)
    jc = jax.tree.map(lambda a: a[0], jcache())
    tc = blk.init_cache(1, 2, "cpu")
    assert jax.tree.map(lambda a: a.shape, jc) == {
        n: tuple(t.shape[1:]) for n, t in tc.items()}
    tc = {n: t[0] for n, t in tc.items()}
    views = dict(tc)
    for t in range(S):
        wy, jc = jdec(p, jc, jnp.asarray(x[:, t:t + 1]), {})
        gy, tc = blk.decode(tc, torch.from_numpy(x[:, t:t + 1]), {})
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **TOL)
        for n in tc:
            assert tc[n] is views[n]
            np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                       **TOL)


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_decode_matches_own_forward(name):
    """The reference's decode-against-forward check on the port (its
    tolerance, 2e-3; the sLSTM's forward is its decode's loop)."""
    p, make, _, _, _ = BLOCKS[name]
    blk = _load(make(), p)
    x = torch.from_numpy(_x(12))
    fwd = blk(x, {"ssm_chunk": 4})
    cache = {n: t[0] for n, t in blk.init_cache(1, 2, "cpu").items()}
    dec = torch.cat([blk.decode(cache, x[:, t:t + 1], {})[0]
                     for t in range(S)], 1)
    np.testing.assert_allclose(dec.numpy(), fwd.numpy(), **DEC_TOL)


def test_causal_conv_matches_reference_in_bf16():
    """The conv in the activations' type (bf16 here), the taps summed in
    the reference's order: equal to the reference bit for bit."""
    rng = np.random.default_rng(13)
    u = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(12, ssm.CONV_W)).astype(np.float32)
    want = jssm._causal_conv(jnp.asarray(u, jnp.bfloat16), jnp.asarray(w))
    got = ssm.causal_conv(torch.from_numpy(u).bfloat16(),
                          torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_conv_history_shifts_in_place():
    conv = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    before = conv.clone()
    u = torch.full((2, 4), -1.0)
    hist = ssm.conv_history(conv, u)
    assert hist.shape == (2, 4, 4)
    torch.testing.assert_close(hist[:, :3], before)
    torch.testing.assert_close(hist[:, 3], u)
    torch.testing.assert_close(conv, hist[:, 1:])


def test_mamba2_constants_are_not_zero_initialised():
    blk = ssm.Mamba2Block(D, D_STATE, EPS, torch.float32, "cpu")
    assert torch.equal(blk.D, torch.ones(D * 2 // ssm.MAMBA_HEAD))
    assert not blk.A_log.any() and not blk.dt_bias.any()
    assert blk.conv.dtype == blk.A_log.dtype == torch.float32
