"""The port's cluster attention (plain version on the CPU) against the JAX
package's Pallas kernel in interpret mode: the normalised output at the
reference tests' shapes, the unnormalised ``(acc, m, l)`` its
``pallas_call`` returns, dead and all-dead centroids, bf16 inputs, and the
wrapper's input contract.  Tolerances: 3e-4 for f32 (the reference tests'),
5e-2 for bf16."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from repro.kernels.cluster_attn import (_cluster_attn_kernel,
                                        cluster_attn_decode_pallas)
from repro_torch.kernels import cluster_attn, tiles
from repro_torch.kernels.ref import NEG, cluster_attn_decode_ref
from repro_torch.kernels.tiles import TileError, attn_splits

SHAPES = [(1, 4, 1, 64, 32, 32), (2, 8, 2, 300, 64, 128),
          (1, 16, 8, 128, 128, 512)]


def _pallas_state(q, kc, vc, counts, scale, block_n):
    """The ``(acc, m, l)`` of ``cluster_attn_decode_pallas``'s own
    ``pallas_call`` (the same grid and blocks, in interpret mode), before
    it normalises.  ``Nc`` must be a multiple of ``block_n``."""
    b, h, dh = q.shape
    hkv, nc = kc.shape[1], kc.shape[2]
    g = h // hkv
    bn = min(block_n, nc)
    assert nc % bn == 0
    return pl.pallas_call(
        functools.partial(_cluster_attn_kernel, scale=scale),
        grid=(b, hkv, nc // bn),
        in_specs=[
            pl.BlockSpec((1, 1, g, dh), lambda b_, h_, j: (b_, h_, 0, 0)),
            pl.BlockSpec((1, 1, bn, dh), lambda b_, h_, j: (b_, h_, j, 0)),
            pl.BlockSpec((1, 1, bn, dh), lambda b_, h_, j: (b_, h_, j, 0)),
            pl.BlockSpec((1, 1, bn), lambda b_, h_, j: (b_, h_, j)),
        ],
        out_specs=[
            pl.BlockSpec((1, 1, g, dh), lambda b_, h_, j: (b_, h_, 0, 0)),
            pl.BlockSpec((1, 1, g), lambda b_, h_, j: (b_, h_, 0)),
            pl.BlockSpec((1, 1, g), lambda b_, h_, j: (b_, h_, 0)),
        ],
        out_shape=[jax.ShapeDtypeStruct((b, hkv, g, dh), jnp.float32),
                   jax.ShapeDtypeStruct((b, hkv, g), jnp.float32),
                   jax.ShapeDtypeStruct((b, hkv, g), jnp.float32)],
        interpret=True,
    )(q.reshape(b, hkv, g, dh), kc, vc, counts)


def _inputs(seed, b, h, hkv, nc, dh):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, dh)).astype(np.float32)
    kc = rng.normal(size=(b, hkv, nc, dh)).astype(np.float32)
    vc = rng.normal(size=(b, hkv, nc, dh)).astype(np.float32)
    cnt = rng.integers(0, 50, (b, hkv, nc)).astype(np.float32)
    return q, kc, vc, cnt


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,h,hkv,nc,dh,bn", SHAPES)
def test_decode_matches_pallas(b, h, hkv, nc, dh, bn):
    q, kc, vc, cnt = _inputs(0, b, h, hkv, nc, dh)
    want = cluster_attn_decode_pallas(*map(jnp.asarray, (q, kc, vc, cnt)),
                                      dh ** -0.5, block_n=bn, interpret=True)
    got = cluster_attn.cluster_attn_decode(*_t(q, kc, vc, cnt), dh ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-4)


@pytest.mark.parametrize("b,h,hkv,nc,dh,bn", [SHAPES[0], SHAPES[2],
                                              (2, 8, 2, 384, 64, 128)])
def test_partial_state_matches_pallas(b, h, hkv, nc, dh, bn):
    q, kc, vc, cnt = _inputs(1, b, h, hkv, nc, dh)
    want = _pallas_state(*map(jnp.asarray, (q, kc, vc, cnt)), dh ** -0.5, bn)
    got = cluster_attn.cluster_attn_partial(*_t(q, kc, vc, cnt), dh ** -0.5)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.float32
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=3e-4,
                                   atol=3e-4)


def test_dead_centroids_ignored():
    """Poisoning the values of dead centroids changes nothing (a dead
    slot's weight is exactly 0), as in the reference's test."""
    q, kc, vc, _ = _inputs(2, 1, 2, 1, 32, 16)
    cnt = np.ones((1, 1, 32), np.float32)
    cnt[..., 16:] = 0.0
    out1 = cluster_attn.cluster_attn_decode(*_t(q, kc, vc, cnt), 0.25)
    vc2 = vc.copy()
    vc2[..., 16:, :] = 1e6
    out2 = cluster_attn.cluster_attn_decode(*_t(q, kc, vc2, cnt), 0.25)
    assert torch.equal(out1, out2)
    want = cluster_attn_decode_pallas(*map(jnp.asarray, (q, kc, vc2, cnt)),
                                      0.25, block_n=16, interpret=True)
    np.testing.assert_allclose(out2.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-4)


def test_all_dead_rows_match_pallas_state():
    """A row whose centroids are all dead: m is the sentinel, l the slot
    count, acc the sum of the values — the Pallas kernel's state where
    ``Nc % block_n == 0`` (it pads to a whole tile otherwise)."""
    q, kc, vc, cnt = _inputs(3, 2, 8, 2, 128, 32)
    cnt[0, 1] = 0.0
    want = _pallas_state(*map(jnp.asarray, (q, kc, vc, cnt)), 32 ** -0.5, 64)
    acc, m, l = cluster_attn.cluster_attn_partial(*_t(q, kc, vc, cnt),
                                                  32 ** -0.5)
    assert torch.all(m[0, 1] == NEG)
    assert torch.all(l[0, 1] == 128.0)
    for g_, w_ in zip((acc, m, l), want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=3e-4,
                                   atol=3e-4)


@pytest.mark.parametrize("b,h,hkv,nc,dh,bn", SHAPES)
def test_bf16_inputs(b, h, hkv, nc, dh, bn):
    q, kc, vc, cnt = _inputs(4, b, h, hkv, nc, dh)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, kc, vc))
    want = cluster_attn_decode_pallas(jq, jk, jv, jnp.asarray(cnt),
                                      dh ** -0.5, block_n=bn, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, kc, vc))
    got = cluster_attn.cluster_attn_decode(tq, tk, tv, torch.from_numpy(cnt),
                                           dh ** -0.5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,nc,dh,bn", [(1, 4, 4, 128, 80, 64),
                                              (2, 8, 2, 192, 80, 64)])
def test_dh80_matches_pallas(b, h, hkv, nc, dh, bn, dtype):
    """zamba2's head dim (80: 10 pieces of 16 bytes in bf16, 20 in f32),
    one and four query heads per kv head: the plain version's state
    against the Pallas kernel's own ``pallas_call`` in interpret mode on
    the same (bf16-rounded) inputs.  3e-4 (the reference tests'), as both
    compute in f32 from the same values."""
    q, kc, vc, cnt = _inputs(11, b, h, hkv, nc, dh)
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, kc, vc))
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (tq, tk, tv))
    want = _pallas_state(jq, jk, jv, jnp.asarray(cnt), dh ** -0.5, bn)
    got = cluster_attn.cluster_attn_partial(tq, tk, tv,
                                            torch.from_numpy(cnt),
                                            dh ** -0.5)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=3e-4,
                                   atol=3e-4)


@pytest.mark.parametrize("dh,dtype,lanes", [
    (80, torch.bfloat16, 16), (80, torch.float32, 32),
    (40, torch.bfloat16, 8), (40, torch.float32, 16),
    (128, torch.bfloat16, 16), (256, torch.bfloat16, 32)])
def test_attn_inputs_accept_whole_pieces(dh, dtype, lanes):
    """Any row of whole 16-byte pieces (at most 32) is taken: the lanes of
    a row are its pieces rounded up to a power of two, the powers of two
    keep one lane a piece."""
    q, kc, vc, cnt = _t(*_inputs(12, 1, 8, 2, 40, dh))
    q, kc, vc = (t.to(dtype) for t in (q, kc, vc))
    assert tiles.check_attn_inputs("cluster_attn", q, kc, vc, cnt) == (
        1, 8, 2, 40, dh)
    assert tiles.attn_lanes_per_row(dh, dtype) == lanes
    assert tiles.attn_pieces(dh, dtype) == dh * kc.element_size() // 16


@pytest.mark.parametrize("dh,dtype", [(12, torch.bfloat16),
                                      (10, torch.float32),
                                      (84, torch.bfloat16)])
def test_attn_inputs_refuse_partial_pieces(dh, dtype):
    """A row that is not a whole number of 16-byte pieces is refused
    before any launch (24, 40 and 168 bytes)."""
    q, kc, vc, cnt = _t(*_inputs(13, 1, 4, 2, 20, dh))
    q, kc, vc = (t.to(dtype) for t in (q, kc, vc))
    with pytest.raises(TileError, match="16-byte pieces"):
        tiles.check_attn_inputs("cluster_attn", q, kc, vc, cnt)


def test_plain_version_counts_no_launch():
    before = cluster_attn.launches
    q, kc, vc, cnt = _inputs(5, 1, 4, 2, 20, 16)
    acc, m, l = cluster_attn.cluster_attn_partial(*_t(q, kc, vc, cnt), 0.25)
    assert cluster_attn.launches == before
    ref = cluster_attn_decode_ref(*_t(q, kc, vc, cnt), 0.25)
    assert all(torch.equal(a, b) for a, b in zip((acc, m, l), ref))


def test_input_contract():
    q, kc, vc, cnt = _t(*_inputs(6, 1, 4, 2, 20, 16))
    with pytest.raises(ValueError, match="H % Hkv"):
        cluster_attn.cluster_attn_partial(q[:, :3], kc, vc, cnt, 0.25)
    with pytest.raises(TypeError, match="counts"):
        cluster_attn.cluster_attn_partial(q, kc, vc, cnt.double(), 0.25)
    with pytest.raises(TypeError, match="vc"):
        cluster_attn.cluster_attn_partial(q, kc, vc.bfloat16(), cnt, 0.25)
    with pytest.raises(ValueError, match="match"):
        cluster_attn.cluster_attn_partial(q, kc, vc[:, :, :10], cnt, 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        cluster_attn.cluster_attn_partial(
            q, kc.transpose(2, 3).contiguous().transpose(2, 3), vc, cnt, 0.25)
    with pytest.raises(ValueError, match="on meta"):
        cluster_attn.cluster_attn_partial(q, kc, vc.to("meta"), cnt, 0.25)
    # shapes outside the kernel's launch contract raise before any launch
    with pytest.raises(TileError) as e:                  # 9 heads per kv
        cluster_attn.cluster_attn_partial(
            *_t(*_inputs(7, 1, 9, 1, 20, 16)), 0.25)
    assert e.value.block == 8
    with pytest.raises(TileError):                       # 10 * 4 bytes
        cluster_attn.cluster_attn_partial(
            *_t(*_inputs(8, 1, 4, 2, 20, 10)), 0.25)
    with pytest.raises(TileError):                       # 64 pieces
        cluster_attn.cluster_attn_partial(
            *_t(*_inputs(9, 1, 2, 1, 8, 256)), 0.25)


def test_meta_device_is_refused():
    """``meta`` inputs beside inputs on another device are refused; all on
    ``meta`` (the dry run) they get empty f32 outputs of the plain
    version's shapes: no computation, no launch, no plain version."""
    cpu = _t(*_inputs(10, 1, 4, 2, 20, 16))
    q, kc, vc, cnt = (t.to("meta") for t in cpu)
    with pytest.raises(ValueError, match="on meta"):
        cluster_attn.cluster_attn_partial(cpu[0], kc, vc, cnt, 0.25)
    before = cluster_attn.launches
    got = cluster_attn.cluster_attn_partial(q, kc, vc, cnt, 0.25)
    want = cluster_attn.cluster_attn_partial(*cpu, 0.25)
    assert cluster_attn.launches == before
    for g, w in zip(got, want):
        assert g.device.type == "meta" and g.shape == w.shape
        assert g.dtype == torch.float32


@pytest.mark.parametrize("b,hkv,nc,want", [
    (1, 8, 8192, (33, 249)), (4, 8, 1000, (8, 125)), (1, 4, 10, (1, 10)),
    (2, 2, 300, (4, 75)), (1, 1, 10 ** 6, (264, 3788)),
    (1, 1, 10 ** 7, (1221, 8191))])
def test_attn_splits(b, hkv, nc, want):
    """One wave of at most two blocks per SM, 64 to 8192 centroids each."""
    s, chunk = attn_splits(b, hkv, nc, 132)
    assert (s, chunk) == want
    assert (s - 1) * chunk < nc <= s * chunk
    assert chunk <= tiles.ATTN_MAX_ROWS


@pytest.mark.parametrize("dh,dtype,want", [
    (128, torch.bfloat16, 32), (128, torch.float32, 16),
    (16, torch.float32, 128), (64, torch.bfloat16, 64)])
def test_attn_stage_rows(dh, dtype, want):
    """A ring stage holds 16 KB of key and value rows."""
    assert tiles.attn_stage_rows(dh, dtype) == want
    assert 2 * want * dh * torch.finfo(dtype).bits // 8 \
        <= tiles.ATTN_STAGE_BYTES
