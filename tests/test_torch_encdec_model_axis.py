"""Whisper's blocks and the VLM's patch projection over the "model" axis,
on the CPU in f32 at reduced width (whisper-base's reduced config: d 64,
4 heads of 16, d_ff 128; 32 frames).

Each block alone runs on a ``ModelSplit`` of ``"cpu"`` repeated, each
position given its region of every weight the block's ``split_regions``
names (cut by :func:`repro_torch.core.blocks.gather`), against the same
block whole on the same inputs and output gradient: the output, the
inputs' gradients (an encoder layer's ``x``; a decoder layer's ``x`` and
the encoder output ``enc`` its cross attention reads) and every weight's
gradient (each position's added back into a whole tensor by
:func:`~repro_torch.core.blocks.add_into` in mesh order) at rtol 1e-5 and
atol 1e-6 of the tensor's largest entry where it is above 1: f32
rounding of another order of the row-parallel sums.  A block whose heads
M does not divide computes its attention whole and still splits its FFN.
Then the model: ``encode`` carries the split into its layers, whisper's
vocab-parallel loss matches the whole loss (rtol 1e-6, its gradient at
rtol 1e-5 / atol 1e-7), and internvl2's ``embed_in`` over "model" is the
whole one bit for bit (its columns are products of the same rows; no sum
is split)."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.func import functional_call

from repro_torch.configs import get_config
from repro_torch.core import blocks
from repro_torch.core.model_axis import ModelSplit
from repro_torch.models import build_model, encdec
from repro_torch.models.layers import rope_tables

B, S, CHUNK = 2, 16, 8


def _cfg(**over):
    return dataclasses.replace(get_config("whisper-base").reduced(), **over)


def _draw(module, seed: int = 0):
    """Every parameter of ``module`` drawn from numpy ``seed`` (norms at
    0.1, projections at ``d_in ** -0.5``), so every head differs."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for _, p in module.named_parameters():
            scale = 0.1 if p.dim() == 1 else p.shape[-2] ** -0.5
            p.copy_(torch.from_numpy(rng.normal(
                size=tuple(p.shape)).astype(np.float32) * scale))
    return module


def _ctx(cfg, split) -> dict:
    return {"rope": rope_tables(torch.arange(S), cfg.dh, cfg.rope_theta),
            "q_chunk": CHUNK, "model_split": split}


def _parts(module, regions: dict, ways: int) -> list:
    """Each position's regions of ``module``'s weights, as leaves that
    record their gradients."""
    named = dict(module.named_parameters())
    return [{n: blocks.gather(blocks.Sharded.whole(named[n].detach()),
                              "cpu", (), rs[m]).clone().requires_grad_(True)
             for n, rs in regions.items()} for m in range(ways)]


def _run(blk, inputs: dict, gy, cfg, ways: int = 1):
    """(y, {input or weight name: its gradient}, the split) of one call of
    ``blk`` on ``inputs`` (``x``, and ``enc`` for a decoder layer), whole
    or over ``ways`` positions, under the output gradient ``gy``."""
    whole = {n: p.detach().clone().requires_grad_(True)
             for n, p in blk.named_parameters()}
    regions = blk.split_regions(ways) if ways > 1 else {}
    parts = _parts(blk, regions, ways)
    split = ModelSplit(["cpu"] * ways, {blk: parts} if regions else {})
    xs = {k: v.clone().requires_grad_(True) for k, v in inputs.items()}
    y = functional_call(blk, whole, (*xs.values(), _ctx(cfg, split)))
    leaves = [*xs.values(), *whole.values()] + [t for p in parts
                                                for t in p.values()]
    gs = torch.autograd.grad((y * gy).sum(), leaves, allow_unused=True)
    grads = dict(zip(xs, gs))
    for n, g in zip(whole, gs[len(xs):]):
        grads[n] = torch.zeros_like(whole[n]) if g is None else g
    it = iter(gs[len(xs) + len(whole):])
    for m, p in enumerate(parts):          # mesh order
        for n in p:
            g = next(it)
            if g is not None:
                blocks.add_into(blocks.Sharded.whole(grads[n]), g, (),
                                regions[n][m])
    return y.detach(), grads, split


def _close(got, want, what: str) -> None:
    scale = max(1.0, float(want.abs().max()))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6 * scale, err_msg=what)


CASES = {
    # layer, heads, ways: by heads and hidden columns; heads M does not
    # divide (attention whole, FFN by columns)
    "enc_2": ("enc", 4, 2),
    "enc_4": ("enc", 4, 4),
    "enc_heads_whole": ("enc", 3, 2),
    "dec_2": ("dec", 4, 2),
    "dec_4": ("dec", 4, 4),
    "dec_heads_whole": ("dec", 3, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_over_model_is_the_whole_block(case):
    """The output, the inputs' gradients and every weight's gradient at
    rtol 1e-5 / atol 1e-6; each position holds a nonzero part of every
    gradient it splits; the row-parallel adds counted: the attention's
    ``wo`` and the FFN's ``w2`` in an encoder layer, and ``xattn.wo`` in
    a decoder layer, where the heads split."""
    layer, heads, ways = CASES[case]
    cfg = _cfg(n_heads=heads, n_kv_heads=heads)
    cls = encdec.EncBlock if layer == "enc" else encdec.DecBlock
    blk = _draw(cls(cfg, torch.float32, "cpu"))
    rng = np.random.default_rng(1)
    inputs = {"x": torch.from_numpy(rng.normal(
        size=(B, S, cfg.d_model)).astype(np.float32))}
    if layer == "dec":
        inputs["enc"] = torch.from_numpy(rng.normal(
            size=(B, cfg.encoder_ctx, cfg.d_model)).astype(np.float32))
    gy = torch.from_numpy(rng.normal(size=(B, S, cfg.d_model)
                                     ).astype(np.float32))
    y0, g0, _ = _run(blk, inputs, gy, cfg)
    y1, g1, split = _run(blk, inputs, gy, cfg, ways)
    regions = blk.split_regions(ways)
    attn_split = heads % ways == 0
    assert ("attn.wq" in regions) == attn_split
    assert ("xattn.wq" in regions) == (attn_split and layer == "dec")
    assert "w1" in regions
    n_attn = (2 if layer == "dec" else 1) if attn_split else 0
    assert split.counts["from_model_adds"] == n_attn + 1
    _close(y1, y0, "output")
    for name in g0:
        _close(g1[name], g0[name], name)
        assert float(g0[name].abs().sum()) > 0, name


def test_block_regions_at_full_width():
    """whisper-base's layers on 2 positions: 4 of the 8 heads' 256 columns
    of ``wq``, ``wk``, ``wv`` and rows of ``wo`` (a decoder layer's
    ``xattn`` too), 1024 of the 2048 FFN columns; on 16 the attention is
    whole and the FFN splits to 128 columns; at M = 1 nothing splits."""
    cfg = get_config("whisper-base")
    dec = encdec.DecBlock(cfg, torch.bfloat16, "meta")
    r2 = dec.split_regions(2)
    assert sorted(r2) == sorted(
        [f"{a}.w{n}" for a in ("attn", "xattn") for n in "qkvo"]
        + ["w1", "w2", "w3"])
    assert r2["attn.wq"][1] == (slice(0, 512), slice(256, 512))
    assert r2["xattn.wo"][0] == (slice(0, 256), slice(0, 512))
    assert r2["w2"][1] == (slice(1024, 2048), slice(0, 512))
    r16 = encdec.EncBlock(cfg, torch.bfloat16, "meta").split_regions(16)
    assert sorted(r16) == ["w1", "w2", "w3"]
    assert r16["w1"][3] == (slice(0, 512), slice(384, 512))
    assert dec.split_regions(1) == {}


def _whisper():
    cfg = get_config("whisper-base").reduced()
    return cfg, _draw(build_model(cfg, device="cpu"))


def test_encode_carries_the_split_into_its_layers():
    """``encode`` with a ``model_split`` in its context computes each
    encoder layer over "model" (two row-parallel adds a layer) and
    matches the whole encoder at rtol 1e-5 / atol 1e-6."""
    cfg, model = _whisper()
    rng = np.random.default_rng(2)
    frames = torch.from_numpy(rng.normal(
        size=(B, cfg.encoder_ctx, cfg.d_model)).astype(np.float32))
    want = model.encode(frames, {"q_chunk": CHUNK})
    split = ModelSplit(["cpu"] * 2, {
        blk: _parts(blk, blk.split_regions(2), 2) for blk in model.enc})
    got = model.encode(frames, {"q_chunk": CHUNK, "model_split": split})
    assert split.counts["from_model_adds"] == 2 * cfg.encoder_layers
    _close(got.detach(), want.detach(), "encoder output")


def test_whisper_vocab_parallel_loss_matches_the_whole_loss():
    """``loss_embedded`` with the head's Vp/2 columns on each of two
    positions (the layers whole): the loss at rtol 1e-6 and the
    gradient of the embedded tokens at rtol 1e-5 / atol 1e-7; the whole
    logits are never formed."""
    cfg, model = _whisper()
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(rng.normal(
        size=(B, cfg.encoder_ctx, cfg.d_model)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    ctx = model.make_ctx(torch.arange(S), q_chunk=CHUNK)
    rest = {"frames": frames, "labels": labels}
    regions = {"head": model.split_regions(2)["head"]}
    split = ModelSplit(["cpu"] * 2, {model: _parts(model, regions, 2)})
    out = []
    for c in (ctx, dict(ctx, model_split=split)):
        x = model.embed_in({"tokens": tokens}).requires_grad_(True)
        loss = model.loss_embedded(x, rest, c, remat=False)
        out.append((loss.detach(), torch.autograd.grad(loss, [x])[0]))
    (want, gwant), (got, ggot) = out
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(ggot.numpy(), gwant.numpy(), rtol=1e-5,
                               atol=1e-7)
    assert split.counts["from_model_adds"] == 0


def test_encdec_regions_name_every_layer_and_the_head():
    """``EncDecLM.split_regions(2)``: every encoder and decoder layer's
    regions under ``enc.i.`` / ``dec.i.``, and the head's columns."""
    cfg, model = _whisper()
    regions = model.split_regions(2)
    vp = cfg.padded_vocab
    assert regions["head"] == [(slice(0, 64), slice(0, vp // 2)),
                               (slice(0, 64), slice(vp // 2, vp))]
    for i in range(cfg.encoder_layers):
        assert f"enc.{i}.attn.wq" in regions and f"enc.{i}.w1" in regions
        assert f"enc.{i}.xattn.wq" not in regions
    for i in range(cfg.n_layers):
        assert f"dec.{i}.xattn.wk" in regions and f"dec.{i}.w2" in regions
    assert model.split_regions(1) == {}


@pytest.mark.parametrize("ways", [2, 4])
def test_vlm_patch_projection_over_model_is_the_whole_one(ways):
    """internvl2-2b reduced: ``embed_in`` with each position's d/M columns
    of ``patch_proj`` equals it whole bit for bit, the columns put
    together once (``concat_model``)."""
    cfg = get_config("internvl2-2b").reduced()
    model = _draw(build_model(cfg, device="cpu"))
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))),
             "patches": torch.from_numpy(rng.normal(
                 size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32))}
    regions = {"patch_proj": model.split_regions(ways)["patch_proj"]}
    split = ModelSplit(["cpu"] * ways, {model: _parts(model, regions, ways)})
    with torch.no_grad():
        want = model.embed_in(batch)
        got = model.embed_in(batch, {"model_split": split})
    assert torch.equal(got, want)
    assert split.counts["concat_model_calls"] == 1
