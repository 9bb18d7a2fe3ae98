"""The MoE layer over the "model" axis, on the CPU: ``moe_ffn`` given the
experts of 2 and 4 positions (``ModelSplit`` of ``"cpu"`` repeated)
against ``moe_ffn`` whole on the same inputs, with ``test_torch_moe.py``'s
tied, skewed and ample routers (the first two drop entries), top 1 and
2, in f32 and bf16: the output, the aux loss and the gradients of x, the
router and each expert equal bit for bit (``torch.equal``: the split cuts
no sum, it hands each position whole experts).  Then the two collectives
it uses (``split_model``, ``concat_model``): the identity at one
position, a backward that concatenates or slices with no add (bitwise),
and their counts; and which weights an MoE block splits."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.model_axis import (ModelSplit, concat_model,
                                         split_model)
from repro_torch.models import lm
from repro_torch.models import moe as tmoe
from test_torch_moe import D, E, ROUTERS, _moe_params


def _layer(p, x, kw, split=None):
    """(y, aux, the gradients of x and of each weight of ``p``) of one
    ``moe_ffn`` call, whole or over ``split``'s positions, under a fixed
    random output gradient."""
    ps = {n: t.clone().requires_grad_(True) for n, t in p.items()}
    xx = x.clone().requires_grad_(True)
    if split is None:
        y, aux = tmoe.moe_ffn(ps, xx, **kw)
    else:
        n = E // len(split.devices)
        experts = [{w: ps[w][m * n:(m + 1) * n] for w in ("we1", "we3",
                                                           "we2")}
                   for m in range(len(split.devices))]
        y, aux = tmoe.moe_ffn({"router": ps["router"]}, xx, split=split,
                              experts=experts, **kw)
    gy = torch.randn(y.shape, generator=torch.Generator().manual_seed(7)
                     ).to(y.dtype)
    grads = torch.autograd.grad((y.float() * gy.float()).sum() + aux,
                                [xx, *ps.values()])
    return y, aux, dict(zip(["x", *ps], grads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ways", [2, 4])
@pytest.mark.parametrize("router", sorted(ROUTERS))
@pytest.mark.parametrize("top_k", [1, 2])
def test_expert_parallel_layer_is_the_whole_layer_bit_for_bit(
        dtype, ways, router, top_k):
    """Output, aux loss and every gradient equal (``torch.equal``); the
    cases that drop entries drop them (the dispatch is the whole
    layer's), and the split moved the dispatch block and the gates out
    and the experts' outputs back."""
    opts = ROUTERS[router]
    p = _moe_params(shared=False, seed=1, router_scale=opts["router_scale"])
    if router == "tied":
        p["router"][:] = 0.0
    p = {n: torch.from_numpy(a).to(torch.float32 if n == "router" else dtype)
         for n, a in p.items()}
    x = torch.from_numpy(
        np.random.default_rng(9).normal(size=(2, 40, D)).astype(
            np.float32)).to(dtype)
    kw = dict(n_experts=E, top_k=top_k, capacity_factor=opts["factor"])
    split = ModelSplit(["cpu"] * ways)
    y0, a0, g0 = _layer(p, x, kw)
    y1, a1, g1 = _layer(p, x, kw, split)
    assert y1.dtype == dtype and torch.equal(y0, y1)
    assert torch.equal(a0, a1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    assert g1["we1"].abs().sum() > 0 and g1["router"].abs().sum() > 0
    t = 40 * top_k
    c = tmoe.capacity(t, E, opts["factor"], 4)
    _, _, ids, _ = tmoe._route(x, p["router"], top_k)
    kept = int((tmoe._dispatch_indices(ids.reshape(2, t), E, c) < t).sum())
    assert (kept < 2 * t) == (router != "ample")
    b, n = 2, E * c
    xe_bytes = b * n * D * x.element_size()
    gate_bytes = b * n * x.element_size()
    assert split.counts["split_model_calls"] == 2
    assert split.counts["split_model_bytes"] == (ways - 1) * (
        xe_bytes + gate_bytes) // ways
    assert split.counts["concat_model_calls"] == 1
    assert split.counts["concat_model_bytes"] == (ways - 1) * xe_bytes // ways
    assert split.counts["from_model_adds"] == 0


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def test_at_one_position_split_and_concat_return_their_input():
    """A "model" axis of 1: no copy, no slice, no count."""
    x = torch.randn((3, 4, 2), dtype=torch.bfloat16)
    assert split_model(x, ["cpu"], 1)[0] is x
    assert concat_model([x], 1) is x
    split = ModelSplit(["cpu"])
    assert split.split_model(x, 1)[0] is x
    assert split.concat_model([x], 1) is x
    assert "split_model_calls" not in split.counts
    assert "concat_model_calls" not in split.counts


@pytest.mark.parametrize("ways", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_and_concat_move_gradients_without_adding(ways, dtype):
    """``split_model``'s slices are ``x``'s, its backward the slices'
    gradients concatenated in mesh order (a slice with no gradient gives
    zeros); ``concat_model`` is ``torch.cat`` and hands each part its
    slice of the gradient: every value bit for bit."""
    gen = torch.Generator().manual_seed(ways)
    x = torch.randn((2, 8, 3), generator=gen).to(dtype).requires_grad_(True)
    parts = split_model(x, ["cpu"] * ways, 1)
    n = 8 // ways
    assert len(parts) == ways
    for m, t in enumerate(parts):
        assert torch.equal(t, x.detach()[:, m * n:(m + 1) * n])
    gs = [torch.randn(t.shape, generator=gen).to(dtype) for t in parts]
    used = [m for m in range(ways) if m != 1]
    (gx,) = torch.autograd.grad([parts[m] for m in used],
                                [x], [gs[m] for m in used])
    want = torch.cat([gs[m] if m != 1 else torch.zeros_like(gs[m])
                      for m in range(ways)], 1)
    assert torch.equal(gx, want)

    ps = [t.detach().clone().requires_grad_(True) for t in parts]
    y = concat_model(ps, 1)
    assert torch.equal(y, x.detach())
    g = torch.randn(y.shape, generator=gen).to(dtype)
    got = torch.autograd.grad(y, ps, g)
    for m in range(ways):
        assert torch.equal(got[m], g[:, m * n:(m + 1) * n])
    with pytest.raises(ValueError):
        split_model(x, ["cpu"] * 3, 1)


# ---------------------------------------------------------------------------
# what an MoE block splits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,ways", [("dbrx-132b", 2), ("dbrx-132b", 4),
                                       ("llama4-maverick-400b-a17b", 2),
                                       ("dbrx-132b", 3)])
def test_an_moe_block_splits_its_experts_and_shared_expert(arch, ways):
    """Position m's experts ``[m E/M, (m+1) E/M)`` of ``moe.we1``,
    ``moe.we3``, ``moe.we2``, whole along d and d_ff, where M divides E
    (none where it does not); llama4's shared expert by its hidden
    columns; never the router."""
    cfg = get_config(arch).reduced()
    blk = lm.AttnBlock(cfg, torch.float32, "meta", moe=True)
    regions = blk.split_regions(ways)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    assert not any(n.endswith("router") for n in regions)
    if e % ways:
        assert not any(n.startswith("moe.we") for n in regions)
    else:
        for name in ("moe.we1", "moe.we3", "moe.we2"):
            inner = ((slice(0, d), slice(0, f)) if name != "moe.we2"
                     else (slice(0, f), slice(0, d)))
            assert regions[name] == [
                (slice(m * e // ways, (m + 1) * e // ways), *inner)
                for m in range(ways)]
    shared = cfg.name.startswith("llama4")
    assert ("moe.w1" in regions) == shared and "w1" not in regions
    if shared:
        assert regions["moe.w2"][1] == (slice(f // 2, f), slice(0, d))
    assert lm.AttnBlock(cfg, torch.float32, "meta", moe=True
                        ).split_regions(1) == {}
    odd = dataclasses.replace(cfg, d_ff=cfg.d_ff + 1)
    if shared:
        assert "moe.w1" not in lm.AttnBlock(odd, torch.float32, "meta",
                                            moe=True).split_regions(2)
