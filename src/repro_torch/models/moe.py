"""Mixture-of-Experts FFN of the port with sort/gather dispatch (the
counterpart of :mod:`repro.models.moe`).

Each token picks its ``top_k`` experts by an f32 router; the (token,
choice) entries are sorted by expert (a stable sort, so within an expert
the earlier entry comes first), ranked within their expert and kept while
the rank is below the capacity C; kept entries are gathered into dense
(B, E, C, d) blocks, run through each expert's SwiGLU, scaled by their
gate, and gathered back per choice.  No (T, E, C) one-hot is built.
Entries ranked at or past C are dropped: they add nothing to the output.

Decode routes the (B, 1) token batch across the sequences with a capacity
floor, so a single request is never dropped.

Over a "model" axis of M positions (a sharded train step's, the
reference's ``expert_spec``), :func:`moe_ffn` given the positions'
expert weights computes the experts expert-parallel: the router, the
top-k, the sort, the capacity ranks, the gates, the aux loss, the
dispatch gather and the combine stay on the data shard's first
position, so the kept and dropped entries are the one-device layer's;
the (B, E, C, d) dispatch block and the slots' gates are cut along E to
the positions (``split_model``), position m runs the SwiGLU of its
experts ``[m E/M, (m+1) E/M)`` and scales by its gates, and the
positions' outputs are concatenated along E on the first position
(``concat_model``).  No sum is split, so the layer is the whole layer's
arithmetic, expert by expert.  Decode and serving compute every MoE
layer whole.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from .layers import swiglu


def _route(x: torch.Tensor, router: torch.Tensor, k: int):
    """-> (gates (B, S, E) f32, gate_k, ids_k (B, S, K), aux loss).  The
    top k by a stable descending sort: equal gates go to the lower expert
    id first, as ``jax.lax.top_k`` orders them."""
    e = router.shape[-1]
    logits = torch.einsum("bsd,de->bse", x.float(), router.float())
    gates = torch.softmax(logits, dim=-1)
    gate_k, ids_k = torch.sort(gates, dim=-1, descending=True, stable=True)
    gate_k, ids_k = gate_k[..., :k], ids_k[..., :k]
    gate_k = gate_k / gate_k.sum(-1, keepdim=True).clamp_min(1e-9)
    me = gates.mean(dim=(0, 1))
    ce = F.one_hot(ids_k, e).float().sum(2).mean(dim=(0, 1))
    aux = e * (me * ce).sum()
    return gates, gate_k, ids_k, aux


def _sorted_slots(expert: torch.Tensor, e: int, c: int):
    """expert: (B, T) ids -> (order (B, T), the stable sort of the entries
    by expert; slot (B, T), each sorted entry's dispatch slot
    ``expert * C + rank``, or the sentinel ``E * C`` where its rank within
    the expert reaches C and it is dropped)."""
    t = expert.shape[1]
    order = torch.argsort(expert, dim=1, stable=True)
    sorted_e = torch.gather(expert, 1, order)
    arange_e = torch.arange(e, device=expert.device, dtype=sorted_e.dtype)
    starts = torch.searchsorted(sorted_e.contiguous(),
                                arange_e.expand(expert.shape[0], e)
                                .contiguous())
    rank = (torch.arange(t, device=expert.device)[None, :]
            - torch.gather(starts, 1, sorted_e))
    slot = torch.where(rank < c, sorted_e * c + rank,
                       torch.full_like(rank, e * c))
    return order, slot


def _slot_sources(order: torch.Tensor, slot: torch.Tensor,
                  n_slots: int) -> torch.Tensor:
    """The entry each of the ``n_slots`` dispatch slots holds (B, n_slots),
    T (the entries' count) where the slot is empty."""
    b, t = order.shape
    flat = torch.full((b, n_slots + 1), t, dtype=torch.long,
                      device=order.device)
    flat.scatter_(1, slot, order)          # dropped entries hit the sentinel
    return flat[:, :n_slots]


def _dispatch_indices(expert: torch.Tensor, e: int, c: int
                      ) -> torch.Tensor:
    """expert: (B, T) -> the entry each of the E * C slots holds (B, E*C),
    ``T`` where the slot is empty."""
    return _slot_sources(*_sorted_slots(expert, e, c), e * c)


def capacity(t: int, n_experts: int, capacity_factor: float,
             min_capacity: int) -> int:
    """Slots per expert for ``t`` entries: the fair share times the
    factor, at least ``min_capacity``, at most ``t``."""
    return min(max(min_capacity, int(-(-t // n_experts) * capacity_factor)),
               t)


def _expert_swiglu(xe: torch.Tensor, we1: torch.Tensor, we3: torch.Tensor,
                   we2: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU of its dispatch block ``xe`` (B, E', C, d) by
    its weights ``we1``/``we3`` (E', d, d_ff) and ``we2`` (E', d_ff, d),
    scaled by each slot's gate (``gates`` (B, E', C, 1), in x's type)."""
    h1 = torch.einsum("becd,edf->becf", xe, we1)
    h3 = torch.einsum("becd,edf->becf", xe, we3)
    hh = (F.silu(h1.float()) * h3.float()).to(xe.dtype)
    del h1, h3
    return torch.einsum("becf,efd->becd", hh, we2) * gates


def moe_ffn(p: Mapping[str, torch.Tensor], x: torch.Tensor, *,
            n_experts: int, top_k: int, capacity_factor: float,
            min_capacity: int = 4, split=None, experts=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux loss).  ``p``: ``router`` (d, E)
    f32, ``we1``/``we3`` (E, d, d_ff), ``we2`` (E, d_ff, d) and, for a
    shared expert, ``w1``/``w3``/``w2``.  With ``split`` (a
    :class:`~repro_torch.core.model_axis.ModelSplit` of M positions) and
    ``experts`` (one ``{we1, we3, we2}`` a position, its E/M experts, on
    its device) the experts are computed over "model" and ``p`` needs no
    expert weights (see the module docstring)."""
    b, s, d = x.shape
    e, k = n_experts, top_k
    t = s * k
    c = capacity(t, e, capacity_factor, min_capacity)

    _, gate_k, ids_k, aux = _route(x, p["router"], k)
    expert = ids_k.reshape(b, t)
    gate = gate_k.reshape(b, t)
    order, slot_sorted = _sorted_slots(expert, e, c)
    slot_src = _slot_sources(order, slot_sorted, e * c)       # (B, E*C)
    tok = torch.where(slot_src < t, slot_src // k,
                      torch.full_like(slot_src, s))           # entry -> token
    gpad = torch.cat([gate, gate.new_zeros((b, 1))], 1)
    gslot = torch.gather(gpad, 1, slot_src.clamp_max(t))      # (B, E*C)
    bidx = torch.arange(b, device=x.device)[:, None]
    xp = torch.cat([x, x.new_zeros((b, 1, d))], 1)
    xe = xp[bidx, tok].reshape(b, e, c, d)
    gates = gslot.reshape(b, e, c, 1).to(x.dtype)

    if experts is None:
        ye = _expert_swiglu(xe, p["we1"], p["we3"], p["we2"], gates)
    else:                                   # expert-parallel over "model"
        ye = split.concat_model(
            [_expert_swiglu(xm, w["we1"], w["we3"], w["we2"], gm)
             for xm, gm, w in zip(split.split_model(xe, 1),
                                  split.split_model(gates, 1), experts)], 1)

    # combine by gather: each entry's slot (the sentinel row of zeros for
    # a dropped one), then each of the K choices of every token
    slot_of_entry = torch.empty_like(slot_sorted)
    slot_of_entry.scatter_(1, order, slot_sorted)             # (B, T)
    ye_flat = torch.cat([ye.reshape(b, e * c, d), ye.new_zeros((b, 1, d))],
                        1)
    y = torch.zeros((b, s, d), dtype=x.dtype, device=x.device)
    for kk in range(k):
        sl = slot_of_entry[:, kk::k]                          # (B, S)
        y = y + ye_flat[bidx, sl]
    if "w1" in p:                                             # llama4
        y = y + swiglu(x, p["w1"], p["w3"], p["w2"])
    return y, aux


def decode_capacity(b: int, n_experts: int, top_k: int) -> int:
    """The decode's capacity floor: twice the fair share of the batch's
    ``b * top_k`` entries, at least ``top_k + 4``."""
    return max(top_k + 4, int(-(-b * top_k // n_experts) * 2))


def moe_ffn_decode(p: Mapping[str, torch.Tensor], x: torch.Tensor, *,
                   n_experts: int, top_k: int) -> torch.Tensor:
    """One-token decode: the (B, 1, d) batch routed across the sequences
    as one sequence of B tokens, with :func:`decode_capacity` slots per
    expert, so a single request is never dropped and a batch rarely."""
    b, s, d = x.shape
    y, _ = moe_ffn(p, x.reshape(1, b, d), n_experts=n_experts, top_k=top_k,
                   capacity_factor=2.0,
                   min_capacity=decode_capacity(b, n_experts, top_k))
    return y.reshape(b, s, d)
