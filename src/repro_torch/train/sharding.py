"""Partition rules: parameter path -> partition spec (the counterpart of
:mod:`repro.train.sharding`).

The rules are axis-NAME based, so one table drives the 1-pod (16, 16)
("data", "model") mesh, the 2-pod (2, 16, 16) ("pod", "data", "model")
mesh and any elastic resize.  The reference's strategy, which the specs
describe:

  * batch over ("pod", "data"): the pod axis carries only the gradient
    all-reduce;
  * tensor parallel over "model" (heads, ffn hidden, vocab, experts);
  * ZeRO-3: the remaining big parameter dim shards over "data".

The port lays a train state out as the specs describe, in the blocks of
:mod:`repro_torch.core.blocks`: for each leaf and its spec, mesh position
p holds one block of the leaf's rank, and positions that the spec does
not tell apart hold the same block once per distinct device.  This
module gives the specs (``param_specs``, ``grad_specs``,
``opt_state_specs``), a whole state cut into them (:func:`shard_state`)
and the step's one gradient accumulator (:func:`grad_accumulator`); the
bytes each position holds equal :func:`shard_bytes` for the parameters,
the accumulator and the optimizer state.  The sharded step
(:mod:`repro_torch.train.step`) gathers each layer's weights inside its
checkpointed call and adds its gradient back into the owners' blocks.
Each data shard computes on its positions along "model"
(:func:`model_positions`): attention by heads, the dense FFN (and
llama4's shared expert) by hidden columns, the MoE experts by expert and
an untied head by vocab columns, each position reading over "data" only
its column block of ``attn/w[qkv]``, ``w1``, ``w3`` and ``head``, its
row block of ``attn/wo`` and ``w2`` (the kv heads its query heads read,
where M does not divide the kv heads) and its experts' block of
``moe/we[123]``; what M does not split (attention whose heads M does not
divide, experts M does not divide, the MoE router, the recurrent blocks,
whisper's blocks, ``patch_proj``, a tied head) is gathered whole and
computed on the shard's first position.
The specs are the reference's,
computed over the port's trees (the stacked tree of
:func:`repro_torch.convert.stacked_like`, the port's optimizer states,
``models.input_specs`` and ``init_caches``); the dry run reads
:func:`shard_bytes` for what one device holds.  A mesh is anything with
``axis_names`` and a ``shape`` dict (a
:class:`~repro_torch.launch.mesh.Mesh` or an
:class:`~repro_torch.launch.mesh.AbstractMesh`); blocks need a ``Mesh``.
There is no ``param_shardings``: the port has no ``NamedSharding``.
"""
from __future__ import annotations

import math
import re
from typing import Sequence

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.blocks import axes_of, shard_tree, ways, zeros


class PartitionSpec(tuple):
    """One entry per leading dim of an array: an axis name, a tuple of
    names (the dim split over their product), or ``None`` (whole); dims
    past the last entry are whole (JAX's ``PartitionSpec``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

# (path-regex, spec), first match wins.  Paths look like
# "g_blocks/attn/wq", "g_super/mamba/in_proj", "shared/attn/wq", "embed".
RULES: Sequence[tuple[str, P]] = (
    # The embed table is replicated (the reference's GSPMD gather cannot
    # shard it with the batch); its optimizer state and gradient
    # accumulator are sharded (opt_state_specs, grad_specs).
    (r"embed$",                      P(None, None)),
    (r"head$",                       P("data", "model")),
    (r"patch_proj$",                 P("data", "model")),
    # attention projections (stacked: leading layer dim)
    (r"attn/w[qkv]$",                P(None, "data", "model")),
    (r"attn/wo$",                    P(None, "model", "data")),
    (r"xattn/w[qkv]$",               P(None, "data", "model")),
    (r"xattn/wo$",                   P(None, "model", "data")),
    # dense FFN
    (r"w[13]$",                      P(None, "data", "model")),
    (r"w2$",                         P(None, "model", "data")),
    # MoE (experts over "model" = expert parallelism)
    (r"moe/router$",                 P(None, "data", None)),
    (r"moe/we[13]$",                 P(None, "model", "data", None)),
    (r"moe/we2$",                    P(None, "model", None, "data")),
    # xLSTM
    (r"mlstm/(up[12]|w[qkv])$",      P(None, None, "data", "model")),
    (r"mlstm/down$",                 P(None, None, "model", "data")),
    (r"mlstm/w[if]$",                P(None, None, "data", None)),
    (r"slstm/(w[zifo]|down)$",       P(None, "data", "model")),
    (r"slstm/r[zifo]$",              P(None, None, "data", "model")),
    # Mamba2
    (r"mamba/in_proj$",              P(None, None, "data", "model")),
    (r"mamba/out_proj$",             P(None, None, "model", "data")),
    (r"mamba/conv$",                 P(None, None, "model", None)),
    # everything small (norms, A_log, D, dt_bias, ...): replicated
    (r".*",                          P()),
)

# zamba2's shared block has no leading layer dim: strip one None
_SHARED_PREFIX = "shared/"
_EMBED_STATE_SPEC = P("data", "model")


def spec_for(path_str: str, ndim: int, mesh_axes: Sequence[str]) -> P:
    """The first rule matching ``path_str``, padded or trimmed to ``ndim``
    from the left, with the axes the mesh lacks dropped."""
    for pat, spec in RULES:
        if re.search(pat, path_str):
            parts = list(spec)
            if path_str.startswith(_SHARED_PREFIX) and parts[:1] == [None]:
                parts = parts[1:]
            while len(parts) < ndim:
                parts.insert(0, None)
            parts = parts[-ndim:] if len(parts) > ndim else parts
            parts = [a if (a in mesh_axes or a is None) else None
                     for a in parts]
            return P(*parts)
    return P()


def filter_divisible(spec: P, shape, mesh) -> P:
    """``spec`` with the sharding dropped on every dim its mesh axes do not
    divide (whisper's 51,865 vocabulary on 16 ways)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    return P(*(None if ax is None or shape[dim] % ways(ax, mesh)
               else ax for dim, ax in enumerate(parts[:len(shape)])))


def param_specs(params_like, mesh):
    """A tree of specs matching ``params_like`` (tensors, ``meta`` ones
    included)."""
    def per(path, leaf):
        s = spec_for(tree.key_of(path), leaf.dim(), mesh.axis_names)
        return filter_divisible(s, leaf.shape, mesh)

    return tree.map_with_path(per, params_like)


def grad_specs(params_like, mesh):
    """Gradient and accumulator specs: the parameters', except the embed
    table's gradient, reduce-scattered to ("data", "model")."""
    def per(path, leaf):
        ps = tree.key_of(path)
        if ps.endswith("embed"):
            return filter_divisible(_EMBED_STATE_SPEC, leaf.shape, mesh)
        return filter_divisible(spec_for(ps, leaf.dim(), mesh.axis_names),
                                leaf.shape, mesh)

    return tree.map_with_path(per, params_like)


def opt_state_specs(opt_state_like, params_specs, mesh):
    """Optimizer-state specs: a moment or master weight takes its
    parameter's spec; Adafactor's factored ``vr`` drops the last dim's
    entry, ``vc`` the next-to-last; the embed table's state is sharded
    (ZeRO for the replicated table); ``step`` is replicated.
    ``params_specs`` is unused, as in the reference."""
    axes = mesh.axis_names

    def per(path, leaf):
        ps_full = tree.key_of(path)
        if ps_full == "step":
            return P()
        ps = re.sub(r"^(m|v|master|fac)/", "", ps_full)
        tail = None
        mfac = re.search(r"/(vr|vc)$", ps)
        if mfac:
            tail = mfac.group(1)
            ps = ps[:mfac.start()]
        if ps.endswith("embed") and tail is None:
            return filter_divisible(_EMBED_STATE_SPEC, leaf.shape, mesh)
        parts = list(spec_for(ps, leaf.dim() + (1 if tail else 0), axes))
        if tail == "vr":        # last dim reduced away
            parts = parts[:-1]
        elif tail == "vc":      # next-to-last dim reduced away
            parts = parts[:-2] + parts[-1:]
        while len(parts) < leaf.dim():
            parts.insert(0, None)
        if len(parts) > leaf.dim():
            parts = parts[-leaf.dim():]
        return filter_divisible(P(*parts), leaf.shape, mesh)

    return tree.map_with_path(per, opt_state_like)


def batch_axis(mesh):
    """The axes the batch splits over: ("pod", "data"), or "data"."""
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def dp_size(mesh) -> int:
    """The number of data-parallel shards: the product of
    :func:`batch_axis`'s sizes."""
    return ways(batch_axis(mesh), mesh)


def batch_devices(mesh) -> list:
    """The device of each data-parallel shard, in mesh order (pod major),
    the other axes at index 0: a ``Mesh``'s entries along
    :func:`batch_axis` (entries may repeat a device)."""
    axes = axes_of(batch_axis(mesh))
    pick = tuple(slice(None) if a in axes else 0 for a in mesh.axis_names)
    return list(np.asarray(mesh.devices[pick]).reshape(-1))


def model_positions(mesh) -> list:
    """For each data shard (in :func:`batch_devices`' order), its
    positions along "model" in mesh order, ``[(flat mesh index,
    device)]``, the mesh's other axes at index 0; one position a shard
    where the mesh has no "model" axis."""
    axes = axes_of(batch_axis(mesh))
    shards: dict = {}
    for flat, idx in enumerate(np.ndindex(*mesh.devices.shape)):
        at = dict(zip(mesh.axis_names, idx))
        if any(i for a, i in at.items() if a not in axes and a != "model"):
            continue
        shards.setdefault(tuple(at[a] for a in axes), []).append(
            (flat, mesh.devices[idx]))
    return [shards[k] for k in sorted(shards)]


def batch_specs(batch_like, mesh):
    """Inputs: the leading (batch) dim split over :func:`batch_axis` when
    it divides and is above 1, else whole (long_500k's batch of 1)."""
    dp, n = batch_axis(mesh), dp_size(mesh)

    def per(leaf):
        if leaf.dim() >= 1 and leaf.shape[0] % n == 0 and leaf.shape[0] > 1:
            return P(dp, *([None] * (leaf.dim() - 1)))
        return P(*([None] * leaf.dim()))

    return tree.map_(per, batch_like)


def cache_specs(cache_like, mesh, batch_size: int):
    """Decode caches, stacked (L, B, ...): B over :func:`batch_axis` when
    it divides and is above 1; the largest later dim that "model"
    divides over "model" (the sequence of a KV cache, the centroids of a
    clustered one, heads or state for a recurrent one)."""
    dp, n = batch_axis(mesh), dp_size(mesh)
    msize = mesh.shape["model"]

    def per(leaf):
        parts = [None] * leaf.dim()
        if leaf.dim() >= 2 and leaf.shape[1] == batch_size \
                and batch_size % n == 0 and batch_size > 1:
            parts[1] = dp
        cand = [(leaf.shape[i], i) for i in range(2, leaf.dim())
                if leaf.shape[i] % msize == 0 and leaf.shape[i] >= msize]
        if cand:
            parts[max(cand)[1]] = "model"
        return P(*parts)

    return tree.map_(per, cache_like)


def shard_bytes(tree_like, specs, mesh) -> int:
    """The bytes one device holds of ``tree_like`` under ``specs``: each
    leaf's dims divided (rounded up) by the ways its spec splits them (the
    reference's ``argument_size_in_bytes`` for those arguments)."""
    total = 0
    for (_, leaf), spec in zip(tree.items(tree_like), tree.leaves(specs)):
        dims = list(leaf.shape)
        for i, ax in enumerate(spec):
            if ax is not None:
                dims[i] = -(-dims[i] // ways(ax, mesh))
        total += math.prod(dims) * leaf.element_size()
    return total


def state_specs(state, mesh) -> dict:
    """The specs of a train state's ``params`` and ``opt`` (whole or
    sharded leaves, or ``meta`` ones)."""
    p_specs = param_specs(state["params"], mesh)
    return {"params": p_specs,
            "opt": opt_state_specs(state["opt"], p_specs, mesh)}


def shard_state(state, mesh) -> dict:
    """A whole train state in the block layout of :func:`state_specs` on
    ``mesh``; ``step`` stays a tensor, on the first data shard's
    device."""
    specs = state_specs(state, mesh)
    return {"params": shard_tree(state["params"], specs["params"], mesh),
            "opt": shard_tree(state["opt"], specs["opt"], mesh),
            "step": state["step"].to(batch_devices(mesh)[0])}


def grad_accumulator(params, mesh, dtype: torch.dtype):
    """The sharded step's one gradient accumulator: zeros in ``dtype`` in
    the blocks of :func:`grad_specs`."""
    return tree.map_(lambda p, s: zeros(p.shape, dtype, s, mesh), params,
                     grad_specs(params, mesh))
