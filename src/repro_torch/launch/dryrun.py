"""Dry run of every (architecture x input shape x production mesh) cell on
the ``meta`` device: the counterpart of :mod:`repro.launch.dryrun`.

The reference lowers and compiles one XLA program a cell against
placeholder arrays, and records XLA's memory and cost analyses.  The port
has no compiler to ask, so its gate is to run the cell's step on ``meta``
tensors at full width and full shape, which propagates every shape and
dtype and computes nothing:

  * the full-depth parameter, optimizer, batch and cache trees are built
    on ``meta``, and a training cell's optimizer updates the full-depth
    state once;
  * the 1- and 2-superblock variants of the model run their step: for
    training one micro-batch's gradient plus the optimizer
    (``make_train_step`` with ``n_micro=1``), for prefill the forward over
    the prompt, for decode one token against the cell's cache kind (the
    cluster-attention kernel's wrapper passes ``meta`` inputs through).

Each cell's record holds the bytes one device would hold under the
reference's partition rules (:mod:`repro_torch.train.sharding`) on the
production mesh (16 x 16, or 2 x 16 x 16), the bytes the port's layout
holds (a training cell's: the sharded trainer's blocks under those rules
plus the largest layer a "model" position gathers and the leaves it
gathers once a step; serving's: its model whole), the bytes of every
tree whole, ``fits`` against the visible card's memory (``null`` with no
card), and ``collective``, the link bytes one chip moves in a step by
the ring model (:func:`collective`).  For a training cell these are the
weights' (``weights``: the gathers as all-gathers, once more for a layer
the remat recompute gathers again, and the gradient adds as
reduce-scatters) and the activations' (``activations``: one micro-batch
of the sharded step run on ``meta`` over the "model" positions, its
forward, remat recompute and backward, in which each row-parallel sum is
an all-reduce of its f32 partials, each column-parallel input's gradient
sum an all-reduce, the vocab-parallel loss three all-reduces of a value a
row, and the MoE dispatch and combine all-to-alls and all-gathers; see
:class:`_RingSplit`).  Serving moves nothing: the port runs its model
whole on one card.

On the single-pod mesh unless ``--no-ab``, the record also holds the
step's cost, assembled as ``PartCost``s by the reference's A/B
differencing (stem + n_super x block (x n_micro) + optimizer): the FLOPs
of ``torch.utils.flop_counter.FlopCounterMode`` (the cluster attention's
4 B H Nc dh a layer added from its formula) and the bytes of
:class:`ByteCounterMode` (each op's inputs and outputs, counted before
any fusion: an upper bound of what the step moves; the cluster
attention's from its kernel model).  The meta step computes the whole
global batch, so the record divides its FLOPs and bytes by ``chips``:
``roofline`` holds ``compute_s`` (FLOPs over the H100's BF16 peak),
``memory_s`` (bytes over HBM) and ``collective_s`` (one chip's link bytes
over NVLink, :mod:`repro_torch.roofline.analysis`), ``dominant`` the
largest, and ``roofline_fraction`` the analytic ``model_flops`` per chip
over the BF16 peak, divided by the dominant term.  ``memory_s`` is an upper
bound, and where it is the dominant term ``roofline_fraction`` is a lower
bound; ``roofline_bounds`` says so and gives the dominant term and the
fraction with ``memory_s`` left out.

Resumable: one JSON a cell under ``build/dryrun/`` (``--out``); existing
files are skipped unless ``--force``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --no-ab
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k --mesh single,multi
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree
from repro_torch.configs import (ARCH_IDS, SHAPES, ArchConfig, ShapeConfig,
                                 get_config, shape_applicable)
from repro_torch.convert import stacked_like, stacked_params
from repro_torch.core.blocks import region_shape, ways
from repro_torch.core.model_axis import ModelSplit
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models.registry import build_model, cache_kind, input_specs
from repro_torch.optim import get_optimizer
from repro_torch.roofline.analysis import (BF16_PEAK, PartCost, dominant_term,
                                           kernel_cost, model_flops,
                                           ring_bytes, roofline_terms)
from repro_torch.train.sharding import (P, batch_specs, cache_specs, dp_size,
                                        filter_divisible, grad_specs,
                                        opt_state_specs, param_specs,
                                        shard_bytes)
from repro_torch.train.step import (TrainPlan, default_plan,
                                    make_prefill_step, make_serve_step,
                                    make_train_step, position_members,
                                    split_owner)

ART = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"

def _variant(cfg: ArchConfig, k: int, layers_per_step: int) -> ArchConfig:
    upd = {"n_layers": k * layers_per_step}
    if cfg.encoder_layers:
        upd["encoder_layers"] = k
    return dataclasses.replace(cfg, **upd)


def layers_per_step(cfg: ArchConfig) -> int:
    """The layers of one step of the model's group, as the reference
    counts them: a gemma, xlstm or zamba2 superblock's (zamba2's with its
    shared attention block), else 1."""
    if cfg.local_per_global:
        return cfg.local_per_global + 1
    if cfg.family == "ssm":
        return cfg.mlstm_per_slstm + 1
    if cfg.family == "hybrid":
        return cfg.mamba_per_attn + 1
    return 1


def n_steps(params) -> int:
    """The steps of a stacked parameter tree's group: the leading dim of
    its ``g_blocks``, ``g_super`` or (whisper's decoder) ``dec`` leaves.
    zamba2 stacks 54 // 9 = 6 superblocks, where the reference's dry run
    counts 54 // 10 = 5."""
    for group in ("g_blocks", "g_super", "dec"):
        if group in params:
            return tree.leaves(params[group])[0].shape[0]
    raise ValueError("n_steps: no stacked group in the tree")


def _optimizer(cfg: ArchConfig, plan: TrainPlan):
    return get_optimizer(plan.optimizer,
                         master_weights=(plan.optimizer == "adamw"
                                         and cfg.param_count() < 3e10))


def _meta_model(cfg: ArchConfig):
    """The model on ``meta`` and its stacked parameter tree (bound)."""
    model = build_model(cfg, device="meta")
    return model, stacked_params(model)


def tree_bytes(t) -> int:
    return sum(x.numel() * x.element_size() for x in tree.leaves(t))


# ---------------------------------------------------------------------------
# per-kind programs: (callable, its meta arguments)
# ---------------------------------------------------------------------------

def build_train_program(cfg, shape, mesh, *, n_micro=None):
    """-> (train_step, (state, batch), plan): the port's step with
    ``default_plan(cfg, shape, dp)`` (``n_micro`` replaced if given) and
    the full state and batch, on ``meta``."""
    model, params = _meta_model(cfg)
    plan = default_plan(cfg, shape, dp_size(mesh))
    if n_micro is not None:
        plan = dataclasses.replace(plan, n_micro=n_micro)
    optimizer = _optimizer(cfg, plan)
    state = {"params": params, "opt": optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="meta")}
    step = make_train_step(model, optimizer, cfg, shape, plan)
    return step, (state, input_specs(cfg, shape)), plan


def build_opt_program(cfg, shape, mesh):
    """-> (update, (params, opt, grads)): the optimizer alone on the full
    parameter tree and f32 gradients, on ``meta``."""
    _, params = _meta_model(cfg)
    optimizer = _optimizer(cfg, default_plan(cfg, shape, dp_size(mesh)))
    grads = tree.map_(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                            device="meta"), params)

    def opt_only(params, opt, grads):
        return optimizer.update(grads, opt, params)

    return opt_only, (params, optimizer.init(params), grads)


def build_prefill_program(cfg, shape, mesh):
    """-> (prefill_step, (params, batch)): the forward over the prompt
    (query chunks of 1024), on ``meta``."""
    model, params = _meta_model(cfg)
    return (make_prefill_step(model, cfg, shape, q_chunk=1024),
            (params, input_specs(cfg, shape)))


def build_decode_program(cfg, shape, mesh):
    """-> (serve_step, (params, caches, token, pos), cache kind): one
    decode token at the cache's last slot, on ``meta``."""
    model, params = _meta_model(cfg)
    kind = cache_kind(cfg, shape)
    b = shape.global_batch
    caches = model.init_caches(b, shape, kind)
    token = torch.empty((b, 1), dtype=torch.int32, device="meta")
    return (make_serve_step(model, cfg, shape, kind),
            (params, caches, token, shape.seq_len - 1), kind)


# ---------------------------------------------------------------------------
# the record
# ---------------------------------------------------------------------------

def _copies(cfg, params, p_specs, mesh) -> tuple[list, list]:
    """What the sharded step copies onto each "model" position of a data
    shard beside its blocks: (a ``{layer: [copy]}`` a position, a
    ``[copy]`` a position of the leaves copied once a step), each copy
    ``(elements, element size, blocks)``, ``blocks`` the leaf's blocks
    the read spans (the gather's group).  A weight computed over "model"
    is read in the position's region (its column or row ranges) gathered
    over "data" (:func:`~repro_torch.train.step.position_members`); one
    computed whole is read whole, on a data shard's first position; a
    read that one block of the leaf's spec holds (a replicated leaf) is
    made in place, with no copy."""
    n_model = mesh.shape.get("model", 1)
    layers, outside = position_members(build_model(cfg, device="meta"),
                                       n_model)
    leaves, specs = dict(tree.items(params)), dict(tree.items(p_specs))

    def copied(path, idx, region):
        leaf, spec = leaves[path], list(specs[path])
        shape = leaf.shape[len(idx):]
        spec = (spec + [None] * leaf.dim())[len(idx):leaf.dim()]
        region = region or tuple(slice(0, n) for n in shape)
        parts = [1 if ax is None else ways(ax, mesh) for ax in spec]
        if all(isinstance(r, slice) and r.stop - r.start == n // k
               and r.start % (n // k) == 0
               for r, n, k in zip(region, shape, parts)):
            return None
        blocks = math.prod(
            len({i for r in (e if isinstance(e, tuple) else (e,))
                 for i in range(r.start // (n // k),
                                (r.stop - 1) // (n // k) + 1)})
            for e, n, k in zip(region, shape, parts))
        return (math.prod(region_shape(region)), leaf.element_size(),
                blocks)

    def kept(copies):
        return [c for c in copies if c is not None]

    per_layer = [{name: kept(copied(path, idx, region)
                             for _, path, idx, region in members[m])
                  for name, members in layers.items()}
                 for m in range(n_model)]
    once = [kept(copied(path, (), (regions or [None] * n_model)[m])
                 for _, path, regions in outside
                 if regions is not None or m == 0)
            for m in range(n_model)]
    return per_layer, once


def _gathered_bytes(copies) -> tuple[int, int]:
    """What the sharded step copies onto a "model" position beside its
    blocks, at the position that copies most (a data shard's first, which
    also computes what is left whole): (the largest layer's copies, the
    once-a-step leaves' copies), from :func:`_copies`."""
    per_layer, once = copies
    layer = max((sum(n * size for n, size, _ in layer_copies)
                 for layers in per_layer for layer_copies in layers.values()),
                default=0)
    return layer, max(sum(n * size for n, size, _ in c) for c in once)


def _collective(copies, mesh, plan, passes: dict) -> dict:
    """The link bytes one chip moves in one step of the sharded trainer
    for its weights, by :func:`~repro_torch.roofline.analysis.ring_bytes`,
    at the "model" position that moves most: each copy of :func:`_copies`
    an all-gather of its bytes over the blocks it spans (a layer's in
    each micro-batch of the data shard, ``passes[group]`` times: twice
    where the remat recompute gathers again; the once-a-step leaves'
    once), and each copy's gradient added into its blocks a
    reduce-scatter of the same elements in ``plan.grad_dtype`` (in each
    micro-batch)."""
    per_layer, once = copies
    micro = plan.n_micro // dp_size(mesh)
    gsize = getattr(torch, plan.grad_dtype).itemsize

    def gathered(cs):
        return sum(ring_bytes("all-gather", n * size, blocks)
                   for n, size, blocks in cs)

    def scattered(cs):
        return sum(ring_bytes("reduce-scatter", n * gsize / blocks, blocks)
                   for n, _, blocks in cs)

    moved = []
    for m, layers in enumerate(per_layer):
        every = [c for cs in layers.values() for c in cs]
        moved.append((m, {
            "all-gather": gathered(once[m]) + micro * sum(
                passes[_group(name)] * gathered(cs)
                for name, cs in layers.items()),
            "reduce-scatter": micro * (scattered(once[m])
                                       + scattered(every))}))
    m, by_op = max(moved, key=lambda mb: sum(mb[1].values()))
    return {"per_chip_bytes": sum(by_op.values()), "by_op": by_op,
            "model_position": m, "micro_batches_per_shard": micro}


def _group(layer: str) -> str:
    """The stacked group of a layer name (``g_blocks.3`` -> ``g_blocks``)."""
    return layer.rsplit(".", 1)[0]


class _RingSplit(ModelSplit):
    """A :class:`~repro_torch.core.model_axis.ModelSplit` of ``n_model``
    ``meta`` positions that adds each collective's per-chip ring bytes
    (:func:`~repro_torch.roofline.analysis.ring_bytes`) to ``ring``
    (``{op: bytes}``) in each pass it runs in: ``from_model`` an
    all-reduce of the f32 partials in the forward (and again where a remat
    recompute runs it); ``to_model`` an all-reduce of the positions' input
    gradients in the backward (its forward reads activations every
    position holds); ``split_model`` (the MoE dispatch) an all-to-all of
    the slices, and in the backward an all-gather of their gradients;
    ``concat_model`` an all-gather of the parts, and in the backward an
    all-to-all of the gradient's slices."""

    def __init__(self, n_model: int, weights=None, ring=None):
        super().__init__(["meta"] * n_model, weights)
        self.ring = {} if ring is None else ring

    def with_weights(self, more: dict) -> "_RingSplit":
        return _RingSplit(len(self.devices), {**self.weights, **more},
                          self.ring)

    def _add(self, op: str, nbytes: float) -> None:
        self.ring[op] = self.ring.get(op, 0.0) + ring_bytes(
            op, nbytes, len(self.devices))

    def _in_backward(self, op: str, t: torch.Tensor) -> None:
        if t.requires_grad:
            nbytes = t.numel() * t.element_size()
            t.register_hook(lambda g: self._add(op, nbytes))

    def to_model(self, x: torch.Tensor) -> tuple:
        self._in_backward("all-reduce", x)
        return super().to_model(x)

    def from_model(self, parts, dtype: torch.dtype) -> tuple:
        self._add("all-reduce", parts[0].numel() * 4)
        return super().from_model(parts, dtype)

    def split_model(self, x: torch.Tensor, dim: int) -> tuple:
        self._add("all-to-all", x.numel() * x.element_size())
        self._in_backward("all-gather", x)
        return super().split_model(x, dim)

    def concat_model(self, parts, dim: int) -> torch.Tensor:
        out = super().concat_model(parts, dim)
        self._add("all-gather", out.numel() * out.element_size())
        self._in_backward("all-to-all", out)
        return out


class _MetaGather:
    """A data shard's ``ctx["gather"]`` on ``meta``, as the sharded step's
    gives it (``gather(layer)`` -> the weights computed whole, and one
    dict a position of the parts, or ``None``): each member of
    ``layers`` (:func:`~repro_torch.train.step.position_members`) a
    ``meta`` tensor of its region's shape, tied to ``anchor`` so that the
    backward runs through every layer; ``calls`` counts each layer's
    gathers."""

    def __init__(self, params, layers: dict):
        self.params, self.layers, self.calls = params, layers, {}
        self.anchor = torch.zeros((), device="meta", requires_grad=True)

    def weight(self, path, idx: tuple, region) -> torch.Tensor:
        leaf = tree.get(self.params, path)
        shape = (leaf.shape[len(idx):] if region is None
                 else region_shape(region))
        return (torch.zeros(shape, dtype=leaf.dtype, device="meta")
                + self.anchor.to(leaf.dtype))

    def __call__(self, name: str):
        self.calls[name] = self.calls.get(name, 0) + 1
        got = [[(m, self.weight(*m[1:])) for m in ms]
               for ms in self.layers[name]]
        whole = {m[0]: t for m, t in got[0] if m[3] is None}
        parts = [{m[0]: t for m, t in pairs if m[3] is not None}
                 for pairs in got]
        return whole, (parts if parts[0] else None)


def _sharded_micro(cfg, shape, mesh, plan) -> tuple:
    """One micro-batch of a data shard's sharded step on ``meta``: the
    model at ``cfg`` computes over the mesh's "model" positions
    (:class:`_MetaGather`, :class:`_RingSplit`) the loss of ``global_batch
    / n_micro`` rows, its forward, remat recompute and backward. -> (the
    per-chip ring bytes by op of the embedding (a VLM's patch columns),
    those of the loss and its gradient, each layer's gathers)."""
    n_model = mesh.shape.get("model", 1)
    model = build_model(cfg, device="meta")
    layers, outside = position_members(model, n_model)
    gather = _MetaGather(stacked_like(cfg), layers)
    weights = {}
    for name, path, regions in outside:
        if regions is not None:
            owner, rel = split_owner(model, name)
            per = weights.setdefault(owner, [{} for _ in regions])
            for part, region in zip(per, regions):
                part[rel] = gather.weight(path, (), region)
    ring: dict = {}
    ctx = model.make_ctx(torch.arange(shape.seq_len + (cfg.n_patches or 0),
                                      device="meta"), q_chunk=plan.q_chunk)
    ctx.update(gather=gather, model_split=_RingSplit(n_model, weights, ring))
    batch = input_specs(cfg, dataclasses.replace(
        shape, global_batch=shape.global_batch // plan.n_micro))
    with torch.no_grad():
        x = model.embed_in(batch, ctx)
    embed = dict(ring)
    ring.clear()
    rest = {k: v for k, v in batch.items() if k not in ("tokens", "patches")}
    loss = model.loss_embedded(x, rest, ctx, remat=plan.remat,
                               aux_weight=plan.aux_weight)
    if "head" in weights.get(model, [{}])[0]:
        # the vocab-parallel loss: each row's max, exp sum and gold logit
        ring["all-reduce"] = ring.get("all-reduce", 0.0) + 3 * ring_bytes(
            "all-reduce", rest["labels"].numel() * 4, n_model)
    torch.autograd.grad(loss, [gather.anchor])
    return embed, dict(ring), gather.calls


def _as_cost(by_op: dict) -> PartCost:
    return PartCost(coll=sum(by_op.values()), coll_by_op=dict(by_op))


def activation_collectives(cfg, shape, mesh, plan, n_super: int) -> dict:
    """What one chip moves over the links in one step for the activations
    of a training cell's sharded step (the row-parallel sums, the
    column-parallel input gradients, the vocab-parallel loss, the MoE
    dispatch and combine, a VLM's patch columns): :func:`_sharded_micro`
    of the 1- and 2-superblock variants, differenced as the FLOPs are
    (stem + n_super x block), times the data shard's micro-batches, and
    the embedding's once a step over the global batch (on the first data
    shard's positions, which move most).  ``passes``: each stacked group's
    gathers of one layer in a micro-batch (2 where the remat recompute
    gathers again: every group but whisper's encoder)."""
    lps = layers_per_step(cfg)
    runs = [_sharded_micro(_variant(cfg, k, lps), shape, mesh, plan)
            for k in (1, 2)]
    blk = _as_cost(runs[1][1]) - _as_cost(runs[0][1])
    step = (_as_cost(runs[0][1]) - blk) + blk.scaled(n_super)
    micro = plan.n_micro // dp_size(mesh)
    total = step.scaled(micro) + _as_cost(runs[0][0]).scaled(plan.n_micro)
    by_op = {op: b for op, b in total.coll_by_op.items() if b}
    return {"per_chip_bytes": sum(by_op.values()), "by_op": by_op,
            "passes": {_group(name): n for name, n in runs[0][2].items()}}


def _memory(cfg, shape, mesh, kind: str, args, plan, copies=None) -> dict:
    """What one device holds: under the reference's rules on ``mesh``
    (``sharded``), in the port's layout (``port``) and with every tree
    whole (``whole``); arguments only, not activations.  A training
    cell's ``port`` is the sharded trainer's: its blocks under the rules
    (parameters, optimizer state, the gradient accumulator in
    ``grad_dtype``), the largest layer a "model" position gathers and the
    leaves it gathers once a step (:func:`_gathered_bytes` of its
    ``copies``).  Serving holds its model whole on one device, so a
    prefill or decode cell's ``port`` is ``whole``; ``whole`` of a
    training cell also counts the f32 gradient sum."""
    params = args[0]["params"] if kind == "train" else args[0]
    p_specs = param_specs(params, mesh)
    sharded, whole = {}, {}
    if kind == "decode" and "embed" in p_specs:
        # no embed gradient at decode: the table splits d over "model"
        p_specs = dict(p_specs, embed=filter_divisible(
            P(None, "model"), params["embed"].shape, mesh))
    sharded["params"] = shard_bytes(params, p_specs, mesh)
    whole["params"] = tree_bytes(params)
    if kind == "train":
        state, batch = args
        opt = state["opt"]
        sharded["opt"] = shard_bytes(opt, opt_state_specs(opt, p_specs,
                                                          mesh), mesh)
        whole["opt"] = tree_bytes(opt)
        gdtype = getattr(torch, plan.grad_dtype)
        acc = tree.map_(lambda p: torch.empty(p.shape, dtype=gdtype,
                                              device="meta"), params)
        sharded["grad_accumulator"] = shard_bytes(acc, grad_specs(params,
                                                                  mesh),
                                                  mesh)
        whole["grad_accumulator"] = tree_bytes(acc)
        whole["grad_sum_f32"] = sum(p.numel() * 4
                                    for p in tree.leaves(params))
    elif kind == "prefill":
        batch = args[1]
    else:
        caches, batch = args[1], {"token": args[2]}
        sharded["caches"] = shard_bytes(
            caches, cache_specs(caches, mesh, shape.global_batch), mesh)
        whole["caches"] = tree_bytes(caches)
    sharded["batch"] = shard_bytes(batch, batch_specs(batch, mesh), mesh)
    whole["batch"] = tree_bytes(batch)
    if kind == "train":
        port = dict(sharded)
        port["gathered_layer"], port["gathered_once"] = _gathered_bytes(
            copies)
    else:
        port = dict(whole)
    for part in (sharded, whole, port):
        part["total"] = sum(part.values())
    card = None
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        card = {"name": props.name, "total_memory": props.total_memory}
    return {"sharded_per_device": sharded, "port_per_device": port,
            "whole_per_device": whole, "card": card,
            "fits": None if card is None else {
                "sharded": sharded["total"] <= card["total_memory"],
                "port": port["total"] <= card["total_memory"]}}


def cluster_attn_flops(cfg: ArchConfig, caches) -> float:
    """The cluster-attention kernel's FLOPs for one decode token over
    ``caches``: 4 B H Nc dh (the logits and the value products) for each
    layer that holds a clustered cache (``kc`` (layers..., B, Hkv, Nc,
    dh))."""
    total = 0.0
    for path, leaf in tree.items(caches):
        if path[-1] == "kc":
            b, _, nc, dh = leaf.shape[-4:]
            layers = math.prod(leaf.shape[:-4])
            total += layers * 4.0 * b * cfg.n_heads * nc * dh
    return total


def cluster_attn_cost(cfg: ArchConfig, caches) -> PartCost:
    """The cluster-attention kernel's cost for one decode token over
    ``caches``, which the counters on ``meta`` cannot see: the FLOPs of
    :func:`cluster_attn_flops` and the kernel's bytes
    (:func:`~repro_torch.roofline.analysis.kernel_cost`) for each layer
    that holds a clustered cache."""
    nbytes = 0.0
    for path, leaf in tree.items(caches):
        if path[-1] == "kc":
            b, hkv, nc, dh = leaf.shape[-4:]
            nbytes += math.prod(leaf.shape[:-4]) * kernel_cost(
                "cluster_attn", dtype_bytes=leaf.element_size(), b=b,
                h=cfg.n_heads, hkv=hkv, nc=nc, dh=dh).bytes
    return PartCost(cluster_attn_flops(cfg, caches), nbytes)


_NO_TRAFFIC = {torch.ops.aten.empty.memory_format,
               torch.ops.aten.empty_strided.default,
               torch.ops.aten.empty_like.default}


class ByteCounterMode(TorchDispatchMode):
    """Adds up the bytes of every tensor input and output of each aten op
    that is not a view (nor an allocation): the counterpart of XLA's
    "bytes accessed".  It counts the ops one by one, before any fusion, so
    it is an upper bound of what a fused program moves."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view and func not in _NO_TRAFFIC:
            self.bytes += sum(
                t.numel() * t.element_size()
                for t in _pytree.tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor))
        return out


def _run(fn, args, count: bool) -> tuple[object, PartCost]:
    """``fn(*args)`` -> (its output, the FLOPs ``FlopCounterMode`` and the
    bytes :class:`ByteCounterMode` counted, or nothing without
    ``count``)."""
    if not count:
        return fn(*args), PartCost()
    with FlopCounterMode(display=False) as fc, ByteCounterMode() as bc:
        out = fn(*args)
    return out, PartCost(float(fc.get_total_flops()), float(bc.bytes))


def _check_output(cfg, shape, kind: str, b: int, out) -> None:
    """The step's output has the shapes the cell expects, or raise."""
    if kind == "train":
        state, metrics = out
        ok = metrics["loss"].shape == () and set(state) == {
            "params", "opt", "step"}
    else:
        logits = out if kind == "prefill" else out[0]
        ok = tuple(logits.shape) == (b, 1, cfg.padded_vocab)
    if not ok:
        raise RuntimeError(f"dry run: the {kind} step of {cfg.name} at "
                           f"{shape.name} returned the wrong shapes")


MEMORY_UPPER = ("upper bound: the inputs and outputs of every op, counted "
                "one op at a time, before any fusion")
FRACTION_LOWER = ("lower bound: over the dominant term, which memory_s's "
                  "upper bound may set; without_memory leaves memory_s out "
                  "(an upper bound where the other terms hold)")

SERVED_WHOLE = ("the port serves its model whole on one card: a prefill "
                "or decode step moves nothing between cards")


def collective(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    """What one chip moves over the links in one step, by op: for a
    training cell's sharded trainer its weights' gathers and gradient
    adds (``weights``, :func:`_collective`, each layer gathered as often
    as :func:`activation_collectives` saw it gathered) and its
    activations' collectives (``activations``); nothing for serving
    (``SERVED_WHOLE``)."""
    if shape.kind != "train":
        return {"per_chip_bytes": 0.0, "by_op": {}, "reason": SERVED_WHOLE}
    plan = default_plan(cfg, shape, dp_size(mesh))
    params = stacked_like(cfg)
    acts = activation_collectives(cfg, shape, mesh, plan, n_steps(params))
    weights = _collective(_copies(cfg, params, param_specs(params, mesh),
                                  mesh), mesh, plan, acts["passes"])
    by_op = {op: weights["by_op"].get(op, 0.0) + acts["by_op"].get(op, 0.0)
             for op in (*weights["by_op"], *acts["by_op"])}
    return {"per_chip_bytes": sum(by_op.values()), "by_op": by_op,
            "weights": weights, "activations": acts}


def account(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    """The cell's full-depth trees on ``meta`` and what one device holds
    of them (:func:`_memory`) -> ``n_super``, ``memory`` and the plan of a
    training cell or the cache kind of a decode cell."""
    kind = shape.kind
    if kind == "train":
        _, args, plan = build_train_program(cfg, shape, mesh)
        fields, params = {"plan": dataclasses.asdict(plan)}, args[0]["params"]
    elif kind == "prefill":
        _, args = build_prefill_program(cfg, shape, mesh)
        plan, fields, params = None, {}, args[0]
    else:
        _, args, ckind = build_decode_program(cfg, shape, mesh)
        plan, fields, params = None, {"cache_kind": ckind}, args[0]
    copies = None
    if kind == "train":
        copies = _copies(cfg, params, param_specs(params, mesh), mesh)
    return {"n_super": n_steps(params), **fields,
            "memory": _memory(cfg, shape, mesh, kind, args, plan, copies)}


def dry_run(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
            with_ab: bool = True) -> dict:
    """One cell's record (see the module docstring) for ``cfg`` at
    ``shape`` on ``mesh`` (an ``AbstractMesh`` or a ``Mesh``: only its
    axis names and sizes are read)."""
    lps = layers_per_step(cfg)
    kind = shape.kind
    t0 = time.perf_counter()
    rec: dict = {"shape": shape.name, "kind": kind, "layers_per_step": lps,
                 "params": cfg.param_count(),
                 "active_params": cfg.active_param_count(),
                 "chips": math.prod(mesh.shape.values()),
                 **account(cfg, shape, mesh),
                 "collective": collective(cfg, shape, mesh)}
    # a training cell's optimizer over the full-depth state, once
    n_micro = rec["plan"]["n_micro"] if kind == "train" else 1
    if kind == "train":
        _, opt_cost = _run(*build_opt_program(cfg, shape, mesh), with_ab)
    # -- the gate: the 1- and 2-superblock variants' steps -----------------
    cost, seconds = {}, {}
    for k in (1, 2):
        cfg_k = _variant(cfg, k, lps)
        t1 = time.perf_counter()
        if kind == "train":
            micro = dataclasses.replace(shape, global_batch=max(
                shape.global_batch // n_micro, dp_size(mesh)))
            fk, ak, _ = build_train_program(cfg_k, micro, mesh, n_micro=1)
            b = micro.global_batch
        elif kind == "prefill":
            fk, ak = build_prefill_program(cfg_k, shape, mesh)
            b = shape.global_batch
        else:
            fk, ak, _ = build_decode_program(cfg_k, shape, mesh)
            b = shape.global_batch
        out, cost[k] = _run(fk, ak, with_ab)
        _check_output(cfg_k, shape, kind, b, out)
        if kind == "decode" and with_ab:
            cost[k] = cost[k] + cluster_attn_cost(cfg_k, ak[1])
        seconds[k] = time.perf_counter() - t1
        del fk, ak, out
    rec["gate"] = {"ran": "meta", "variants": [1, 2],
                   "seconds": [seconds[1], seconds[2]]}
    # -- the A/B differencing and the roofline --------------------------------
    if with_ab:
        blk = cost[2] - cost[1]
        stem = cost[1] - blk
        total = stem + blk.scaled(rec["n_super"])
        parts = {"stem": stem.flops, "block": blk.flops}
        if kind == "train":
            total = total.scaled(n_micro) + opt_cost
            parts.update(opt=opt_cost.flops, n_micro=n_micro)
        coll = rec["collective"]
        total.coll, total.coll_by_op = coll["per_chip_bytes"], coll["by_op"]
        mf, chips = model_flops(cfg, shape, kind), rec["chips"]
        terms = roofline_terms(total, chips)
        dom = dominant_term(terms)
        lean = dict(terms, memory_s=0.0)
        lean_dom = dominant_term(lean)
        rec.update(parts=parts, total_flops=total.flops,
                   model_flops_global=mf,
                   useful_flop_ratio=mf / max(total.flops, 1.0),
                   total_cost=dataclasses.asdict(total), roofline=terms,
                   dominant=dom, model_flops_per_chip=mf / chips,
                   roofline_fraction=(mf / chips / BF16_PEAK)
                   / max(terms[dom], 1e-30),
                   roofline_bounds={
                       "memory_s": MEMORY_UPPER,
                       "roofline_fraction": FRACTION_LOWER,
                       "without_memory": {
                           "dominant": lean_dom,
                           "roofline_fraction": (mf / chips / BF16_PEAK)
                           / max(lean[lean_dom], 1e-30)}})
    rec["seconds"] = time.perf_counter() - t0
    return rec


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             with_ab: bool = True) -> dict:
    """The record of one (arch, shape, mesh) cell at the full config on
    the production mesh (``single``: 16 x 16, ``multi``: 2 x 16 x 16)."""
    mesh = production_mesh_shape(multi_pod=(mesh_name == "multi"))
    rec = dry_run(get_config(arch), SHAPES[shape_name], mesh,
                  with_ab=with_ab)
    return {"arch": arch, "mesh": mesh_name, **rec}


def cell_path(arch, shape_name, mesh_name, out=ART) -> pathlib.Path:
    return pathlib.Path(out) / f"{arch}__{shape_name}__{mesh_name}.json"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-ab", action="store_true",
                    help="skip the FLOP count (the gate still runs)")
    ap.add_argument("--out", default=str(ART),
                    help="the records' directory (default build/dryrun)")
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = args.mesh.split(",")
    failed = 0
    for arch in archs:
        cfg = get_config(arch)
        for sn in shapes:
            ok, note = shape_applicable(cfg, SHAPES[sn])
            for mn in meshes:
                out = cell_path(arch, sn, mn, out_dir)
                if out.exists() and not args.force:
                    print(f"skip (exists): {out.name}")
                    continue
                if not ok:
                    out.write_text(json.dumps(
                        {"arch": arch, "shape": sn, "mesh": mn,
                         "skipped": note}, indent=1))
                    print(f"SKIP {arch} {sn} {mn}: {note}")
                    continue
                print(f"=== {arch} x {sn} x {mn} ===", flush=True)
                try:
                    rec = run_cell(arch, sn, mn,
                                   with_ab=(not args.no_ab
                                            and mn == "single"))
                    out.write_text(json.dumps(rec, indent=1))
                    mem = rec["memory"]
                    print(f"    ok in {rec['seconds']:.1f}s "
                          f"sharded={mem['sharded_per_device']['total']/1e9:.2f}GB "
                          f"port={mem['port_per_device']['total']/1e9:.2f}GB "
                          f"fits={mem['fits']}", flush=True)
                except Exception as e:  # record the failure for triage
                    failed += 1
                    out.with_suffix(".err").write_text(traceback.format_exc())
                    print(f"    FAIL {type(e).__name__}: {e}", flush=True)
    return failed


if __name__ == "__main__":
    raise SystemExit(1 if main() else 0)
