"""train_step / prefill_step / serve_step builders (the counterpart of
:mod:`repro.train.step`).

A train state is ``{"params", "opt", "step"}``: ``params`` the reference's
nested tree of stacked leaves (:func:`repro_torch.convert.stacked_params`),
``opt`` the optimizer's state over that tree, ``step`` an int32 0-d
tensor.  Its ``params`` and ``opt`` leaves are whole tensors, or the
blocks of :mod:`repro_torch.core.blocks` (a
:class:`~repro_torch.core.blocks.Sharded` leaf each, laid out by
``param_specs`` and ``opt_state_specs`` of
:mod:`repro_torch.train.sharding`).  ``make_train_step`` produces the
update: the embeddings gathered once a step outside the gradient,
microbatched gradient accumulation in ``grad_dtype`` (f32 for dense
archs, bf16 for the MoE giants), per-layer remat, the optional
compression hook, then the optimizer.  The state is updated in place and
returned (the reference's jitted step donates it).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Optional

import torch
from torch import nn

from repro_torch import tree
from repro_torch.configs import ArchConfig, ShapeConfig
from repro_torch.convert import bind_stacked, stack_path
from repro_torch.core.blocks import (Sharded, add_into, assign, gather,
                                     is_sharded, position_bytes, relayout,
                                     shard)
from repro_torch.core.model_axis import COUNTS as MODEL_AXIS_COUNTS
from repro_torch.core.model_axis import ModelSplit
from repro_torch.launch.mesh import check_mesh
from repro_torch.models.registry import build_model
from repro_torch.train.sharding import (batch_devices, grad_accumulator,
                                        grad_specs, model_positions)


@dataclasses.dataclass(frozen=True)
class TrainPlan:
    """Per-arch training knobs (chosen in configs or by heuristics)."""
    optimizer: str = "adamw"           # adamw | adafactor
    n_micro: int = 16                  # gradient-accumulation steps
    grad_dtype: str = "float32"        # grad accumulation dtype
    remat: bool = True
    q_chunk: int = 2048
    aux_weight: float = 0.01
    grad_compress_levels: int = 0      # >0: clustered grad quantization


def default_plan(cfg: ArchConfig, shape: ShapeConfig, dp_size: int
                 ) -> TrainPlan:
    moe_giant = cfg.param_count() > 1e11
    n_micro = max(1, shape.global_batch // dp_size)
    return TrainPlan(
        optimizer="adafactor" if moe_giant else "adamw",
        n_micro=n_micro,
        grad_dtype="bfloat16" if moe_giant else "float32",
        q_chunk=min(2048, shape.seq_len),
    )


def _ctx(model, cfg: ArchConfig, shape: ShapeConfig, q_chunk: int) -> dict:
    positions = torch.arange(shape.seq_len + (cfg.n_patches or 0),
                             device=model.device)
    return model.make_ctx(positions, q_chunk=q_chunk)


def _on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_loss_fn(model, cfg: ArchConfig, shape: ShapeConfig, plan: TrainPlan
                 ) -> Callable:
    """-> loss_fn(params, batch): ``model.loss`` with ``model`` bound to
    the stacked tree ``params``."""
    def loss_fn(params, mb):
        bind_stacked(model, params)
        return model.loss(_on(mb, model.device),
                          _ctx(model, cfg, shape, plan.q_chunk),
                          remat=plan.remat, aux_weight=plan.aux_weight)
    return loss_fn


def _accumulate(model, params, ctx, plan: TrainPlan, micros) -> tuple:
    """The one-device step's gradient: each micro-batch of ``micros`` (its
    embedded inputs and its other leaves, in order) through
    ``model.loss_embedded`` and its gradient, added into a zeroed tree of
    ``params``' structure in ``plan.grad_dtype``.  -> (that tree, the
    micro losses' sum)."""
    gdtype = getattr(torch, plan.grad_dtype)
    named = list(model.named_parameters())
    gsum = tree.map_(lambda p: torch.zeros(p.shape, dtype=gdtype,
                                           device=p.device), params)
    acc = [tree.get(gsum, path)[idx]
           for path, idx in (stack_path(n) for n, _ in named)]
    lsum = torch.zeros((), device=model.device)
    for _, p in named:
        p.requires_grad_(True)
    try:
        for x, rest in micros:
            loss = model.loss_embedded(x, rest, ctx, remat=plan.remat,
                                       aux_weight=plan.aux_weight)
            gs = torch.autograd.grad(loss, [p for _, p in named],
                                     allow_unused=True)
            for a, g in zip(acc, gs):
                if g is not None:
                    a.add_(g.to(gdtype))
            lsum += loss.detach()
            del loss, gs
    finally:
        for _, p in named:
            p.requires_grad_(False)
    return gsum, lsum


class _LayerGather(torch.autograd.Function):
    """One layer's weights on its "model" positions' devices: the forward
    gathers each position's members (:meth:`_Gatherer.fetch`); the
    backward, position after position in mesh order, cuts each weight's
    gradient into blocks and adds them into the accumulator's
    (:meth:`_Gatherer.give`) and passes nothing on.  ``anchor``, a 0-d
    tensor that requires a gradient, puts the node on the loss's backward
    path."""

    @staticmethod
    def forward(ctx, anchor, gatherers, members):
        ctx.set_materialize_grads(False)
        ctx.gatherers, ctx.members = gatherers, members
        return tuple(g.fetch(m) for g, ms in zip(gatherers, members)
                     for m in ms)

    @staticmethod
    def backward(ctx, *grads):
        it = iter(grads)
        for g, ms in zip(ctx.gatherers, ctx.members):
            for m in ms:
                grad = next(it)
                if grad is not None:
                    g.give(m, grad)
        return None, None, None


def _position_stats(flat: int, device) -> dict:
    return dict(position=flat, device=str(device), micro_batches=0,
                gathers=0, gathered_bytes=0, layer_bytes={}, once_bytes=0,
                max_live_layers=0, live_after=0)


class _Gatherer:
    """One "model" position's gathers on its device: a member ``(name
    within the layer, leaf path, index, region)`` is read from the leaf's
    blocks (its ``region`` only, where the position computes a part of
    it) and its gradient added back into the accumulator's.  ``stats``
    and ``live`` are the counts and the live copies of the mesh position
    it serves (the step points them at each data shard's in turn):
    gathers, the bytes they copied (``layer_bytes``: one gather of each
    layer), and the most layers whose copies were alive at once (1 where
    each layer's copies die with its forward and its backward)."""

    def __init__(self, params, acc, device, gdtype):
        self.params, self.acc, self.device = params, acc, device
        self.gdtype = gdtype
        self.stats: dict = {}
        self.live: list = []
        self.layer = None

    def begin(self, name: str) -> None:
        alive = {n for r, n in self.live if r() is not None}
        self.live[:] = [(r, n) for r, n in self.live if r() is not None]
        self.stats["gathers"] += 1
        self.stats["max_live_layers"] = max(self.stats["max_live_layers"],
                                            len(alive | {name}))
        self.stats["layer_bytes"][name] = 0
        self.layer = name

    def track(self, name: str, tensors) -> None:
        for t in tensors:
            if t._base is None:           # a copy, not a block's view
                self.live.append((weakref.ref(t), name))

    def fetch(self, member) -> torch.Tensor:
        _, path, idx, region = member
        t = gather(tree.get(self.params, path), self.device, idx, region)
        if t._base is None:
            n = t.numel() * t.element_size()
            self.stats["gathered_bytes"] += n
            self.stats["layer_bytes"][self.layer] += n
        return t

    def give(self, member, g: torch.Tensor) -> None:
        _, path, idx, region = member
        add_into(tree.get(self.acc, path), g.to(self.gdtype), idx, region)


class _ShardGather:
    """A data shard's ``ctx["gather"]``: ``gather(layer name)`` ->
    (``{name within the layer: weight}`` that the shard's first position
    computes whole with, and one ``{name: part}`` a position of the
    weights it computes over "model", or ``None`` where none is), all
    positions' through one :class:`_LayerGather`."""

    def __init__(self, gatherers: list, layers: dict, device):
        self.gatherers, self.layers = gatherers, layers
        self.anchor = torch.zeros((), device=device, requires_grad=True)

    def __call__(self, name: str):
        members = self.layers[name]
        for g, ms in zip(self.gatherers, members):
            if ms:
                g.begin(name)
        outs = iter(_LayerGather.apply(self.anchor, self.gatherers, members))
        got = [[(m, next(outs)) for m in ms] for ms in members]
        for g, pairs in zip(self.gatherers, got):
            g.track(name, [t for _, t in pairs])
        whole = {m[0]: t for m, t in got[0] if m[3] is None}
        parts = [{m[0]: t for m, t in pairs if m[3] is not None}
                 for pairs in got]
        return whole, (parts if parts[0] else None)


def position_members(model, n_model: int) -> tuple[dict, list]:
    """What each of a data shard's ``n_model`` "model" positions gathers:
    ``{layer name (g.i): [[(name within it, leaf path, index, region)]
    a position]}`` for each layer of the model's stacked groups, and
    ``[(name, leaf path, [region a position] or None)]`` for its
    unstacked parameters (gathered once a step).  A weight the model
    computes over "model" (``model.split_regions``) is read by every
    position, each its region; any other goes whole (region ``None``) to
    the first position alone."""
    split = getattr(model, "split_regions", lambda n: {})(n_model)
    layers, outside = {}, []
    for name, _ in model.named_parameters():
        path, idx = stack_path(name)
        regions = split.get(name)
        if not idx:
            outside.append((name, path, regions))
            continue
        group, i, rel = name.split(".", 2)
        per = layers.setdefault(f"{group}.{i}", [[] for _ in range(n_model)])
        for m, region in enumerate(regions or [None]):
            per[m].append((rel, path, idx, region))
    return layers, outside


def _split_owner(model, name: str) -> tuple:
    """(the module a split unstacked parameter belongs to, its name
    within it): the block that names its region (zamba2's ``shared``),
    else the model (``head``)."""
    for prefix, blk in model.named_modules():
        if prefix and hasattr(blk, "split_regions") and name.startswith(
                prefix + "."):
            return blk, name[len(prefix) + 1:]
    return model, name


def _bind(model, name: str, t: torch.Tensor) -> nn.Parameter:
    """Make ``t`` model's parameter ``name`` (a new leaf that records its
    gradient, sharing ``t``'s memory)."""
    owner, _, leaf = name.rpartition(".")
    p = nn.Parameter(t, requires_grad=True)
    setattr(model.get_submodule(owner), leaf, p)
    return p


def _same_layout(a, b) -> bool:
    return a.parts == b.parts and a.positions == b.positions


def make_train_step(model, optimizer, cfg: ArchConfig, shape: ShapeConfig,
                    plan: TrainPlan, compress_fn: Optional[Callable] = None,
                    mesh=None) -> Callable:
    """-> train_step(state, batch) -> (state, metrics).

    ``batch`` leaves (numpy or tensors) have leading dim ``global_batch``,
    split as (n_micro, global_batch / n_micro, ...).  The embedding lookup
    (and a VLM's patch projection) runs once, outside the gradient, as the
    reference hoists it out of its accumulation scan: ``embed`` (and
    ``patch_proj``) get a zero gradient unless the head reads the
    embedding (tied).  The batch's other leaves (``labels``, whisper's
    ``frames``) are split the same way and passed to each micro's
    ``loss_embedded``.  Each micro's gradient is added into a tree in
    ``plan.grad_dtype``; the sum over ``n_micro`` is cast to f32, passed
    through ``compress_fn`` (grads -> grads, whole tensors) and applied by
    ``optimizer.update``.  metrics: ``loss`` (the micro losses' mean) and
    the optimizer's.

    Without ``mesh``, on a state of whole tensors, this is the one-device
    step, on ``model``'s device.  With ``mesh`` (a
    :class:`~repro_torch.launch.mesh.Mesh`), or on a state in blocks
    (:mod:`repro_torch.core.blocks`, ``mesh`` or the state's own), the
    step is data parallel over the W shards of
    :func:`~repro_torch.train.sharding.batch_axis`, in mesh order
    (:func:`~repro_torch.train.sharding.batch_devices`), and ``model``
    gives only the configuration.  Shard j takes the whole micro-batches
    ``[j n_micro / W, (j + 1) n_micro / W)`` (the rows ``batch_specs``
    gives it) on its device, so an MoE layer's capacity and load-balance
    loss are taken over a whole micro-batch, as in the reference;
    ``n_micro % W != 0`` raises ``ValueError``.  Each shard computes on
    its M positions along "model" (:func:`position_members`: the weights
    ``model.split_regions`` splits, attention (whisper's self and cross
    attention too) by heads, the dense FFN and llama4's shared expert by
    hidden columns, the MoE experts by expert, the mLSTM, sLSTM and
    Mamba2 blocks by heads, an untied head by vocab columns and a VLM's
    ``patch_proj`` by columns, each position its region; every
    other weight whole on the shard's first position, whose device holds
    the activations).  Each layer's weights are
    gathered onto the positions' devices inside its checkpointed call
    (:func:`~repro_torch.models.lm.gathered_call`), so the backward's
    recompute gathers again and no layer's copies outlive its forward or
    its backward; the unstacked leaves (``embed``, ``head``,
    ``final_ln``, ``patch_proj``, zamba2's ``shared``) are gathered once a
    step, the split ones a region on each position (``patch_proj``'s
    columns project the patches in the hoisted embedding, still outside
    the gradient).  There is one
    accumulator: each gradient is cut into its blocks and each owner adds
    its block, micro-batch after micro-batch and position after position
    in mesh order, and the losses are summed in that order too.  With a
    "model" axis of 1 the loss and global gradient are therefore the
    one-device step's bit for bit for any ``n_micro`` that W divides;
    over "model" the partial products of the row-split weights (``wo``,
    ``w2``, the recurrent blocks' ``down`` and ``out_proj``) and the
    head are added in another order (:mod:`repro_torch.core.model_axis`), as the
    reference's GSPMD step adds them in its own.  The accumulator is in
    the blocks of ``grad_specs`` for a state in blocks (``embed``'s
    sharded although the table is replicated); a state of whole tensors
    is read as one block a leaf, so its accumulator and its update are
    whole, on the state's device, and the whole new state is the
    one-device step's bit for bit.  ``compress_fn`` sees the gradient
    whole on the first shard's device (gathered a leaf at a time) and its
    result is cut back into blocks; the optimizer updates each block on
    its owner's device (``embed`` in its state's blocks, then gathered
    back onto every device that holds the replicated table).
    ``train_step.stats`` holds the last call's accumulator bytes at each
    mesh position (``accumulator_bytes``, for a state in blocks); for
    each mesh position (``positions``, in mesh order) its micro-batches,
    gathers, gathered bytes, the bytes of one gather of each layer
    (``layer_bytes``) and of its once-a-step leaves (``once_bytes``), the
    most layers whose copies were alive at once and the copies alive
    after the backward (``live_after``); the positions' totals (their
    maximum for ``max_live_layers``, the bytes copied on each distinct
    device for ``gathered_bytes``); and the calls and bytes of
    ``from_model``, ``split_model`` and ``concat_model``
    (:class:`~repro_torch.core.model_axis.ModelSplit`)."""
    devices = [model.device] if mesh is None else batch_devices(
        check_mesh(mesh))
    if plan.n_micro % len(devices):
        raise ValueError(
            f"make_train_step: {plan} splits into {plan.n_micro} "
            f"micro-batches, which the {len(devices)} data shards of "
            f"{mesh} do not divide")
    one_device = _one_device_step(model, optimizer, cfg, shape, plan, compress_fn)
    stats = {}

    def train_step(state, batch):
        if mesh is None and not is_sharded(state["params"]):
            return one_device(state, batch)
        return _mesh_step(optimizer, cfg, shape, plan, compress_fn,
                             mesh, stats, state, batch)

    train_step.stats = stats
    return train_step


def _one_device_step(model, optimizer, cfg, shape, plan, compress_fn):
    """The one-device step on a state of whole tensors, ``model`` bound
    to its parameters."""
    def train_step(state, batch):
        params, n_micro = state["params"], plan.n_micro
        bind_stacked(model, params)
        dev = model.device
        batch = _on(batch, dev)
        with torch.no_grad():
            x_all = model.embed_in(batch)
        rest = {k: v for k, v in batch.items()
                if k not in ("tokens", "patches")}
        g, lsum = _accumulate(
            model, params, _ctx(model, cfg, shape, plan.q_chunk), plan,
            [(_micro(x_all, i, n_micro, dev),
              {k: _micro(v, i, n_micro, dev) for k, v in rest.items()})
             for i in range(n_micro)])
        del x_all
        # in place: the sum's own buffer (an f32 sum is not copied)
        grads = tree.map_(lambda t: t.div_(n_micro).to(torch.float32), g)
        del g
        if compress_fn is not None:  # clustered gradient compression hook
            grads = compress_fn(grads)
        new_params, new_opt, om = optimizer.update(grads, state["opt"],
                                                   params)
        metrics = {"loss": lsum / n_micro, **om}
        return {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}, metrics

    return train_step


def _micro(x, i: int, n_micro: int, dev):
    return x.reshape((n_micro, x.shape[0] // n_micro) + x.shape[1:])[i].to(dev)


def _mesh_step(optimizer, cfg, shape, plan, compress_fn, mesh, stats,
               state, batch):
    """One data-parallel step (:func:`make_train_step`) on a state in
    blocks, or of whole tensors read as one block a leaf."""
    params, n_micro = state["params"], plan.n_micro
    blocked = is_sharded(params)
    mesh = mesh if mesh is not None else tree.leaves(params)[0].mesh
    shards = model_positions(mesh)
    if n_micro % len(shards):
        raise ValueError(f"make_train_step: n_micro={n_micro} on the "
                         f"{len(shards)} data shards of {mesh}")
    first, per_shard = shards[0][0][1], n_micro // len(shards)
    n_model = len(shards[0])
    gdtype = getattr(torch, plan.grad_dtype)
    stats.clear()
    stats.update(gathers=0, gathered_bytes=0, max_live_layers=0,
                 live_after=0, **dict.fromkeys(MODEL_AXIS_COUNTS, 0))
    if blocked:
        acc = grad_accumulator(params, mesh, gdtype)
        stats["accumulator_bytes"] = position_bytes(acc, mesh)
    else:
        acc = tree.map_(lambda p: Sharded.whole(torch.zeros(
            p.shape, dtype=gdtype, device=p.device)), params)
        params = tree.map_(Sharded.whole, params)
    positions = {flat: _position_stats(flat, dev)
                 for row in shards for flat, dev in row}
    lives = {flat: [] for flat in positions}

    # for each distinct tuple of a shard's position devices: a model on
    # meta whose unstacked parameters are its first device's whole
    # copies, the parts of the split ones on each position's device, and
    # a gatherer a position
    setups = {}
    for row in shards:
        devs = tuple(dev for _, dev in row)
        if devs in setups:
            continue
        m = build_model(cfg, device="meta")
        layers, outside = position_members(m, n_model)
        bound, parts, weights = [], [], {}
        once = [0] * n_model
        for name, path, regions in outside:
            leaf = tree.get(params, path)
            if regions is None:
                t = gather(leaf, devs[0])
                if t._base is None:
                    once[0] += t.numel() * t.element_size()
                bound.append((path, _bind(m, name, t)))
                continue
            owner, rel = _split_owner(m, name)
            per = weights.setdefault(owner, [{} for _ in devs])
            for k, (dev, region) in enumerate(zip(devs, regions)):
                t = gather(leaf, dev, (), region)
                if t._base is None:
                    once[k] += t.numel() * t.element_size()
                t = t.detach().requires_grad_(True)
                per[k][rel] = t
                parts.append((path, region, t))
        stats["gathered_bytes"] += sum(once)
        gatherers = [_Gatherer(params, acc, dev, gdtype) for dev in devs]
        g = _ShardGather(gatherers, layers, devs[0])
        ctx = _ctx(m, cfg, shape, plan.q_chunk)
        ctx["gather"] = g
        ctx["model_split"] = ModelSplit(devs, weights, stats)
        setups[devs] = (m, bound, parts, g, ctx, once)

    batch = _on(batch, first)
    with torch.no_grad():       # a VLM's patches by patch_proj's columns
        m, *_, ctx, _ = setups[tuple(d for _, d in shards[0])]
        x_all = m.embed_in(batch, ctx)
    rest = {k: v for k, v in batch.items() if k not in ("tokens", "patches")}
    lsum = torch.zeros((), device=first)
    for j, row in enumerate(shards):
        dev = row[0][1]
        m, bound, parts, g, ctx, once = setups[tuple(d for _, d in row)]
        for gath, (flat, _), nbytes in zip(g.gatherers, row, once):
            gath.stats, gath.live = positions[flat], lives[flat]
            positions[flat]["micro_batches"] += per_shard
            positions[flat]["once_bytes"] = nbytes
            positions[flat]["gathered_bytes"] += nbytes
        leaves = [g.anchor] + [p for _, p in bound] + [t for *_, t in parts]
        for i in range(j * per_shard, (j + 1) * per_shard):
            loss = m.loss_embedded(
                _micro(x_all, i, n_micro, dev),
                {k: _micro(v, i, n_micro, dev) for k, v in rest.items()},
                ctx, remat=plan.remat, aux_weight=plan.aux_weight)
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
            gs = iter(gs[1:])
            for path, _ in bound:
                gp = next(gs)
                if gp is not None:
                    add_into(tree.get(acc, path), gp.to(gdtype))
            for path, region, _ in parts:   # leaf after leaf, mesh order
                gp = next(gs)
                if gp is not None:
                    add_into(tree.get(acc, path), gp.to(gdtype), (), region)
            lsum += loss.detach().to(first)
            del loss, gs
    del setups, x_all
    for flat, p in positions.items():
        p["live_after"] = sum(r() is not None for r, _ in lives[flat])
        stats["gathers"] += p["gathers"]
        stats["gathered_bytes"] += p["gathered_bytes"] - p["once_bytes"]
        stats["max_live_layers"] = max(stats["max_live_layers"],
                                       p["max_live_layers"])
        stats["live_after"] += p["live_after"]
    stats["positions"] = [positions[flat] for flat in sorted(positions)]

    grads = tree.map_(lambda a: a.map(
        lambda t: t.div_(n_micro).to(torch.float32)), acc)
    del acc
    if compress_fn is not None:  # on the gradient whole, as the reference's
        items = list(tree.items(grads))
        del grads
        paths, leaves = [path for path, _ in items], []
        for k in range(len(items)):     # a leaf's blocks go as it is whole
            leaves.append(gather(items[k][1], first))
            items[k] = None
        out = compress_fn(tree.unflatten(paths, leaves))
        del leaves
        grads = (tree.map_(lambda t, sp: shard(t, sp, mesh), out,
                           grad_specs(out, mesh)) if blocked
                 else tree.map_(Sharded.whole, out))
        del out
    # the update in the gradient's blocks: a parameter laid out otherwise
    # (the replicated embed table) is cut into them, then written back
    paths, upd, relaid = [], [], {}
    for (path, p), gl in zip(tree.items(params), tree.leaves(grads)):
        if not _same_layout(p, gl):
            p = relaid[path] = relayout(p, gl)
        paths.append(path)
        upd.append(p)
    _, new_opt, om = optimizer.update(grads, state["opt"],
                                      tree.unflatten(paths, upd))
    del upd
    for path, p_u in relaid.items():
        assign(tree.get(params, path), p_u)
    metrics = {"loss": lsum / n_micro, **om}
    return {"params": params if blocked else state["params"], "opt": new_opt,
            "step": state["step"] + 1}, metrics


def make_prefill_step(model, cfg: ArchConfig, shape: ShapeConfig,
                      q_chunk: int = 1024) -> Callable:
    """-> prefill_step(params, batch): next-token logits of a full forward
    over the prompt (no remat, no gradient)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        bind_stacked(model, params)
        logits, _ = model.forward(_on(batch, model.device),
                                  _ctx(model, cfg, shape, q_chunk),
                                  remat=False, last_only=True)
        return logits

    return prefill_step


def make_serve_step(model, cfg: ArchConfig, shape: ShapeConfig, kind: str
                    ) -> Callable:
    """-> serve_step(params, caches, token, pos): one-token decode against
    a ``kind`` cache of ``shape.seq_len``."""
    def serve_step(params, caches, token, pos):
        bind_stacked(model, params)
        return model.decode_step(token, caches, pos, cache_kind=kind)

    return serve_step
