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
from repro_torch.launch.mesh import check_mesh
from repro_torch.models.registry import build_model
from repro_torch.train.sharding import (batch_devices, grad_accumulator,
                                        grad_specs)


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
    """One layer's weights on the computing device: the forward gathers
    each from its blocks (:func:`~repro_torch.core.blocks.gather`);
    the backward cuts each weight's gradient into blocks and adds them
    into the accumulator's (:func:`~repro_torch.core.blocks.add_into`)
    and passes nothing on.  ``anchor``, a 0-d tensor that requires a
    gradient, puts the node on the loss's backward path."""

    @staticmethod
    def forward(ctx, anchor, gatherer, members):
        ctx.set_materialize_grads(False)
        ctx.gatherer, ctx.members = gatherer, members
        return tuple(gatherer.fetch(m) for m in members)

    @staticmethod
    def backward(ctx, *grads):
        for m, g in zip(ctx.members, grads):
            if g is not None:
                ctx.gatherer.give(m, g)
        return None, None, None


class _Gatherer:
    """A sharded step's ``ctx["gather"]`` on one computing device:
    ``gatherer(layer name)`` -> ``{name within the layer: weight}``,
    through :class:`_LayerGather`.  ``stats`` counts the gathers and the
    bytes they copied, and the most layers whose copies were alive at
    once (1 where each layer's copies die with its forward and its
    backward)."""

    def __init__(self, params, acc, device, gdtype, layers: dict, stats,
                 live: list):
        self.params, self.acc, self.device = params, acc, device
        self.gdtype, self.layers = gdtype, layers
        self.stats, self.live = stats, live
        self.anchor = torch.zeros((), device=device, requires_grad=True)

    def __call__(self, name: str) -> dict:
        members = self.layers[name]
        alive = {n for r, n in self.live if r() is not None}
        self.live[:] = [(r, n) for r, n in self.live if r() is not None]
        self.stats["gathers"] += 1
        self.stats["max_live_layers"] = max(self.stats["max_live_layers"],
                                            len(alive | {name}))
        outs = _LayerGather.apply(self.anchor, self, members)
        for t in outs:
            if t._base is None:           # a copy, not a block's view
                self.live.append((weakref.ref(t), name))
        return {rel: t for (rel, _, _), t in zip(members, outs)}

    def fetch(self, member) -> torch.Tensor:
        _, path, idx = member
        t = gather(tree.get(self.params, path), self.device, idx)
        if t._base is None:
            self.stats["gathered_bytes"] += t.numel() * t.element_size()
        return t

    def give(self, member, g: torch.Tensor) -> None:
        _, path, idx = member
        add_into(tree.get(self.acc, path), g.to(self.gdtype), idx)


def _layer_members(model) -> tuple[dict, list]:
    """{layer name (``g.i``): [(name within it, leaf path, index)]} for
    each layer of the model's stacked groups, and the model's unstacked
    parameters [(name, leaf path)]: the leaves gathered once a step."""
    layers, outside = {}, []
    for name, _ in model.named_parameters():
        path, idx = stack_path(name)
        if not idx:
            outside.append((name, path))
            continue
        group, i, rel = name.split(".", 2)
        layers.setdefault(f"{group}.{i}", []).append((rel, path, idx))
    return layers, outside


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
    ``n_micro % W != 0`` raises ``ValueError``.  Each layer's weights are
    gathered onto the computing device inside its checkpointed call
    (:func:`~repro_torch.models.lm.gathered_call`), so the backward's
    recompute gathers again and no whole layer outlives its forward or
    its backward; the unstacked leaves (``embed``, ``head``,
    ``final_ln``, ``patch_proj``, zamba2's ``shared``) are gathered once a
    step on each computing device.  There is one accumulator: each
    gradient is cut into its blocks and each owner adds its block,
    micro-batch after micro-batch in order, and the losses are summed in
    that order too, so loss and global gradient are the one-device step's
    bit for bit for any ``n_micro`` that W divides.  The accumulator is in
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
    mesh position (``accumulator_bytes``, for a state in blocks), its
    gathers, gathered bytes, the most layers whose copies were alive at
    once and the copies alive after the backward (``live_after``)."""
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
    devices = batch_devices(mesh)
    if n_micro % len(devices):
        raise ValueError(f"make_train_step: n_micro={n_micro} on the "
                         f"{len(devices)} data shards of {mesh}")
    first, per_shard = devices[0], n_micro // len(devices)
    gdtype = getattr(torch, plan.grad_dtype)
    stats.clear()
    stats.update(gathers=0, gathered_bytes=0, max_live_layers=0)
    if blocked:
        acc = grad_accumulator(params, mesh, gdtype)
        stats["accumulator_bytes"] = position_bytes(acc, mesh)
    else:
        acc = tree.map_(lambda p: Sharded.whole(torch.zeros(
            p.shape, dtype=gdtype, device=p.device)), params)
        params = tree.map_(Sharded.whole, params)
    live: list = []

    # on each distinct device: a model on meta whose unstacked parameters
    # are that device's whole copies, and its per-layer gatherer
    on_dev = {}
    for dev in dict.fromkeys(devices):
        m = build_model(cfg, device="meta")
        layers, outside = _layer_members(m)
        bound = []
        for name, path in outside:
            t = gather(tree.get(params, path), dev)
            if t._base is None:
                stats["gathered_bytes"] += t.numel() * t.element_size()
            bound.append((path, _bind(m, name, t)))
        g = _Gatherer(params, acc, dev, gdtype, layers, stats, live)
        ctx = _ctx(m, cfg, shape, plan.q_chunk)
        ctx["gather"] = g
        on_dev[dev] = (m, bound, g, ctx)

    batch = _on(batch, first)
    with torch.no_grad():
        x_all = on_dev[first][0].embed_in(batch)
    rest = {k: v for k, v in batch.items() if k not in ("tokens", "patches")}
    lsum = torch.zeros((), device=first)
    for j, dev in enumerate(devices):
        m, bound, g, ctx = on_dev[dev]
        for i in range(j * per_shard, (j + 1) * per_shard):
            loss = m.loss_embedded(
                _micro(x_all, i, n_micro, dev),
                {k: _micro(v, i, n_micro, dev) for k, v in rest.items()},
                ctx, remat=plan.remat, aux_weight=plan.aux_weight)
            gs = torch.autograd.grad(loss, [g.anchor] + [p for _, p in bound],
                                     allow_unused=True)
            for (path, _), gp in zip(bound, gs[1:]):
                if gp is not None:
                    add_into(tree.get(acc, path), gp.to(gdtype))
            lsum += loss.detach().to(first)
            del loss, gs
    del on_dev, x_all
    stats["live_after"] = sum(r() is not None for r, _ in live)

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
