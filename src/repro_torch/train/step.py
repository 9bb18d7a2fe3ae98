"""train_step / prefill_step / serve_step builders (the counterpart of
:mod:`repro.train.step`).

A train state is ``{"params", "opt", "step"}``: ``params`` the reference's
nested tree of stacked leaves (:func:`repro_torch.convert.stacked_params`),
``opt`` the optimizer's state over that tree, ``step`` an int32 0-d
tensor.  ``make_train_step`` produces the update: the embeddings gathered
once a step outside the gradient, microbatched gradient accumulation in
``grad_dtype`` (f32 for dense archs, bf16 for the MoE giants), per-layer
remat, the optional compression hook, then the optimizer.  The state is
updated in place and returned (the reference's jitted step donates it).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import tree
from repro_torch.configs import ArchConfig, ShapeConfig
from repro_torch.convert import bind_stacked, stack_path
from repro_torch.core.distributed import mesh_sum, replicate
from repro_torch.launch.mesh import check_mesh
from repro_torch.models.registry import build_model
from repro_torch.train.sharding import batch_devices


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
    """One shard's part of a step: each micro-batch of ``micros`` (its
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
    through ``compress_fn`` (grads -> grads) and applied by
    ``optimizer.update``.  metrics: ``loss`` (the micro losses' mean) and
    the optimizer's.

    With ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh`) the step is
    data parallel over the W shards of
    :func:`~repro_torch.train.sharding.batch_axis`, in mesh order
    (:func:`~repro_torch.train.sharding.batch_devices`).  The state lives
    on the first shard's device, ``model``'s.  Shard j takes the whole
    micro-batches ``[j n_micro / W, (j + 1) n_micro / W)`` (the rows
    ``batch_specs`` gives it) and runs them on its device's replica of
    the parameters (copied once per distinct device at the start of the
    step, :func:`~repro_torch.core.distributed.replicate`), into its own
    gradient tree, also where two shards share a device.  The shards'
    trees and losses are added in mesh order on the first shard's device
    (``mesh_sum``), so ``compress_fn`` and the optimizer run once, on
    the global gradient.  Whole micro-batches keep every family exact up
    to the order of those additions: an MoE layer's capacity and
    load-balance loss are taken over a whole micro-batch, as in the
    reference.  ``n_micro % W != 0`` raises ``ValueError``; one shard is
    the one-device step bit for bit."""
    devices = [model.device] if mesh is None else batch_devices(
        check_mesh(mesh))
    if plan.n_micro % len(devices):
        raise ValueError(
            f"make_train_step: {plan} splits into {plan.n_micro} "
            f"micro-batches, which the {len(devices)} data shards of "
            f"{mesh} do not divide")
    first = devices[0]
    if model.device != first:
        raise ValueError(f"make_train_step: the model is on {model.device}, "
                         f"the mesh's first data shard on {first}")
    per_shard = plan.n_micro // len(devices)
    replicas = {first: model}     # a model on each other distinct device

    def train_step(state, batch):
        params, n_micro = state["params"], plan.n_micro
        bind_stacked(model, params)
        batch = _on(batch, first)
        with torch.no_grad():
            x_all = model.embed_in(batch)
        rest = {k: v for k, v in batch.items()
                if k not in ("tokens", "patches")}

        def micro(x, i, dev):
            return x.reshape((n_micro, x.shape[0] // n_micro)
                             + x.shape[1:])[i].to(dev)

        # the parameters on each shard's device, copied once per distinct
        # device; a model bound to them on each distinct device
        copies = tree.map_(lambda t: replicate(t, devices), params)
        on_dev = {}                   # device -> (model, params, ctx)
        for j, dev in enumerate(devices):
            if dev in on_dev:
                continue
            p = tree.map_(lambda c: c[j], copies)
            if dev not in replicas:     # storage only: bound just below
                replicas[dev] = build_model(cfg, device="meta").to_empty(
                    device=dev)
            m = replicas[dev]
            bind_stacked(m, p)
            on_dev[dev] = (m, p, _ctx(m, cfg, shape, plan.q_chunk))
        del copies
        parts, losses = [], []
        for j, dev in enumerate(devices):
            m, p, ctx = on_dev[dev]
            idx = range(j * per_shard, (j + 1) * per_shard)
            g, lsum = _accumulate(
                m, p, ctx, plan,
                [(micro(x_all, i, dev),
                  {k: micro(v, i, dev) for k, v in rest.items()})
                 for i in idx])
            parts.append(tree.leaves(g))
            losses.append(lsum)
            del g
        del on_dev, x_all
        paths = [path for path, _ in tree.items(params)]
        summed = []
        for k in range(len(paths)):
            # in place: the sum's own buffer (one shard's f32 sum is not
            # copied)
            total = mesh_sum([leaves[k] for leaves in parts], first)
            for leaves in parts:
                leaves[k] = None
            summed.append(total.div_(n_micro).to(torch.float32))
        del parts
        grads = tree.unflatten(paths, summed)
        del summed
        if compress_fn is not None:  # clustered gradient compression hook
            grads = compress_fn(grads)
        new_params, new_opt, om = optimizer.update(grads, state["opt"],
                                                   params)
        metrics = {"loss": mesh_sum(losses, first) / n_micro, **om}
        return {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}, metrics

    return train_step


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
