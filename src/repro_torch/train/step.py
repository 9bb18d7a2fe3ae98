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


def make_train_step(model, optimizer, cfg: ArchConfig, shape: ShapeConfig,
                    plan: TrainPlan, compress_fn: Optional[Callable] = None
                    ) -> Callable:
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
    the optimizer's."""
    gdtype = getattr(torch, plan.grad_dtype)

    def train_step(state, batch):
        params, n_micro = state["params"], plan.n_micro
        bind_stacked(model, params)
        named = list(model.named_parameters())
        batch = _on(batch, model.device)
        ctx = _ctx(model, cfg, shape, plan.q_chunk)
        with torch.no_grad():
            x_all = model.embed_in(batch)
        rest = {k: v for k, v in batch.items()
                if k not in ("tokens", "patches")}

        def micro(x, i):
            return x.reshape((n_micro, x.shape[0] // n_micro)
                             + x.shape[1:])[i]

        gsum = tree.map_(lambda p: torch.zeros(p.shape, dtype=gdtype,
                                               device=p.device), params)
        acc = [tree.get(gsum, path)[idx]
               for path, idx in (stack_path(n) for n, _ in named)]
        lsum = torch.zeros((), device=model.device)
        for _, p in named:
            p.requires_grad_(True)
        try:
            for i in range(n_micro):
                rest_i = {k: micro(v, i) for k, v in rest.items()}
                loss = model.loss_embedded(micro(x_all, i), rest_i, ctx,
                                           remat=plan.remat,
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
        del acc, x_all
        # in place: the sums' own buffers (an f32 sum is not copied)
        grads = tree.map_(lambda g: g.div_(n_micro).to(torch.float32), gsum)
        del gsum
        if compress_fn is not None:  # clustered gradient compression hook
            grads = compress_fn(grads)
        new_params, new_opt, om = optimizer.update(grads, state["opt"],
                                                   params)
        metrics = {"loss": lsum / n_micro, **om}
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
