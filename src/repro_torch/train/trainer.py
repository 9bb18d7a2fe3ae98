"""Trainer: the fault-tolerant loop around train_step (the counterpart of
:mod:`repro.train.trainer`).

  * checkpoints are atomic and step-tagged (:mod:`repro_torch.ckpt`); on
    start the trainer restores the newest complete step;
  * the data stream is stateless in (seed, step): replay needs no
    iterator snapshot;
  * the loop tracks its step times and logs a step that takes over 3x the
    rolling p95 (a straggler).

The trainer takes a mesh of any size and holds its state in the block
layout of the reference's partition rules on it
(:mod:`repro_torch.train.sharding`: parameters by ``param_specs``,
optimizer state by ``opt_state_specs``; the step's one gradient
accumulator by ``grad_specs``), as the reference's trainer places its
state with ``NamedSharding``s.  Its step (:func:`make_train_step`) is
data parallel over the mesh's batch axes (``sharding.batch_axis``:
"data", or "pod" and "data"), whole micro-batches to a shard, each
layer gathered onto the shard's device inside its checkpointed call; its
plan is ``default_plan(cfg, shape, dp)`` with dp the number of data
shards, as the reference's.  The devices of a "model" axis hold their
blocks, and the computing stays on the data shards' devices (no tensor
parallelism), so the result is the reference's whatever that axis's
size.  A checkpoint holds the state whole (:mod:`repro_torch.ckpt`, each
leaf gathered to the host in turn), and a restore cuts each leaf into
the blocks of the mesh it runs on, so a checkpoint written on one mesh
restores on any other bit for bit (the reference's elastic rescale).  It
trains the decoder-only families: its batches are ``tokens`` and
``labels``, and the reference's trainer cannot feed whisper's
``frames`` either (its batch shardings and its default ``token_stream``
name only the two).  Whisper trains through
:func:`repro_torch.train.step.make_train_step` with a batch from
:func:`repro_torch.models.registry.batch_like`.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import shutil
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import ArchConfig, ShapeConfig
from repro_torch.convert import stack_path, stacked_like
from repro_torch.core.blocks import position_bytes, shard
from repro_torch.core.device import seed_of
from repro_torch.data.synthetic import token_stream
from repro_torch.launch.mesh import Mesh, check_mesh
from repro_torch.models.lm import draw, initial_fill
from repro_torch.models.registry import build_model
from repro_torch.optim import get_optimizer
from repro_torch.train.sharding import batch_devices, state_specs
from repro_torch.train.step import TrainPlan, default_plan, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    log_every: int = 10
    seed: int = 0
    keep_last: int = 3


class Trainer:
    def __init__(self, cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh,
                 tcfg: TrainerConfig, plan: Optional[TrainPlan] = None,
                 batch_fn: Optional[Callable] = None):
        if cfg.family == "audio":
            raise ValueError(
                f"Trainer: {cfg.name} needs its batch's frames, which the "
                f"trainer's token batches lack (as the reference's); train "
                f"it with train.step.make_train_step and a "
                f"models.registry.batch_like batch")
        self.cfg, self.shape, self.tcfg = cfg, shape, tcfg
        self.mesh = check_mesh(mesh)
        shards = batch_devices(self.mesh)
        self.device = shards[0]
        self.model = build_model(cfg, device="meta")
        self.plan = plan or default_plan(cfg, shape, len(shards))
        self.optimizer = get_optimizer(
            self.plan.optimizer,
            master_weights=(self.plan.optimizer == "adamw"
                            and cfg.param_count() < 3e10))
        self.batch_fn = batch_fn or (lambda step: token_stream(
            step, shape.global_batch, shape.seq_len, cfg.vocab,
            seed=tcfg.seed))
        self.train_step = make_train_step(self.model, self.optimizer, cfg,
                                          shape, self.plan, mesh=mesh)

    # -- state ---------------------------------------------------------------
    def state_like(self) -> dict:
        """The train state's structure, shapes and dtypes, on ``meta``."""
        params = stacked_like(self.cfg)
        return {"params": params, "opt": self.optimizer.init(params),
                "step": torch.zeros((), dtype=torch.int32, device="meta")}

    def specs(self) -> dict:
        """The specs of the state's ``params`` and ``opt`` on the mesh."""
        return state_specs(self.state_like(), self.mesh)

    def init_state(self) -> dict:
        """Weights from ``tcfg.seed`` (what ``init_params`` draws, on the
        first shard's device), the optimizer's initial state, step 0, in
        the blocks of :meth:`specs`.  One leaf at a time: drawn whole, its
        optimizer state made from it, both cut into blocks and freed, so
        no device holds more than its blocks and one leaf's state."""
        like, specs, mesh = self.state_like(), self.specs(), self.mesh
        draws = {id(w): (i, scale)
                 for i, (w, scale) in enumerate(self.model.draws())}
        members: dict = {}
        for name, p in self.model.named_parameters():
            path, idx = stack_path(name)
            members.setdefault(path, []).append((idx, name, p))
        base = seed_of(self.tcfg.seed)
        out = {"params": {}, "opt": {}}
        for path, leaf in tree.items(like["params"]):
            whole = torch.empty(leaf.shape, dtype=leaf.dtype,
                                device=self.device)
            for idx, name, p in members[path]:
                if id(p) in draws:
                    draw(whole[idx], base, *draws[id(p)])
                else:
                    whole[idx].fill_(initial_fill(self.model, name))
            out["params"][path] = shard(whole, tree.get(specs["params"],
                                                        path), mesh)
            opt = self.optimizer.init(tree.unflatten([path], [whole]))
            del whole
            for opath, t in tree.items(opt):      # "step" from the first
                if opath not in out["opt"]:
                    out["opt"][opath] = shard(t, tree.get(specs["opt"],
                                                          opath), mesh)
            del opt
        state = {k: tree.unflatten(list(v), list(v.values()))
                 for k, v in out.items()}
        state["step"] = torch.zeros((), dtype=torch.int32,
                                    device=self.device)
        return state

    def position_bytes(self, state) -> dict:
        """The bytes each mesh position holds of ``state``'s ``params``
        and ``opt`` (int arrays of the mesh's shape; each equals
        ``sharding.shard_bytes`` of its tree, specs and mesh)."""
        return {k: position_bytes(state[k], self.mesh)
                for k in ("params", "opt")}

    def restore_or_init(self):
        """-> (state, step): the newest complete checkpoint of
        ``tcfg.ckpt_dir`` cut into the blocks of this mesh, else
        :meth:`init_state` at step 0."""
        step = ckpt.latest_step(self.tcfg.ckpt_dir)
        if step is None:
            return self.init_state(), 0
        state, _ = ckpt.restore(self.tcfg.ckpt_dir, step, self.state_like(),
                                device=self.device, specs=self.specs(),
                                mesh=self.mesh)
        print(f"[trainer] restored step {step} from {self.tcfg.ckpt_dir}")
        return state, step

    # -- loop ----------------------------------------------------------------
    def run(self):
        tc = self.tcfg
        state, start = self.restore_or_init()
        times = []
        history = []
        for step in range(start, tc.steps):
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in self.batch_fn(step).items()}
            t0 = time.time()
            state, metrics = self.train_step(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            times.append(dt)
            history.append(loss)
            if len(times) > 20 and dt > 3.0 * float(np.percentile(times, 95)):
                print(f"[straggler-watch] step {step} took {dt:.2f}s "
                      f"(p95={np.percentile(times, 95):.2f}s)")
            if (step + 1) % tc.log_every == 0:
                print(f"step {step + 1:5d} loss {loss:.4f} "
                      f"({dt * 1e3:.0f} ms)", flush=True)
            if (step + 1) % tc.ckpt_every == 0 or step + 1 == tc.steps:
                ckpt.save(tc.ckpt_dir, step + 1, state)
                self._gc_ckpts()
        return state, history

    def _gc_ckpts(self):
        all_steps = ckpt.steps(self.tcfg.ckpt_dir)
        for s in all_steps[: -self.tcfg.keep_last]:
            shutil.rmtree(pathlib.Path(self.tcfg.ckpt_dir) / f"step_{s:08d}",
                          ignore_errors=True)
