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
tree whole,
``fits`` against the visible card's memory (``null`` with no card), and,
on the single-pod mesh unless ``--no-ab``, the FLOPs
of ``torch.utils.flop_counter.FlopCounterMode`` assembled by the
reference's A/B differencing: stem + n_super x block (x n_micro) +
optimizer, the cluster attention's 4 B H Nc dh a layer added from its
formula, against the analytic ``model_flops``.  No roofline time is
given: the reference's are TPU constants.

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
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree
from repro_torch.configs import (ARCH_IDS, SHAPES, ArchConfig, ShapeConfig,
                                 get_config, shape_applicable)
from repro_torch.convert import stacked_params
from repro_torch.core.blocks import region_shape, ways
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models.registry import build_model, cache_kind, input_specs
from repro_torch.optim import get_optimizer
from repro_torch.train.sharding import (P, batch_specs, cache_specs, dp_size,
                                        filter_divisible, grad_specs,
                                        opt_state_specs, param_specs,
                                        shard_bytes)
from repro_torch.train.step import (TrainPlan, default_plan,
                                    make_prefill_step, make_serve_step,
                                    make_train_step, position_members)

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


def model_flops(cfg: ArchConfig, shape: ShapeConfig, kind: str) -> float:
    """Analytic MODEL_FLOPS (``repro.roofline.analysis.model_flops``):
    6 N D for training, 2 N S B for prefill, 2 N B for a decode step, with
    N the active parameters."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if kind == "train":
        return 6.0 * n_active * tokens
    if kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch


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

def _gathered_bytes(cfg, params, p_specs, mesh) -> tuple[int, int]:
    """What the sharded step copies onto a "model" position beside its
    blocks, at the position that copies most (a data shard's first, which
    also computes what is left whole): (the largest layer's copies, the
    once-a-step leaves' copies).  A weight computed over "model" is read
    in the position's region (its column or row ranges) gathered over
    "data" (:func:`~repro_torch.train.step.position_members`); one
    computed whole is read whole; a read that one block of the leaf's
    spec holds (a replicated leaf) is made in place, with no copy."""
    n_model = mesh.shape.get("model", 1)
    layers, outside = position_members(build_model(cfg, device="meta"),
                                       n_model)
    leaves, specs = dict(tree.items(params)), dict(tree.items(p_specs))

    def copied(path, idx, region) -> int:
        leaf, spec = leaves[path], list(specs[path])
        shape = leaf.shape[len(idx):]
        spec = (spec + [None] * leaf.dim())[len(idx):leaf.dim()]
        region = region or tuple(slice(0, n) for n in shape)
        parts = [1 if ax is None else ways(ax, mesh) for ax in spec]
        if all(isinstance(r, slice) and r.stop - r.start == n // k
               and r.start % (n // k) == 0
               for r, n, k in zip(region, shape, parts)):
            return 0
        return math.prod(region_shape(region)) * leaf.element_size()

    layer = [max((sum(copied(path, idx, region)
                      for _, path, idx, region in members[m])
                  for members in layers.values()), default=0)
             for m in range(n_model)]
    once = [sum(copied(path, (), (regions or [None] * n_model)[m])
                for _, path, regions in outside
                if regions is not None or m == 0)
            for m in range(n_model)]
    return max(layer), max(once)


def _memory(cfg, shape, mesh, kind: str, args, plan) -> dict:
    """What one device holds: under the reference's rules on ``mesh``
    (``sharded``), in the port's layout (``port``) and with every tree
    whole (``whole``); arguments only, not activations.  A training
    cell's ``port`` is the sharded trainer's: its blocks under the rules
    (parameters, optimizer state, the gradient accumulator in
    ``grad_dtype``), the largest layer a "model" position gathers and the
    leaves it gathers once a step (:func:`_gathered_bytes`).  Serving holds its
    model whole on one device, so a prefill or decode cell's ``port`` is
    ``whole``; ``whole`` of a training cell also counts the f32 gradient
    sum."""
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
            cfg, params, p_specs, mesh)
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


def _run(fn, args, count: bool) -> tuple[object, float]:
    """``fn(*args)`` -> (its output, the FLOPs FlopCounterMode counted, or
    0 without ``count``)."""
    if not count:
        return fn(*args), 0.0
    with FlopCounterMode(display=False) as fc:
        out = fn(*args)
    return out, float(fc.get_total_flops())


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


def account(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    """The cell's full-depth trees on ``meta`` and what one device holds
    of them (:func:`_memory`): -> ``n_super``, ``memory`` and the plan of
    a training cell or the cache kind of a decode cell."""
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
    return {"n_super": n_steps(params), **fields,
            "memory": _memory(cfg, shape, mesh, kind, args, plan)}


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
                 **account(cfg, shape, mesh)}
    # a training cell's optimizer over the full-depth state, once
    n_micro = rec["plan"]["n_micro"] if kind == "train" else 1
    if kind == "train":
        _, opt_flops = _run(*build_opt_program(cfg, shape, mesh), with_ab)
    # -- the gate: the 1- and 2-superblock variants' steps -----------------
    flops, seconds = {}, {}
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
        out, flops[k] = _run(fk, ak, with_ab)
        _check_output(cfg_k, shape, kind, b, out)
        if kind == "decode":
            flops[k] += cluster_attn_flops(cfg_k, ak[1]) if with_ab else 0.0
        seconds[k] = time.perf_counter() - t1
        del fk, ak, out
    rec["gate"] = {"ran": "meta", "variants": [1, 2],
                   "seconds": [seconds[1], seconds[2]]}
    # -- the A/B differencing ------------------------------------------------
    if with_ab:
        blk = flops[2] - flops[1]
        stem = flops[1] - blk
        total = stem + blk * rec["n_super"]
        parts = {"stem": stem, "block": blk}
        if kind == "train":
            total = total * n_micro + opt_flops
            parts.update(opt=opt_flops, n_micro=n_micro)
        mf = model_flops(cfg, shape, kind)
        rec.update(parts=parts, total_flops=total, model_flops_global=mf,
                   useful_flop_ratio=mf / max(total, 1.0))
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
