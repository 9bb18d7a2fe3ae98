"""Atomic, step-tagged checkpoints of a train state (the counterpart of
:mod:`repro.ckpt.checkpoint`, in its layout).

Layout: ``<dir>/step_<n:08d>/arrays.npz`` plus ``manifest.json`` (``step``,
``time``, the sorted ``keys``, ``extra``).  A checkpoint is written into a
``.tmp_step_*`` directory and committed by renaming it, so only complete
steps are ever listed: a write cut short leaves nothing the trainer
restores.  Keys are the state's paths joined by ``/`` (``params/embed``,
``params/g_blocks/attn/wq``, ``opt/m/...``, ``opt/fac/.../vr``,
``step``), leaves in the reference's stacked shapes, so each package
reads the other's f32 checkpoints.

A bf16 leaf is stored as the reference stores it: numpy has no bf16, and
``np.savez`` writes the 2-byte bit pattern as a ``|V2`` array.  The port
reads such a leaf back bit for bit, from its own files and the
reference's (the reference cannot restore them itself: numpy finds no cast
from ``|V2``).
"""
from __future__ import annotations

import json
import pathlib
import shutil
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.device import resolve_device
from repro_torch.core.blocks import Sharded, gather, shard

_BF16_BITS = np.dtype("V2")


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host array (a CPU tensor's own memory); a bf16 tensor as
    its ``|V2`` bit pattern."""
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_BITS)
    return t.numpy()


def from_numpy(a) -> torch.Tensor:
    """A CPU tensor of ``a``: a ``|V2`` array (or an ``ml_dtypes``
    bfloat16 one) as the bf16 values of its bits."""
    a = np.asarray(a)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a)
    if a.dtype == _BF16_BITS or a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save(ckpt_dir, step: int, state, *,
         extra: Optional[dict] = None) -> pathlib.Path:
    """Write ``state`` (a nested dict of tensors, or of the blocks of
    :mod:`repro_torch.core.blocks`, each leaf gathered to the host in
    turn) as step ``step`` and commit it; a step written before is
    replaced.  -> the step's directory."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}_{int(time.time() * 1e6)}"
    tmp.mkdir(parents=True, exist_ok=True)
    arrays = {tree.key_of(p): to_numpy(gather(leaf, "cpu") if isinstance(
        leaf, Sharded) else leaf) for p, leaf in tree.items(state)}
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": sorted(arrays.keys()),
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic commit
    return final


def steps(ckpt_dir) -> list[int]:
    """The complete steps under ``ckpt_dir``, in order."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    out = []
    if not ckpt_dir.exists():
        return out
    for d in ckpt_dir.iterdir():
        if d.name.startswith("step_") and (d / "manifest.json").exists():
            out.append(int(d.name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir) -> Optional[int]:
    s = steps(ckpt_dir)
    return s[-1] if s else None


def restore(ckpt_dir, step: int, like, *,
            device: "torch.device | str | None" = None, specs=None,
            mesh=None) -> tuple[Any, dict]:
    """Step ``step`` in the structure of ``like`` (a nested dict of
    tensors, on the ``meta`` device for shapes alone), each leaf in its
    ``like`` leaf's dtype, on ``device`` (``None``: the ``like`` leaf's
    device, or the CUDA device for a ``meta`` leaf).  With ``specs`` (a
    tree of partition specs over some of ``like``'s subtrees, e.g. a
    train state's ``params`` and ``opt``) and ``mesh``, each of those
    leaves is cut from the host straight into its blocks on ``mesh``
    (:func:`repro_torch.core.blocks.shard`).  Keys the checkpoint
    holds beyond ``like``'s are not read.  -> (state, manifest)."""
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat_like = {tree.key_of(p): leaf for p, leaf in tree.items(like)}
    missing = set(flat_like) - set(manifest["keys"])
    if missing:
        raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")
    paths, values = [], []
    with np.load(d / "arrays.npz") as data:
        for path, leaf in tree.items(like):
            key = tree.key_of(path)
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {arr.shape} != "
                                 f"{tuple(leaf.shape)}")
            spec = _spec_at(specs, path)
            host = from_numpy(arr)
            if spec is not None:
                values.append(shard(host.to(leaf.dtype), spec, mesh))
            else:
                dev = (device if device is not None else None
                       if leaf.device.type == "meta" else leaf.device)
                values.append(host.to(resolve_device(dev), leaf.dtype))
            paths.append(path)
            del host, arr
    return tree.unflatten(paths, values), manifest


def _spec_at(specs, path: tuple):
    """The spec at ``path`` of ``specs``, or ``None`` where it has
    none."""
    node = specs
    for key in path:
        if not isinstance(node, dict) or key not in node:
            return None
        node = node[key]
    return node


def restore_latest(ckpt_dir, like, *, device=None):
    """:func:`restore` of the newest complete step; ``(None, None)``
    where there is none."""
    s = latest_step(ckpt_dir)
    if s is None:
        return None, None
    return restore(ckpt_dir, s, like, device=device)
