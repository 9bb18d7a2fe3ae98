"""Carry state across from the JAX package to the port.

A clustering system's "weights" are its spec and its fitted centers, and
for the IVF/PQ index its quantizers and inverted lists.  The JAX package
serialises a spec with ``to_dict()`` and its results are arrays; here those
become the port's objects, so a fit made with the JAX package serves
``predict``/``transform``/``score`` from the port, and an index built with
it serves ``search``.  A language model's parameter tree becomes the state
dict of the port's model (:func:`lm_params_from_jax`), and a
streaming clusterer's state continues in the port
(:func:`stream_state_from_jax`).  Only plain Python and numpy cross over:
nothing here imports the JAX package.

Training keeps the reference's layout: a train state's parameters,
gradients and optimizer moments are the reference's nested tree of
stacked leaves (:func:`lm_params_to_stacked`), which the optimizers, the
gradient compressor and the checkpoint see whole, and a model's per-layer
parameters are views into it (:func:`bind_stacked`).  A reference train
state continues in the port (:func:`train_state_from_jax`).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch import tree
from repro_torch.api import SampledKMeans
from repro_torch.core.device import resolve_device
from repro_torch.core.pipeline import SampledClusteringResult
from repro_torch.core.spec import ClusterSpec
from repro_torch.index import IndexSpec, IVFIndex
from repro_torch.stream.engine import StreamState


def spec_from_reference(d: Mapping[str, Any]) -> ClusterSpec:
    """The port's spec for a dict from the JAX package's
    ``ClusterSpec.to_dict()`` (the two share one JSON form, so
    ``stable_hash()`` agrees)."""
    return ClusterSpec.from_dict(d)


def result_from_numpy(centers, sse, local_centers, local_weights, n_dropped,
                      *, device: "torch.device | str | None" = None
                      ) -> SampledClusteringResult:
    """A :class:`SampledClusteringResult` on ``device`` (``None``: the CUDA
    device) from the arrays of a JAX-package result (``np.asarray`` of each
    field, in field order)."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), device=dev)

    return SampledClusteringResult(t(centers), t(sse), t(local_centers),
                                   t(local_weights), t(n_dropped))


def estimator_from_numpy(spec_dict: Mapping[str, Any], centers, *,
                         device: "torch.device | str | None" = None
                         ) -> SampledKMeans:
    """A fitted :class:`SampledKMeans` on ``device`` from a JAX-package
    spec dict and its fitted (k, d) centers: ``predict``, ``transform``
    and ``score`` work at once (``sse_``/``result_`` stay unset)."""
    est = SampledKMeans(spec_from_reference(spec_dict), device=device)
    c = torch.as_tensor(np.array(centers), device=est.device)
    if c.dim() != 2 or c.shape[0] != est.spec.merge.k:
        raise ValueError(f"estimator_from_numpy: centers must be "
                         f"(k={est.spec.merge.k}, d), got {tuple(c.shape)}")
    est.centers_ = c
    return est


def index_from_jax(spec_dict: Mapping[str, Any], coarse_centers, codebooks,
                   codes, ids, counts, *,
                   device: "torch.device | str | None" = None) -> IVFIndex:
    """The port's :class:`IVFIndex` on ``device`` (``None``: the CUDA
    device) from a JAX-package index: its ``IndexSpec.to_dict()`` and the
    numpy arrays of its ``coarse_centers`` (nlist, d), ``codebooks``
    (m, C, d/m), ``codes`` (nlist, cap, m), ``ids`` (nlist, cap) and
    ``counts`` (nlist,)."""
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    spec = IndexSpec.from_dict(spec_dict)
    index = IVFIndex(spec=spec,
                     coarse_centers=t(coarse_centers, torch.float32),
                     codebooks=t(codebooks, torch.float32),
                     codes=t(codes, torch.uint8),
                     ids=t(ids, torch.int32),
                     counts=t(counts, torch.int32))
    m, c, ds = index.codebooks.shape
    nlist, d = index.coarse_centers.shape
    if (m != spec.pq.n_subspaces or c != spec.pq.n_codes or m * ds != d
            or nlist != spec.nlist or index.codes.shape[0] != nlist
            or index.codes.shape[2] != m
            or tuple(index.ids.shape) != tuple(index.codes.shape[:2])
            or tuple(index.counts.shape) != (nlist,)):
        raise ValueError(
            f"index_from_jax: arrays do not match the spec (nlist="
            f"{spec.nlist}, m={spec.pq.n_subspaces}, C={spec.pq.n_codes}): "
            f"centers {tuple(index.coarse_centers.shape)}, codebooks "
            f"{tuple(index.codebooks.shape)}, codes "
            f"{tuple(index.codes.shape)}, ids {tuple(index.ids.shape)}, "
            f"counts {tuple(index.counts.shape)}")
    return index


def stream_state_from_jax(state, seed: int, *,
                          device: "torch.device | str | None" = None
                          ) -> StreamState:
    """The port's :class:`StreamState` on ``device`` (``None``: the CUDA
    device) from a JAX-package ``StreamState`` whose fields are numpy
    arrays (``centers``, ``coreset``, ``coreset_w``, ``n_seen``, ``step``;
    its PRNG key is not carried).  The port's updates from this state draw
    from ``seed``, so a stream started in the reference continues in the
    port."""
    dev = resolve_device(device)

    def t(a, dtype=None):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    return StreamState(centers=t(state.centers), coreset=t(state.coreset),
                       coreset_w=t(state.coreset_w),
                       n_seen=t(state.n_seen, torch.float32),
                       step=t(state.step, torch.int32), key=int(seed))


def lm_params_from_jax(cfg, params: Mapping[str, Any]
                       ) -> dict[str, torch.Tensor]:
    """The state dict of the port's model for ``cfg`` (``build_model``)
    from the JAX package's parameter tree given as numpy arrays:
    ``embed`` (Vp, d), ``final_ln`` (d,), ``head`` (d, Vp) unless the
    embeddings are tied, ``patch_proj`` (d, d) for a VLM, zamba2's
    ``shared`` attention block, and one stacked group: ``g_blocks``, each
    leaf (L, ...) (``ln1``, ``attn`` {``wq``, ``wk``, ``wv``, ``wo``},
    ``ln2``, and ``w1``/``w3``/``w2`` or ``moe`` {``router``, ``we1``,
    ``we3``, ``we2``[, ``w1``, ``w3``, ``w2``]}), or ``g_super`` whose
    per-superblock stacks are (n_super, per, ...) (gemma's ``local``,
    xlstm's ``mlstm``, zamba2's ``mamba``) or (n_super, ...) (gemma's
    ``global``, xlstm's ``slstm``); whisper's ``enc_ln`` and its ``enc``
    and ``dec`` stacks, each leaf (L, ...); each leaf's place is
    :func:`stack_path`'s.  CPU tensors, each in its target parameter's
    dtype (``cfg.dtype``, or f32 where the reference keeps f32: the
    router, ``wi``, ``wf``, ``conv``, ``A_log``, ``D``, ``dt_bias``);
    load them with ``model.load_state_dict(...)``."""
    from repro_torch.models.registry import build_model

    target = dict(build_model(cfg, device="meta").named_parameters())
    layout: dict[tuple, list] = {}
    for name in target:
        path, idx = stack_path(name)
        layout.setdefault(path, []).append((idx, name))
    given = dict(tree.items(dict(params)))
    unknown = sorted(set(given) - set(layout))
    if unknown:
        raise KeyError(f"lm_params_from_jax: {cfg.name} has no parameter "
                       f"{'/'.join(unknown[0])!r}")

    def t(name, a):
        out = torch.as_tensor(np.array(a, dtype=np.float32))
        if tuple(out.shape) != tuple(target[name].shape):
            raise ValueError(f"lm_params_from_jax: {name} is "
                             f"{tuple(out.shape)}, {cfg.name} has "
                             f"{tuple(target[name].shape)}")
        return out.to(target[name].dtype)

    state = {}
    for path, entries in layout.items():
        if path not in given:
            continue
        arr = np.asarray(given[path])
        idxs = [i for i, _ in entries]
        want = tuple(max(i[a] for i in idxs) + 1
                     for a in range(len(idxs[0])))
        if arr.shape[:len(want)] != want:
            raise ValueError(f"lm_params_from_jax: {path[0]} "
                             f"{'.'.join(path[1:])} stacks "
                             f"{arr.shape[:len(want)]} layers, {cfg.name} "
                             f"has {want}")
        for idx, name in entries:
            state[name] = t(name, arr[idx])
    return state


def stack_path(name: str) -> tuple[tuple, tuple]:
    """Where the port's parameter ``name`` lives in the reference's tree:
    (the leaf's path, the index along its stacking axes).
    ``blocks.3.attn.wq`` -> ((``g_blocks``, ``attn``, ``wq``), (3,));
    ``super.2.local.1.ln1`` -> ((``g_super``, ``local``, ``ln1``), (2,
    1)); ``super.2.global.ln1`` -> ((``g_super``, ``global``, ``ln1``),
    (2,)); whisper's ``enc.1.attn.wq`` -> ((``enc``, ``attn``, ``wq``),
    (1,)) and ``dec.0.lnx`` -> ((``dec``, ``lnx``), (0,)); an unstacked
    leaf (``embed``, ``enc_ln``, ``shared.attn.wq``) -> (its path, ())."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return ("g_blocks", *parts[2:]), (int(parts[1]),)
    if parts[0] in ("enc", "dec"):
        return (parts[0], *parts[2:]), (int(parts[1]),)
    if parts[0] == "super":
        i, sub = int(parts[1]), parts[2]
        if parts[3].isdigit():
            return ("g_super", sub, *parts[4:]), (i, int(parts[3]))
        return ("g_super", sub, *parts[3:]), (i,)
    return tuple(parts), ()


def lm_params_to_stacked(named: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of :func:`lm_params_from_jax` on tensors: the
    reference's nested tree of stacked leaves (``embed``, ``final_ln``,
    ``head``, ``patch_proj``, ``shared/...``, ``g_blocks/...`` (L, ...),
    ``g_super/...`` (n_super[, per], ...), whisper's ``enc/...`` and
    ``dec/...`` (L, ...)) from tensors keyed by the
    port's parameter names: parameters, gradients or optimizer moments.
    Stacked leaves are new tensors; an unstacked leaf is the given tensor
    itself."""
    groups: dict[tuple, list] = {}
    for name, t in named.items():
        path, idx = stack_path(name)
        groups.setdefault(path, []).append((idx, t))
    paths, values = [], []
    for path, entries in groups.items():
        entries.sort(key=lambda e: e[0])
        idxs = [i for i, _ in entries]
        lead = tuple(max(i[a] for i in idxs) + 1 for a in range(len(idxs[0])))
        if idxs != list(np.ndindex(*lead)):
            raise ValueError(f"lm_params_to_stacked: {'/'.join(path)} has "
                             f"layers {idxs}, not every index of {lead}")
        t0 = entries[0][1]
        values.append(t0 if not lead else torch.stack(
            [t for _, t in entries]).reshape(lead + tuple(t0.shape)))
        paths.append(path)
    return tree.unflatten(paths, values)


def bind_stacked(model, params: Mapping) -> None:
    """Make every parameter of ``model`` (a ``DecoderLM`` or an
    ``EncDecLM``) a view of its place in ``params``, a tree of
    :func:`lm_params_to_stacked`'s layout of the same shapes and dtypes:
    the model then computes with the tree's values, and an update of the
    tree in place reaches it."""
    for name, p in model.named_parameters():
        path, idx = stack_path(name)
        leaf = tree.get(params, path)[idx]
        if leaf.shape != p.shape or leaf.dtype != p.dtype:
            raise ValueError(f"bind_stacked: {name} is {tuple(p.shape)} "
                             f"{p.dtype}, the tree holds "
                             f"{tuple(leaf.shape)} {leaf.dtype}")
        p.data = leaf


def stacked_params(model) -> dict:
    """``model``'s parameters in the reference's stacked tree (copies of
    the layers' parameters), with ``model`` bound to it
    (:func:`bind_stacked`)."""
    params = lm_params_to_stacked({n: p.detach()
                                   for n, p in model.named_parameters()})
    bind_stacked(model, params)
    return params


def stacked_like(cfg) -> dict:
    """The stacked tree of ``cfg``'s parameters on the ``meta`` device:
    their shapes and dtypes, for ``ckpt.restore``'s ``like``."""
    from repro_torch.models.registry import build_model
    return lm_params_to_stacked({n: p.detach() for n, p in build_model(
        cfg, device="meta").named_parameters()})


def train_state_from_jax(state: Mapping[str, Any], *,
                         device: "torch.device | str | None" = None) -> dict:
    """The port's train state on ``device`` (``None``: the CUDA device)
    from a JAX-package train state ``{"params", "opt", "step"}`` given as
    numpy arrays (bf16 leaves as ``ml_dtypes`` bfloat16 or their ``|V2``
    bits): the same nested tree, each leaf a tensor of its dtype."""
    from repro_torch.ckpt.checkpoint import from_numpy
    dev = resolve_device(device)
    return tree.map_(lambda a: from_numpy(a).to(dev), dict(state))
