"""Carry state across from the JAX package to the port.

A clustering system's "weights" are its spec and its fitted centers, and
for the IVF/PQ index its quantizers and inverted lists.  The JAX package
serialises a spec with ``to_dict()`` and its results are arrays; here those
become the port's objects, so a fit made with the JAX package serves
``predict``/``transform``/``score`` from the port, and an index built with
it serves ``search``.  A language model's parameter tree becomes the state
dict of the port's ``DecoderLM`` (:func:`lm_params_from_jax`), and a
streaming clusterer's state continues in the port
(:func:`stream_state_from_jax`).  Only plain Python and numpy cross over:
nothing here imports the JAX package.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

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


def _leaves(tree, prefix=()):
    """(path, array) for every array of a nested parameter dict."""
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from _leaves(sub, prefix + (name,))
        else:
            yield prefix + (name,), sub


def lm_params_from_jax(cfg, params: Mapping[str, Any]
                       ) -> dict[str, torch.Tensor]:
    """The state dict of the port's ``DecoderLM`` for ``cfg`` from the JAX
    package's ``DecoderLM`` parameter tree given as numpy arrays:
    ``embed`` (Vp, d), ``final_ln`` (d,), ``head`` (d, Vp) unless the
    embeddings are tied, ``patch_proj`` (d, d) for a VLM, zamba2's
    ``shared`` attention block, and one stacked group: ``g_blocks``, each
    leaf (L, ...) (``ln1``, ``attn`` {``wq``, ``wk``, ``wv``, ``wo``},
    ``ln2``, and ``w1``/``w3``/``w2`` or ``moe`` {``router``, ``we1``,
    ``we3``, ``we2``[, ``w1``, ``w3``, ``w2``]}), or ``g_super`` whose
    per-superblock stacks are (n_super, per, ...) (gemma's ``local``,
    xlstm's ``mlstm``, zamba2's ``mamba``) or (n_super, ...) (gemma's
    ``global``, xlstm's ``slstm``).  CPU tensors, each in its target
    parameter's dtype (``cfg.dtype``, or f32 where the reference keeps
    f32: the router, ``wi``, ``wf``, ``conv``, ``A_log``, ``D``,
    ``dt_bias``); load them with ``model.load_state_dict(...)``."""
    from repro_torch.models.lm import DecoderLM, _superblocks

    target = dict(DecoderLM(cfg, device="meta").named_parameters())

    def t(name, a):
        if name not in target:
            raise KeyError(f"lm_params_from_jax: {cfg.name} has no "
                           f"parameter {name!r}")
        out = torch.as_tensor(np.array(a, dtype=np.float32))
        if tuple(out.shape) != tuple(target[name].shape):
            raise ValueError(f"lm_params_from_jax: {name} is "
                             f"{tuple(out.shape)}, {cfg.name} has "
                             f"{tuple(target[name].shape)}")
        return out.to(target[name].dtype)

    state = {name: t(name, params[name]) for name in
             ("embed", "final_ln", "head", "patch_proj") if name in params}
    for path, arr in _leaves(params.get("shared", {})):
        state["shared." + ".".join(path)] = t("shared." + ".".join(path),
                                             arr)
    group = "super" if "g_super" in params else "blocks"
    n_super = _superblocks(cfg) if group == "super" else 0
    per = {"local": cfg.local_per_global, "mlstm": cfg.mlstm_per_slstm,
           "mamba": cfg.mamba_per_attn}
    for path, arr in _leaves(params[f"g_{group}"]):
        arr = np.asarray(arr)
        # the stacking axes and the port's name for each stacked index:
        # blocks.{i}, super.{i}.{local,mlstm,mamba}.{j} or
        # super.{i}.{global,slstm}
        if group == "blocks":
            want, name = (cfg.n_layers,), (lambda i: f"{i[0]}")
        elif path[0] in per:
            want = (n_super, per[path[0]])
            name = (lambda i, p=path[0]: f"{i[0]}.{p}.{i[1]}")
        else:
            want, name = (n_super,), (lambda i, p=path[0]: f"{i[0]}.{p}")
        rest = ".".join(path if group == "blocks" else path[1:])
        if arr.shape[:len(want)] != want:
            raise ValueError(f"lm_params_from_jax: g_{group} "
                             f"{'.'.join(path)} stacks {arr.shape[:len(want)]}"
                             f" layers, {cfg.name} has {want}")
        for idx in np.ndindex(*want):
            key = f"{group}.{name(idx)}.{rest}"
            state[key] = t(key, arr[idx])
    return state
