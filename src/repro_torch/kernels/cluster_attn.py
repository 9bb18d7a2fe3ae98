"""Decode attention over a clustered KV cache (``csrc/cluster_attn.cu``).

The paper's k-means centroids of the old keys and values serve as an
attention operand: a query attends to centroid j with logit
``q.kc_j * scale + log(n_j)``, the first-order stand-in for attending to
each of the cluster's n_j members.  :func:`cluster_attn_partial` replaces
``repro/kernels/cluster_attn.py::cluster_attn_decode_pallas`` and returns
what its ``pallas_call`` returns, the unnormalised online-softmax state
``(acc, m, l)``, so a caller can merge further logits (the exact recent
window) into it.  For CPU tensors it runs the plain version
(:func:`repro_torch.kernels.ref.cluster_attn_decode_ref`), for CUDA tensors
it launches the kernel or raises; ``launches`` counts kernel launches.
For ``meta`` tensors (the dry run, :mod:`repro_torch.launch.dryrun`) it
returns empty outputs of the right shapes and computes nothing: shape
propagation, not a fallback.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import cluster_attn_decode_ref
from .tiles import (attn_lanes_per_row, attn_splits, attn_stage_rows,
                    check_attn_inputs)

launches = 0      # CUDA launches of this kernel since import (or reset)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("cluster_attn")
        lib.repro_cluster_attn.argtypes = [
            _P, _L, _L, _I,                         # q
            _P, _L, _L, _P, _L, _L, _I,             # kc, vc
            _P, _L, _L,                             # counts
            _I, _I, _I, _I, _I, _I, _I, _I,         # B Hkv G Nc dh lpr S chunk
            _I, ctypes.c_float,                     # stage_rows, scale
            _P, _P, _P, _P,                         # partials, counters
            _P, _P, _P,                             # outputs
            _P]                                     # stream
        lib.repro_cluster_attn.restype = _I
        lib.repro_cluster_attn_error_string.argtypes = [_I]
        lib.repro_cluster_attn_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def cluster_attn_partial(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                         counts: torch.Tensor, scale: float
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, H, dh) queries against (B, Hkv, Nc, dh) centroid keys/values
    with (B, Hkv, Nc) f32 member counts (0 = dead centroid) -> ``acc``
    (B, Hkv, g, dh), ``m`` and ``l`` (B, Hkv, g), all f32
    (see :func:`~repro_torch.kernels.ref.cluster_attn_decode_ref`).
    Deterministic: a repeated call is bit-identical."""
    b, h, hkv, nc, dh = check_attn_inputs("cluster_attn", q, kc, vc, counts)
    if q.device.type == "cpu":
        return cluster_attn_decode_ref(q, kc, vc, counts, scale)
    g = h // hkv
    if q.device.type == "meta":
        meta = dict(device="meta", dtype=torch.float32)
        return (torch.empty((b, hkv, g, dh), **meta),
                torch.empty((b, hkv, g), **meta),
                torch.empty((b, hkv, g), **meta))
    if q.device.type != "cuda":
        raise ValueError(f"cluster_attn: unsupported device {q.device}")
    dev = q.device
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    s, chunk = attn_splits(b, hkv, nc, sm_count)
    f32 = dict(device=dev, dtype=torch.float32)
    part_acc = torch.empty((b, hkv, s, g, dh), **f32)
    part_m = torch.empty((b, hkv, s, g), **f32)
    part_l = torch.empty((b, hkv, s, g), **f32)
    acc = torch.empty((b, hkv, g, dh), **f32)
    m = torch.empty((b, hkv, g), **f32)
    l = torch.empty((b, hkv, g), **f32)
    lib = _lib()
    bf16 = torch.bfloat16
    with torch.cuda.device(dev):
        err = lib.repro_cluster_attn(
            q.data_ptr(), q.stride(0), q.stride(1), q.dtype == bf16,
            kc.data_ptr(), kc.stride(0), kc.stride(1),
            vc.data_ptr(), vc.stride(0), vc.stride(1), kc.dtype == bf16,
            counts.data_ptr(), counts.stride(0), counts.stride(1),
            b, hkv, g, nc, dh, attn_lanes_per_row(dh, kc.dtype), s, chunk,
            attn_stage_rows(dh, kc.dtype), float(scale),
            part_acc.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
            build.counters(dev, b * hkv).data_ptr(),
            acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(
            f"cluster_attn: kernel launch failed with CUDA error {err} "
            f"({lib.repro_cluster_attn_error_string(err).decode()}) at "
            f"(B, H, Hkv, Nc, dh) = {(b, h, hkv, nc, dh)}")
    global launches
    launches += 1
    return acc, m, l


def cluster_attn_decode(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                        counts: torch.Tensor, scale: float) -> torch.Tensor:
    """The normalised decode attention over the centroids alone:
    ``acc / max(l, 1e-30)`` as (B, H, dh) f32, as
    ``cluster_attn_decode_pallas`` returns it."""
    acc, _, l = cluster_attn_partial(q, kc, vc, counts, scale)
    return (acc / l.clamp_min(1e-30)[..., None]).reshape(q.shape)
