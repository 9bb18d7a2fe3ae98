"""Weighted centroid update: raw per-cluster sums and counts of points
whose cluster ids are given (``csrc/centroid.cu``).

Replaces ``repro/kernels/centroid.py::centroid_update_pallas``: the second
pass of the unfused ``cuda`` backend.  For CPU tensors
:func:`centroid_update` runs the plain version
(:func:`repro_torch.kernels.ref.centroid_update_ref`); for CUDA tensors it
launches the kernel or raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import centroid_update_ref
from .tiles import acc_in_smem, check_update_inputs, lloyd_blocks

launches = 0      # CUDA launches of this kernel since import (or reset)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("centroid")
        lib.repro_centroid_update.argtypes = [
            _P, _L, _I, _P, _L, _P, _L, _I,         # x, idx, w
            _I, _I, _I, _I, _I, _I,                 # B M K d G acc_smem
            _P, _P, _P, _P,                         # partials, outputs
            _P]                                     # stream
        lib.repro_centroid_update.restype = _I
        lib.repro_centroid_error_string.argtypes = [_I]
        lib.repro_centroid_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def centroid_update(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                    k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw weighted per-cluster statistics of a batch: (B, M, d) points,
    (B, M) int32 cluster ids, (B, M) weights -> ``(sums (B, k, d),
    counts (B, k))``, both f32 (the caller divides).  A row adds nothing
    when its weight is 0 or its id lies outside [0, k).  Deterministic: a
    repeated call is bit-identical."""
    b, m, d = check_update_inputs("centroid_update", x, idx, w, k)
    if x.device.type == "cpu":
        return centroid_update_ref(x, idx, w, k)
    if x.device.type != "cuda":
        raise ValueError(f"centroid_update: unsupported device {x.device}")
    dev = x.device
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    g = lloyd_blocks(b, m, k, d, sm_count)
    f32 = dict(device=dev, dtype=torch.float32)
    part_sums = torch.empty((b, g, k, d), **f32)
    part_counts = torch.empty((b, g, k), **f32)
    sums = torch.empty((b, k, d), **f32)
    counts = torch.empty((b, k), **f32)
    lib = _lib()
    bf16 = torch.bfloat16
    with torch.cuda.device(dev):
        err = lib.repro_centroid_update(
            x.data_ptr(), x.stride(0), x.dtype == bf16,
            idx.data_ptr(), idx.stride(0),
            w.data_ptr(), w.stride(0), w.dtype == bf16,
            b, m, k, d, g, acc_in_smem(k, d),
            part_sums.data_ptr(), part_counts.data_ptr(), sums.data_ptr(),
            counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(
            f"centroid_update: kernel launch failed with CUDA error {err} "
            f"({lib.repro_centroid_error_string(err).decode()}) at "
            f"(B, M, k, d) = {(b, m, k, d)}")
    global launches
    launches += 1
    return sums, counts
