"""Nearest-center assignment (``csrc/assign.cu``).

Replaces ``repro/kernels/assign.py::assign_argmin_pallas``.  For CPU
tensors :func:`assign_argmin` runs the plain version
(:func:`repro_torch.kernels.ref.assign_argmin_ref`); for CUDA tensors it
launches the kernel or raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import assign_argmin_ref
from .tiles import center_tile, check_inputs, register_dim

launches = 0      # CUDA launches of this kernel since import (or reset)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("assign")
        lib.repro_assign_argmin.argtypes = [
            _P, _L, _I, _P, _L, _I,                 # x, c
            _I, _I, _I, _I, _I, _I,                 # B M K d dp bk
            _P, _P, _P]                             # idx dist stream
        lib.repro_assign_argmin.restype = _I
        lib.repro_assign_error_string.argtypes = [_I]
        lib.repro_assign_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def assign_argmin(x: torch.Tensor, c: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest center of every point of a batch: (B, M, d) points,
    (B, K, d) centers -> ``(idx (B, M) int32, dist (B, M) f32)``.  Ties go
    to the lowest center index."""
    b, m, k, d = check_inputs("assign_argmin", x, c)
    if x.device.type == "cpu":
        return assign_argmin_ref(x, c)
    if x.device.type != "cuda":
        raise ValueError(f"assign_argmin: unsupported device {x.device}")
    dev = x.device
    idx = torch.empty((b, m), device=dev, dtype=torch.int32)
    dist = torch.empty((b, m), device=dev, dtype=torch.float32)
    lib = _lib()
    bf16 = torch.bfloat16
    with torch.cuda.device(dev):
        err = lib.repro_assign_argmin(
            x.data_ptr(), x.stride(0), x.dtype == bf16,
            c.data_ptr(), c.stride(0), c.dtype == bf16,
            b, m, k, d, register_dim(d), center_tile(k, d),
            idx.data_ptr(), dist.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(
            f"assign_argmin: kernel launch failed with CUDA error {err} "
            f"({lib.repro_assign_error_string(err).decode()}) at "
            f"(B, M, K, d) = {(b, m, k, d)}")
    global launches
    launches += 1
    return idx, dist
