"""The fused Lloyd step: nearest center plus raw weighted per-cluster
statistics in one pass over the points (``csrc/lloyd.cu``).

Replaces ``repro/kernels/lloyd.py::lloyd_step_pallas``.  For CPU tensors
:func:`lloyd_step` runs the plain version
(:func:`repro_torch.kernels.ref.lloyd_step_ref`); for CUDA tensors it
launches the kernel or raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import lloyd_step_ref
from .tiles import (acc_in_smem, center_tile, check_inputs, lloyd_blocks,
                    register_dim)

launches = 0      # CUDA launches of this kernel since import (or reset)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("lloyd")
        lib.repro_lloyd_step.argtypes = [
            _P, _L, _I, _P, _L, _I, _P, _L, _I,     # x, w, c
            _I, _I, _I, _I, _I, _I, _I, _I,         # B M K d dp bk G acc_smem
            _P, _P, _P, _P, _P, _P, _P, _P,         # idx dist partials outputs
            _P]                                     # stream
        lib.repro_lloyd_step.restype = _I
        lib.repro_lloyd_error_string.argtypes = [_I]
        lib.repro_lloyd_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def lloyd_step(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor
               ) -> tuple[torch.Tensor, ...]:
    """One Lloyd pass over a batch: (B, M, d) points, (B, M) weights,
    (B, K, d) centers -> ``(sums (B, K, d), counts (B, K), sse (B,),
    idx (B, M) int32, dist (B, M))``, all f32 but ``idx``.

    ``sums``/``counts`` are the *raw* weighted statistics (the caller
    divides).  Rows with ``w = 0`` get ``idx``/``dist`` and add nothing.
    Deterministic: a repeated call is bit-identical."""
    b, m, k, d = check_inputs("lloyd_step", x, c, w)
    if x.device.type == "cpu":
        return lloyd_step_ref(x, w, c)
    if x.device.type != "cuda":
        raise ValueError(f"lloyd_step: unsupported device {x.device}")
    dev = x.device
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    g = lloyd_blocks(b, m, k, d, sm_count)
    f32 = dict(device=dev, dtype=torch.float32)
    idx = torch.empty((b, m), device=dev, dtype=torch.int32)
    dist = torch.empty((b, m), **f32)
    part_sums = torch.empty((b, g, k, d), **f32)
    part_counts = torch.empty((b, g, k), **f32)
    part_sse = torch.empty((b, g), **f32)
    sums = torch.empty((b, k, d), **f32)
    counts = torch.empty((b, k), **f32)
    sse = torch.empty((b,), **f32)
    lib = _lib()
    bf16 = torch.bfloat16
    with torch.cuda.device(dev):
        err = lib.repro_lloyd_step(
            x.data_ptr(), x.stride(0), x.dtype == bf16,
            w.data_ptr(), w.stride(0), w.dtype == bf16,
            c.data_ptr(), c.stride(0), c.dtype == bf16,
            b, m, k, d, register_dim(d), center_tile(k, d), g,
            acc_in_smem(k, d),
            idx.data_ptr(), dist.data_ptr(), part_sums.data_ptr(),
            part_counts.data_ptr(), part_sse.data_ptr(), sums.data_ptr(),
            counts.data_ptr(), sse.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(
            f"lloyd_step: kernel launch failed with CUDA error {err} "
            f"({lib.repro_lloyd_error_string(err).decode()}) at "
            f"(B, M, K, d) = {(b, m, k, d)}")
    global launches
    launches += 1
    return sums, counts, sse, idx, dist
