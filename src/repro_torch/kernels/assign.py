"""Nearest-center assignment (``csrc/assign.cu``).

Replaces ``repro/kernels/assign.py::assign_argmin_pallas``.  For CPU
tensors :func:`assign_argmin` runs the plain version
(:func:`repro_torch.kernels.ref.assign_argmin_ref`); for CUDA tensors it
launches the kernel or raises, on the route ``tiles.assign_route`` picks by
shape:

  * ``"simt"``: the FP32 cores, four points per thread where the batch
    is large (``tiles.assign_points``), its ``idx``/``dist`` bit for bit
    those of the Lloyd kernel's SIMT route;
  * ``"tc"`` (d >= 32): the Lloyd kernel's tensor-core argmin
    (``csrc/tc_argmin.cuh``, three TF32 passes), after a pre-pass that
    splits both operands into TF32 planes in device memory.

``config`` (a ``kernels.autotune.TileConfig``, or ``None`` for the
formulas of ``tiles.assign_plan``) sets the SIMT route's center tile,
points per thread and blocks per batch entry; the tensor-core route
ignores it.  None of them moves a value: each point's argmin is one
thread's scan of the centers in increasing order.

``launches`` counts the calls that launched the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import assign_argmin_ref
from .tiles import (AssignPlan, assign_plan, assign_route, center_tile,
                    check_inputs, register_dim, tc_work_floats)

launches = 0      # CUDA launches of this kernel since import (or reset)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_LIB = None
_OCCUPANCY: dict[tuple, int] = {}


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("assign")
        lib.repro_assign_argmin.argtypes = [
            _P, _L, _I, _P, _L, _I,                 # x, c
            _I, _I, _I, _I, _I, _I, _I, _I,         # B M K d dp bk wide G
            _P, _P, _P]                             # idx dist stream
        lib.repro_assign_occupancy.argtypes = [_I, _I, _I, _I, _P]
        lib.repro_assign_tc.argtypes = [
            _P, _L, _I, _P, _L, _I,                 # x, c
            _I, _I, _I, _I, _P, _L,                 # B M K d work n_work
            _P, _P, _P]                             # idx dist stream
        for fn in (lib.repro_assign_argmin, lib.repro_assign_occupancy,
                   lib.repro_assign_tc):
            fn.restype = _I
        lib.repro_assign_error_string.argtypes = [_I]
        lib.repro_assign_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise(err: int, shape: tuple) -> None:
    if err:
        raise RuntimeError(
            f"assign_argmin: kernel launch failed with CUDA error {err} "
            f"({_lib().repro_assign_error_string(err).decode()}) at "
            f"(B, M, K, d) = {shape}")


def occupancy(k: int, d: int, wide: bool, tile: int = 0) -> int:
    """Blocks of the SIMT kernel one SM of the current device holds at once
    at ``(k, d)`` and center tile ``tile`` (0: ``center_tile``), with the
    wide register tile or without, as the runtime reports them (cached)."""
    tile = tile or center_tile(k, d)
    key = (torch.cuda.current_device(), k, d, bool(wide), tile)
    if key not in _OCCUPANCY:
        per_sm = ctypes.c_int()
        err = _lib().repro_assign_occupancy(
            d, register_dim(d), tile, wide, ctypes.byref(per_sm))
        _raise(err, (None, None, k, d))
        _OCCUPANCY[key] = per_sm.value
    return _OCCUPANCY[key]


def plan(b: int, m: int, k: int, d: int, device: torch.device,
         config=None) -> AssignPlan:
    """The SIMT launch at ``config`` (``None``: the formulas) for a (B, M,
    K, d) call on a CUDA ``device``: the runtime's occupancy at the tile."""
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    with torch.cuda.device(device):
        return assign_plan(b, m, k, d, sm_count,
                           lambda t, wide: occupancy(k, d, wide, t),
                           *((config.center_tile, config.points,
                              config.blocks) if config is not None else ()))


def assign_argmin(x: torch.Tensor, c: torch.Tensor, config=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest center of every point of a batch: (B, M, d) points,
    (B, K, d) centers -> ``(idx (B, M) int32, dist (B, M) f32)``.  Ties go
    to the lowest center index.  ``config``: see the module docstring."""
    b, m, k, d = check_inputs("assign_argmin", x, c)
    if x.device.type == "cpu":
        return assign_argmin_ref(x, c)
    if x.device.type != "cuda":
        raise ValueError(f"assign_argmin: unsupported device {x.device}")
    out = route_argmin(x, c, assign_route(k, d), config)
    global launches
    launches += 1
    return out


def route_argmin(x: torch.Tensor, c: torch.Tensor, route: str, config=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`assign_argmin` on CUDA inputs it accepts, on the given route
    (``"simt"``, or ``"tc"`` at d >= ``tiles.TC_MIN_D``) whatever the shape
    would pick; ``launches`` is not counted.
    Measurement compares the two routes through it."""
    (b, m, d), k = x.shape, c.shape[1]
    dev = x.device
    idx = torch.empty((b, m), device=dev, dtype=torch.int32)
    dist = torch.empty((b, m), device=dev, dtype=torch.float32)
    bf16 = torch.bfloat16
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if route == "tc":
            work = torch.empty(
                (tc_work_floats(b, m, k, d, x.stride(0) == 0),), device=dev,
                dtype=torch.float32)
            err = _lib().repro_assign_tc(
                x.data_ptr(), x.stride(0), x.dtype == bf16,
                c.data_ptr(), c.stride(0), c.dtype == bf16, b, m, k, d,
                work.data_ptr(), work.numel(), idx.data_ptr(),
                dist.data_ptr(), stream)
        else:
            bk, points, g = plan(b, m, k, d, dev, config)
            err = _lib().repro_assign_argmin(
                x.data_ptr(), x.stride(0), x.dtype == bf16,
                c.data_ptr(), c.stride(0), c.dtype == bf16,
                b, m, k, d, register_dim(d), bk, points > 1, g,
                idx.data_ptr(), dist.data_ptr(), stream)
    _raise(err, (b, m, k, d))
    return idx, dist
