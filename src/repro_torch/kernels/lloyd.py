"""The Lloyd step: nearest center plus raw weighted per-cluster statistics
(``csrc/lloyd.cu``).

Replaces ``repro/kernels/lloyd.py::lloyd_step_pallas``.  For CPU tensors
:func:`lloyd_step` runs the plain version
(:func:`repro_torch.kernels.ref.lloyd_step_ref`); for CUDA tensors it
launches the kernel or raises, on the route ``tiles.lloyd_route`` picks by
shape:

  * ``"simt"`` (small d): one fused pass, distances on the FP32 cores and
    per-block statistics reduced in block order;
  * ``"tc"`` (d >= 32): the distances on the tensor cores (three TF32
    passes, ``csrc/tc_argmin.cuh``: both operands split into TF32 planes in
    device memory first, then streamed), then the statistics from the
    centroid update's kernels (``centroid.launch``) on the labels.

``config`` (a ``kernels.autotune.TileConfig``, or ``None`` for the
formulas of ``tiles.lloyd_plan``) sets the SIMT route's center tile and
blocks per batch entry; the tensor-core route ignores it.  The center tile
moves no value; the blocks regroup the per-block partial sums, so the last
bits of ``sums`` and ``sse`` may move with them (labels, distances and
integer-weight counts do not).

``launches`` counts the calls that launched the kernel (one per call on
either route); ``centroid_launches`` counts the centroid-update launches
the tensor-core route made for its statistics (``centroid.launches`` does
not include them).
"""
from __future__ import annotations

import ctypes

import torch

from . import build, centroid
from .ref import lloyd_step_ref
from .tiles import (TC_ROWS, LloydPlan, acc_in_smem, center_tile,
                    check_inputs, lloyd_plan, lloyd_route, register_dim,
                    tc_work_floats)

launches = 0            # calls that launched this kernel since import/reset
centroid_launches = 0   # centroid-update launches of the tensor-core route

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_LIB = None
_OCCUPANCY: dict[tuple, tuple[int, int]] = {}


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("lloyd")
        lib.repro_lloyd_step.argtypes = [
            _P, _L, _I, _P, _L, _I, _P, _L, _I,     # x, w, c
            _I, _I, _I, _I, _I, _I, _I, _I,         # B M K d dp bk G acc_smem
            _P, _P, _P, _P, _P, _P, _P, _P,         # idx dist partials outputs
            _P]                                     # stream
        lib.repro_lloyd_simt_occupancy.argtypes = [
            _I, _I, _I, _I, _I, _P, _P]             # K d dp bk acc_smem, out
        lib.repro_lloyd_tc.argtypes = [
            _P, _L, _I, _P, _L, _I, _P, _L, _I,     # x, w, c
            _I, _I, _I, _I, _P, _L,                 # B M K d work n_work
            _P, _P, _P, _P,                         # idx dist part_sse sse
            _P]                                     # stream
        for fn in (lib.repro_lloyd_step, lib.repro_lloyd_simt_occupancy,
                   lib.repro_lloyd_tc):
            fn.restype = _I
        lib.repro_lloyd_error_string.argtypes = [_I]
        lib.repro_lloyd_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise(err: int, shape: tuple) -> None:
    if err:
        raise RuntimeError(
            f"lloyd_step: kernel launch failed with CUDA error {err} "
            f"({_lib().repro_lloyd_error_string(err).decode()}) at "
            f"(B, M, K, d) = {shape}")


def simt_occupancy(k: int, d: int, tile: int = 0) -> tuple[int, int]:
    """``(blocks per SM, shared memory bytes per block)`` of the SIMT
    kernel at ``(k, d)`` and center tile ``tile`` (0: ``center_tile``), as
    the runtime reports them on the current device (cached)."""
    tile = tile or center_tile(k, d)
    key = (torch.cuda.current_device(), k, d, tile)
    if key not in _OCCUPANCY:
        per_sm, smem = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(key[0]):
            err = _lib().repro_lloyd_simt_occupancy(
                k, d, register_dim(d), tile, acc_in_smem(k, d),
                ctypes.byref(per_sm), ctypes.byref(smem))
        _raise(err, (None, None, k, d))
        _OCCUPANCY[key] = (per_sm.value, smem.value)
    return _OCCUPANCY[key]


def plan(b: int, m: int, k: int, d: int, device: torch.device,
         config=None) -> LloydPlan:
    """The SIMT launch at ``config`` (``None``: the formulas) for a (B, M,
    K, d) call on a CUDA ``device``: the runtime's occupancy at the tile."""
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    with torch.cuda.device(device):
        return lloyd_plan(b, m, k, d, sm_count,
                          lambda t: simt_occupancy(k, d, t)[0],
                          *((config.center_tile, config.blocks)
                            if config is not None else ()))


def lloyd_step(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor,
               config=None) -> tuple[torch.Tensor, ...]:
    """One Lloyd pass over a batch: (B, M, d) points, (B, M) weights,
    (B, K, d) centers -> ``(sums (B, K, d), counts (B, K), sse (B,),
    idx (B, M) int32, dist (B, M))``, all f32 but ``idx``.

    ``sums``/``counts`` are the *raw* weighted statistics (the caller
    divides).  Rows with ``w = 0`` get ``idx``/``dist`` and add nothing.
    Deterministic: a repeated call is bit-identical.  ``config``: see
    the module docstring."""
    b, m, k, d = check_inputs("lloyd_step", x, c, w)
    if x.device.type == "cpu":
        return lloyd_step_ref(x, w, c)
    if x.device.type != "cuda":
        raise ValueError(f"lloyd_step: unsupported device {x.device}")
    out = route_step(x, w, c, lloyd_route(k, d), config)
    global launches
    launches += 1
    return out


def route_step(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor,
               route: str, config=None) -> tuple[torch.Tensor, ...]:
    """:func:`lloyd_step` on CUDA inputs it accepts, on the given route
    (``"simt"``, or ``"tc"`` at d >= ``tiles.TC_MIN_D``) whatever the
    shape would pick; ``launches`` is not counted.
    Measurement compares the two routes through it."""
    with torch.cuda.device(x.device):
        if route == "tc":
            return _tc_step(x, w, c)
        return _simt_step(x, w, c, config)


def _simt_step(x, w, c, config):
    (b, m, d), k = x.shape, c.shape[1]
    dev = x.device
    bk, g = plan(b, m, k, d, dev, config)
    f32 = dict(device=dev, dtype=torch.float32)
    idx = torch.empty((b, m), device=dev, dtype=torch.int32)
    dist = torch.empty((b, m), **f32)
    part_sums = torch.empty((b, g, k, d), **f32)
    part_counts = torch.empty((b, g, k), **f32)
    part_sse = torch.empty((b, g), **f32)
    sums = torch.empty((b, k, d), **f32)
    counts = torch.empty((b, k), **f32)
    sse = torch.empty((b,), **f32)
    bf16 = torch.bfloat16
    err = _lib().repro_lloyd_step(
        x.data_ptr(), x.stride(0), x.dtype == bf16,
        w.data_ptr(), w.stride(0), w.dtype == bf16,
        c.data_ptr(), c.stride(0), c.dtype == bf16,
        b, m, k, d, register_dim(d), bk, g,
        acc_in_smem(k, d),
        idx.data_ptr(), dist.data_ptr(), part_sums.data_ptr(),
        part_counts.data_ptr(), part_sse.data_ptr(), sums.data_ptr(),
        counts.data_ptr(), sse.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise(err, (b, m, k, d))
    return sums, counts, sse, idx, dist


def _tc_step(x, w, c):
    (b, m, d), k = x.shape, c.shape[1]
    dev = x.device
    f32 = dict(device=dev, dtype=torch.float32)
    idx = torch.empty((b, m), device=dev, dtype=torch.int32)
    dist = torch.empty((b, m), **f32)
    part_sse = torch.empty((b, -(-m // TC_ROWS)), **f32)
    sse = torch.empty((b,), **f32)
    work = torch.empty((tc_work_floats(b, m, k, d, x.stride(0) == 0),), **f32)
    bf16 = torch.bfloat16
    err = _lib().repro_lloyd_tc(
        x.data_ptr(), x.stride(0), x.dtype == bf16,
        w.data_ptr(), w.stride(0), w.dtype == bf16,
        c.data_ptr(), c.stride(0), c.dtype == bf16,
        b, m, k, d, work.data_ptr(), work.numel(), idx.data_ptr(),
        dist.data_ptr(),
        part_sse.data_ptr(), sse.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise(err, (b, m, k, d))
    sums, counts = centroid.launch(x, idx, w, k)
    global centroid_launches
    centroid_launches += 1
    return sums, counts, sse, idx, dist
