"""Weighted centroid update: raw per-cluster sums and counts of points
whose cluster ids are given (``csrc/centroid.cu``).

Replaces ``repro/kernels/centroid.py::centroid_update_pallas``: the second
pass of the unfused ``cuda`` backend, and the refresh's value update.  For
CPU tensors :func:`centroid_update` runs the plain version
(:func:`repro_torch.kernels.ref.centroid_update_ref`); for CUDA tensors it
launches the kernel or raises: warp-private accumulators (one launch), or
the counting sort and the segmented sum (two), as ``tiles.centroid_sorts``
decides by shape.  ``launches`` counts the calls that launched it.

``config`` (a ``kernels.autotune.TileConfig``, or ``None`` for
``tiles.centroid_blocks``' formula) sets the warp path's blocks per lane;
the sort path ignores it.  The blocks regroup the per-block partial sums,
so the last bits of ``sums`` may move with them (integer-weight counts do
not).
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import centroid_update_ref
from .tiles import (centroid_sorts, check_sort_clusters, check_update_inputs,
                    centroid_blocks, centroid_warps, segment_clusters,
                    segment_lanes)

launches = 0      # CUDA launches of this kernel since import (or reset)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("centroid")
        lib.repro_centroid_warps.argtypes = [
            _P, _L, _I, _P, _L, _P, _L, _I,         # x, idx, w
            _I, _I, _I, _I, _I, _I,                 # B M K d G W
            _P, _P,                                 # partials, counters
            _P, _P,                                 # outputs
            _P]                                     # stream
        lib.repro_centroid_sorted.argtypes = [
            _P, _L, _I, _P, _L, _P, _L, _I,         # x, idx, w
            _I, _I, _I, _I, _I, _I,                 # B M K d gs cpb
            _P, _P, _P, _P, _P,                     # offsets, 2 x (perm, w)
            _P, _P,                                 # outputs
            _P]                                     # stream
        for fn in (lib.repro_centroid_warps, lib.repro_centroid_sorted):
            fn.restype = _I
        lib.repro_centroid_error_string.argtypes = [_I]
        lib.repro_centroid_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def centroid_update(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                    k: int, config=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw weighted per-cluster statistics of a batch: (B, M, d) points,
    (B, M) int32 cluster ids, (B, M) weights -> ``(sums (B, k, d),
    counts (B, k))``, both f32 (the caller divides).  A row adds nothing
    when its weight is 0 or its id lies outside [0, k).  Deterministic: a
    repeated call is bit-identical.  ``config``: see the module
    docstring."""
    check_update_inputs("centroid_update", x, idx, w, k)
    if x.device.type == "cpu":
        return centroid_update_ref(x, idx, w, k)
    if x.device.type != "cuda":
        raise ValueError(f"centroid_update: unsupported device {x.device}")
    out = launch(x, idx, w, k, config)
    global launches
    launches += 1
    return out


def launch(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, k: int,
           config=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors that ``check_update_inputs``
    accepts, without counting the launch: :func:`centroid_update` counts
    its own, and the Lloyd kernel's tensor-core route counts those it makes
    for its statistics (``lloyd.centroid_launches``)."""
    b, m, d = x.shape
    dev = x.device
    sorts = centroid_sorts(k, d)
    if sorts:
        check_sort_clusters("centroid_update", k)
    f32 = dict(device=dev, dtype=torch.float32)
    i32 = dict(device=dev, dtype=torch.int32)
    sums = torch.empty((b, k, d), **f32)
    counts = torch.empty((b, k), **f32)
    lib = _lib()
    bf16 = torch.bfloat16
    inputs = (x.data_ptr(), x.stride(0), x.dtype == bf16,
              idx.data_ptr(), idx.stride(0),
              w.data_ptr(), w.stride(0), w.dtype == bf16, b, m, k, d)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if sorts:
            offsets = torch.empty((b, k + 1), **i32)
            perm = torch.empty((2, b, m), **i32)
            wsorted = torch.empty((2, b, m), **f32)
            err = lib.repro_centroid_sorted(
                *inputs, segment_lanes(d), segment_clusters(d),
                offsets.data_ptr(), perm[0].data_ptr(), wsorted[0].data_ptr(),
                perm[1].data_ptr(), wsorted[1].data_ptr(), sums.data_ptr(),
                counts.data_ptr(), stream)
        else:
            sm_count = torch.cuda.get_device_properties(
                dev).multi_processor_count
            g = centroid_blocks(b, m, k, d, sm_count,
                                config.blocks if config is not None else 0)
            part = torch.empty((b, g, -(-k * (d + 1) // 4) * 4), **f32)
            err = lib.repro_centroid_warps(
                *inputs, g, centroid_warps(k, d), part.data_ptr(),
                build.counters(dev, b).data_ptr(), sums.data_ptr(),
                counts.data_ptr(), stream)
    if err:
        raise RuntimeError(
            f"centroid_update: kernel launch failed with CUDA error {err} "
            f"({lib.repro_centroid_error_string(err).decode()}) at "
            f"(B, M, k, d) = {(b, m, k, d)}")
    return sums, counts
