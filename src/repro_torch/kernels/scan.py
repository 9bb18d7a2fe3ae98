"""The ADC (asymmetric distance computation) scan — the IVF/PQ query hot
loop (``csrc/adc_scan.cu``).

A product-quantized database stores each vector as ``m`` small codes; a
query meets a candidate through per-subspace lookup tables:
``dist(q, x) = sum_j lut[j, code_j(x)]``.  :func:`adc_scan_cuda` replaces
``repro/kernels/scan.py::adc_scan_pallas``: for CPU tensors it runs the
plain version (:func:`repro_torch.kernels.ref.adc_scan_ref`), for CUDA
tensors it launches the kernel or raises; ``launches`` counts kernel
launches.

``config`` (a ``kernels.autotune.TileConfig``) sets the blocks per batch
entry; without one the call looks its shape up in the tuner's cache
(``autotune.lookup("scan", ...)``, whose default is ``tiles.scan_plan``'s
formula).  The blocks move no value: each thread sums one row's table
entries in subspace order.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import adc_scan_ref
from .tiles import (ScanPlan, check_scan_inputs, code_vector_bytes, scan_plan,
                    scan_vector_table)

launches = 0      # CUDA launches of this kernel since import (or reset)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_LIB = None
_OCCUPANCY: dict[tuple, int] = {}


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("adc_scan")
        lib.repro_adc_scan.argtypes = [
            _P, _L, _I, _P, _L,                     # luts, codes
            _I, _I, _I, _I, _I,                     # B L m C vec
            _I, _I,                                 # G vec_table
            _P, _P]                                 # out stream
        lib.repro_adc_scan_occupancy.argtypes = [_I, _I, _I, _I, _P]
        for fn in (lib.repro_adc_scan, lib.repro_adc_scan_occupancy):
            fn.restype = _I
        lib.repro_adc_scan_error_string.argtypes = [_I]
        lib.repro_adc_scan_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise(err: int, shape: tuple) -> None:
    if err:
        raise RuntimeError(
            f"adc_scan: kernel launch failed with CUDA error {err} "
            f"({_lib().repro_adc_scan_error_string(err).decode()}) at "
            f"(B, L, m, C) = {shape}")


def occupancy(m: int, c: int, bf16: bool, vec: int) -> int:
    """Blocks of the scan one SM of the current device holds at once for an
    (m, C) table, as the runtime reports them (cached)."""
    key = (torch.cuda.current_device(), m, c, bf16, vec)
    if key not in _OCCUPANCY:
        per_sm = ctypes.c_int()
        err = _lib().repro_adc_scan_occupancy(m, c, bf16, vec,
                                              ctypes.byref(per_sm))
        _raise(err, (None, None, m, c))
        _OCCUPANCY[key] = per_sm.value
    return _OCCUPANCY[key]


def plan(luts: torch.Tensor, codes: torch.Tensor, config=None) -> ScanPlan:
    """The launch :func:`adc_scan_cuda` makes for these CUDA inputs at
    ``config`` (``None``: the formula)."""
    b, l, m, c = check_scan_inputs("adc_scan", luts, codes)
    with torch.cuda.device(luts.device):
        return _plan(luts, codes, b, l, m, c, config)


def _plan(luts, codes, b, l, m, c, config) -> ScanPlan:
    per_sm = occupancy(m, c, luts.dtype == torch.bfloat16,
                       code_vector_bytes(m, codes.data_ptr(), codes.stride(0)))
    sm_count = torch.cuda.get_device_properties(
        luts.device).multi_processor_count
    return scan_plan(b, l, per_sm, sm_count,
                     config.blocks if config is not None else 0)


def adc_scan_cuda(luts: torch.Tensor, codes: torch.Tensor, config=None
                  ) -> torch.Tensor:
    """ADC scan of a batch: (B, m, C) f32/bf16 tables and (B, L, m) uint8
    (or int32, cast to uint8) codes in ``[0, C)`` -> (B, L) f32 distances,
    each the f32 sum of one table entry per subspace in increasing
    subspace order.  The caller masks invalid candidate slots.
    ``config``: see the module docstring."""
    if isinstance(codes, torch.Tensor) and codes.dtype == torch.int32:
        codes = codes.to(torch.uint8)
    b, l, m, c = check_scan_inputs("adc_scan", luts, codes)
    if config is None:
        from . import autotune
        config = autotune.lookup("scan", b=b, l=l, msub=m, c=c,
                                 dtype=luts.dtype, device=luts.device)
    if luts.device.type == "cpu":
        return adc_scan_ref(luts, codes)
    if luts.device.type != "cuda":
        raise ValueError(f"adc_scan: unsupported device {luts.device}")
    dev = luts.device
    es = luts.element_size()
    out = torch.empty((b, l), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        err = _lib().repro_adc_scan(
            luts.data_ptr(), luts.stride(0), luts.dtype == torch.bfloat16,
            codes.data_ptr(), codes.stride(0), b, l, m, c,
            code_vector_bytes(m, codes.data_ptr(), codes.stride(0)),
            _plan(luts, codes, b, l, m, c, config).blocks,
            scan_vector_table(luts.data_ptr(), luts.stride(0) * es,
                              m * c * es),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise(err, (b, l, m, c))
    global launches
    launches += 1
    return out


def check_codes(codes: torch.Tensor, c: int) -> None:
    """Raise ``ValueError`` unless every code lies in ``[0, c)``.  A check
    for tests and debugging: it reads every code and synchronises, so no
    launch makes it."""
    lo, hi = int(codes.min()), int(codes.max())
    if lo < 0 or hi >= c:
        raise ValueError(f"adc_scan: codes span [{lo}, {hi}], outside "
                         f"[0, {c})")

