"""Hand-written CUDA kernels of the PyTorch port, for Hopper (sm_90a).

  lloyd.py / csrc/lloyd.cu       — Lloyd step: assignment + raw weighted
                                   sums/counts + SSE (replaces
                                   repro/kernels/lloyd.py::
                                   lloyd_step_pallas); a fused SIMT pass
                                   for small d, a tensor-core argmin and
                                   the centroid update for d >= 32
  assign.py / csrc/assign.cu     — nearest-center assignment (replaces
                                   repro/kernels/assign.py::
                                   assign_argmin_pallas)
  centroid.py / csrc/centroid.cu — weighted centroid update, the unfused
                                   backend's second pass (replaces
                                   repro/kernels/centroid.py::
                                   centroid_update_pallas)
  scan.py / csrc/adc_scan.cu     — the IVF/PQ ADC scan (replaces
                                   repro/kernels/scan.py::adc_scan_pallas)
  cluster_attn.py /              — decode attention over a clustered KV
    csrc/cluster_attn.cu           cache (replaces repro/kernels/
                                   cluster_attn.py::
                                   cluster_attn_decode_pallas)
  csrc/distance.cuh              — loads, center staging, the distance scan
  csrc/tc_argmin.cuh             — the nearest center on the tensor cores
                                   (wgmma, three TF32 passes)
  csrc/accumulate.cuh            — the Lloyd kernel's per-block statistics
                                   and their fixed-order reduction
  csrc/warp.cuh                  — ballot grouping and warp sums
  ref.py                         — the plain PyTorch versions (CPU path,
                                   tests, on-card parity)
  tiles.py                       — the launch contract (TileError, tiles,
                                   the clamps of a tuned launch)
  autotune.py                    — the launch-parameter tuner: lookup
                                   (LRU, REPRO_TORCH_TUNE_CACHE file,
                                   table, derived plan), tune, the sweep
                                   CLI; tunes the SIMT Lloyd and assign
                                   routes' center tile and blocks (and
                                   assign's points per thread) and the
                                   scan's blocks; sweeps the centroid
                                   warp path's blocks on request
  tune_table.py                  — the committed per-card, per-bucket rows
  build.py                       — nvcc build at first use, ctypes loading

Importing this package builds nothing and touches no device: a kernel is
built the first time its wrapper is given a CUDA tensor.  For CPU tensors
the wrappers run the plain versions; for CUDA tensors they launch the
kernel or raise.
"""
from .assign import assign_argmin
from .centroid import centroid_update
from .cluster_attn import cluster_attn_decode, cluster_attn_partial
from .lloyd import lloyd_step
from .scan import adc_scan_cuda
from .tiles import TileError

__all__ = ["assign_argmin", "centroid_update", "lloyd_step", "adc_scan_cuda",
           "cluster_attn_partial", "cluster_attn_decode", "TileError",
           "TileConfig", "lookup", "prewarm", "tune"]
_TUNER = ("TileConfig", "lookup", "prewarm", "tune")


def __getattr__(name):
    # the tuner's names load on first use, so that
    # ``python -m repro_torch.kernels.autotune`` runs the module only once
    if name in _TUNER:
        from . import autotune
        return getattr(autotune, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
