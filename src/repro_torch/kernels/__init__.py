"""Hand-written CUDA kernels of the PyTorch port, for Hopper (sm_90a).

  lloyd.py / csrc/lloyd.cu    — fused Lloyd step: assignment + raw weighted
                                sums/counts + SSE in one pass (replaces
                                repro/kernels/lloyd.py::lloyd_step_pallas)
  assign.py / csrc/assign.cu  — nearest-center assignment (replaces
                                repro/kernels/assign.py::assign_argmin_pallas)
  csrc/distance.cuh           — the distance scan both kernels share
  ref.py                      — the plain PyTorch versions (CPU path, tests,
                                on-card parity)
  tiles.py                    — the launch contract (TileError, tile sizes)
  build.py                    — nvcc build at first use, ctypes loading

Importing this package builds nothing and touches no device: a kernel is
built the first time its wrapper is given a CUDA tensor.  For CPU tensors
the wrappers run the plain versions; for CUDA tensors they launch the
kernel or raise.
"""
from .assign import assign_argmin
from .lloyd import lloyd_step
from .tiles import TileError

__all__ = ["assign_argmin", "lloyd_step", "TileError"]
