"""The PyTorch/CUDA port of the parallel sampling-based clustering system.

A second package beside the JAX reference (:mod:`repro`), with the same
module layout and public names, that imports ``torch`` and numpy and never
JAX or the reference.  Entry points run on the CUDA device unless told
otherwise (``device="cpu"`` runs the plain PyTorch versions).  The slice
ported so far is the main path: ``SampledKMeans(spec).fit(x)`` in single
mode, then ``predict``/``transform``/``score``, with hand-written Hopper
kernels for the Lloyd step and the assignment (:mod:`repro_torch.kernels`).
"""
__version__ = "0.1.0"
