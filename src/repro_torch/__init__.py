"""The PyTorch/CUDA port of the parallel sampling-based clustering system.

A second package beside the JAX reference (:mod:`repro`), with the same
module layout and public names, that imports ``torch`` and numpy and never
JAX or the reference.  Entry points run on the CUDA device unless told
otherwise (``device="cpu"`` runs the plain PyTorch versions).  Ported so
far: ``SampledKMeans(spec).fit(x)`` in single mode, then
``predict``/``transform``/``score``; the IVF/PQ index
(:mod:`repro_torch.index`); and clustered-KV decode serving of the decoder
LMs built from the attention block, dense, gemma3's local/global, MoE and
the VLM backbone, with their forward and loss (:mod:`repro_torch.models`,
:mod:`repro_torch.stream`, :mod:`repro_torch.serve`), each on
hand-written Hopper kernels (:mod:`repro_torch.kernels`).
"""
__version__ = "0.1.0"
