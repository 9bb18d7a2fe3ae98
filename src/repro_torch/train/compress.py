"""Gradient compression by 1-D k-means quantization (the counterpart of
:mod:`repro.train.compress`).

Each leaf of a gradient tree is quantized to ``levels`` centroids fit by
the port's k-means (:func:`repro_torch.core.kmeans.kmeans`) on a sample
of its values.  With error feedback the quantization residual is carried
into the next step.  On the card each leaf's fit runs the Lloyd kernel
(``csrc/lloyd.cu``) on one lane of 4096 values at d = 1, ``max_iters``
launches plus the final pass.  The default init is ``"landmark"``, which
draws nothing, so the codebooks are the reference's.
"""
from __future__ import annotations

import math

import torch

from repro_torch import tree
from repro_torch.core.backend import BackendSpec
from repro_torch.core.device import derive_seed
from repro_torch.core.kmeans import kmeans
from repro_torch.core.spec import ClusterSpec, StopSpec

SAMPLE = 4096          # values a leaf's codebook is fit on
ARGMIN_ROWS = 1 << 24  # values assigned to the codebook at a time


def quantize_leaf(g: torch.Tensor, levels: int,
                  seed: "int | torch.Generator" = 0,
                  backend: BackendSpec = None, *, iters: int | None = None,
                  stop: StopSpec | None = None,
                  init: str = "landmark") -> tuple[torch.Tensor, dict]:
    """-> (dequantized g, {"codebook": (levels,) f32}).  1-D k-means on
    every ``n // 4096``-th value of the flattened leaf (at most 4096 of
    them), then each value replaced by its nearest code (the first at a
    tie).  ``stop`` carries the stopping policy (``iters`` is the
    fixed-budget alias; default 8); ``seed`` takes the place of the
    reference's ``key`` (a landmark init draws nothing)."""
    if stop is None:
        stop = StopSpec(max_iters=8 if iters is None else iters)
    elif iters is not None:
        raise TypeError("quantize_leaf: pass either stop= or the deprecated "
                        "iters= alias, not both")
    flat = g.reshape(-1, 1).to(torch.float32)
    n = flat.shape[0]
    samp = flat[::max(1, n // SAMPLE)][:SAMPLE].contiguous()
    res = kmeans(samp, levels, stop=stop, seed=seed, init=init,
                 backend=backend, device=g.device)
    code = res.centers[:, 0]                       # (levels,)
    deq = torch.empty(n, dtype=torch.float32, device=g.device)
    for s in range(0, n, ARGMIN_ROWS):
        part = flat[s:s + ARGMIN_ROWS]
        deq[s:s + ARGMIN_ROWS] = code[(part - code[None, :]).abs()
                                      .argmin(-1)]
    return deq.reshape(g.shape).to(g.dtype), {"codebook": code}


def make_grad_compressor(levels: int = 16, error_feedback: bool = True,
                         seed: int = 0, backend: BackendSpec = None,
                         spec: ClusterSpec | None = None):
    """Returns compress_fn(grads, residual=None) -> (grads', residual').

    With ``spec=`` the codebook fit is declared as a ClusterSpec:
    ``merge.k`` is the level count, ``merge.effective_stop``/``merge.init``
    configure the 1-D k-means, ``execution.backend`` the Lloyd machinery.
    Leaf i of the tree (in sorted-key order) fits from
    ``derive_seed(seed, i)``.
    """
    if spec is not None:
        levels = spec.merge.k
        stop, init = spec.merge.effective_stop, spec.merge.init
        backend = backend if backend is not None else spec.execution.backend
    else:
        stop, init = StopSpec(max_iters=8), "landmark"

    @torch.no_grad()
    def compress(grads, residual=None):
        paths = [p for p, _ in tree.items(grads)]
        res_leaves = (tree.leaves(residual) if residual is not None
                      else [None] * len(paths))
        out, new_res = [], []
        for i, (g, r) in enumerate(zip(tree.leaves(grads), res_leaves)):
            if r is None:
                r = torch.zeros_like(g)
            gc = g + r if error_feedback else g
            deq, _ = quantize_leaf(gc, levels, derive_seed(seed, i),
                                   backend=backend, stop=stop, init=init)
            out.append(deq)
            new_res.append((gc - deq) if error_feedback else r)
            del gc, r
        return tree.unflatten(paths, out), tree.unflatten(paths, new_res)

    return compress


def compressed_bytes(grads, levels: int) -> tuple[int, int]:
    """(raw fp32 bytes, compressed payload bytes) for the cross-pod
    exchange."""
    bits = max(1, math.ceil(math.log2(levels)))
    raw = comp = 0
    for g in tree.leaves(grads):
        raw += g.numel() * 4
        comp += (g.numel() * bits) // 8 + levels * 4
    return raw, comp
