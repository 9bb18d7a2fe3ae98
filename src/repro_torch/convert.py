"""Carry state across from the JAX package to the port.

A clustering system's "weights" are its spec and its fitted centers.  The
JAX package serialises a spec with ``ClusterSpec.to_dict()`` and its
results are arrays; here those become the port's objects, so a fit made
with the JAX package serves ``predict``/``transform``/``score`` from the
port.  Only plain Python and numpy cross over: nothing here imports the
JAX package.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.api import SampledKMeans
from repro_torch.core.device import resolve_device
from repro_torch.core.pipeline import SampledClusteringResult
from repro_torch.core.spec import ClusterSpec


def spec_from_reference(d: Mapping[str, Any]) -> ClusterSpec:
    """The port's spec for a dict from the JAX package's
    ``ClusterSpec.to_dict()`` (the two share one JSON form, so
    ``stable_hash()`` agrees)."""
    return ClusterSpec.from_dict(d)


def result_from_numpy(centers, sse, local_centers, local_weights, n_dropped,
                      *, device: "torch.device | str | None" = None
                      ) -> SampledClusteringResult:
    """A :class:`SampledClusteringResult` on ``device`` (``None``: the CUDA
    device) from the arrays of a JAX-package result (``np.asarray`` of each
    field, in field order)."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), device=dev)

    return SampledClusteringResult(t(centers), t(sse), t(local_centers),
                                   t(local_weights), t(n_dropped))


def estimator_from_numpy(spec_dict: Mapping[str, Any], centers, *,
                         device: "torch.device | str | None" = None
                         ) -> SampledKMeans:
    """A fitted :class:`SampledKMeans` on ``device`` from a JAX-package
    spec dict and its fitted (k, d) centers: ``predict``, ``transform``
    and ``score`` work at once (``sse_``/``result_`` stay unset)."""
    est = SampledKMeans(spec_from_reference(spec_dict), device=device)
    c = torch.as_tensor(np.array(centers), device=est.device)
    if c.dim() != 2 or c.shape[0] != est.spec.merge.k:
        raise ValueError(f"estimator_from_numpy: centers must be "
                         f"(k={est.spec.merge.k}, d), got {tuple(c.shape)}")
    est.centers_ = c
    return est
