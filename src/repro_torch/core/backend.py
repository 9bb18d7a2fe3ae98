"""The ``LloydBackend`` registry: one abstraction for every k-means hot loop.

The port's counterpart of :mod:`repro.core.backend`, with a leading batch
axis on everything (the JAX package's ``vmap`` written out): B is the
partitions of the local stage or the restarts of the merge.  A backend owns

  * ``prepare(x, weights)`` — (B, m, d) points + (B, m) weights, once per
    ``kmeans()`` call, outside the Lloyd loop (no padding: the kernels
    mask ragged shapes themselves);
  * ``assign(prep, centers)`` — nearest-center id + squared distance;
  * ``step(prep, centers)`` — one Lloyd pass: the RAW weighted per-cluster
    ``sums``/``counts`` (the caller divides), the weighted ``sse``, and the
    ``idx``/``dist`` the pass computed anyway (:class:`LloydStats`);
  * ``sse(prep, centers)`` — weighted SSE only;
  * ``assign_points(x, centers)`` — the one-shot (m, d) query path.

Built-in backends:

  ``torch``       the plain PyTorch versions (:mod:`repro_torch.kernels.ref`)
  ``cuda``        unfused kernels: ``step`` is ``csrc/assign.cu`` then
                  ``csrc/centroid.cu`` (two passes over the points), and
                  ``csrc/assign.cu`` serves ``assign``/``assign_points``
  ``cuda_fused``  ``step`` is the fused ``csrc/lloyd.cu`` (one pass); the
                  rest as ``cuda``
  ``cuda_tuned``  ``cuda_fused`` with each launch's parameters looked up in
                  the tuner's cache (``kernels/autotune.py``: the LRU, the
                  ``REPRO_TORCH_TUNE_CACHE`` file, the committed table, the
                  derived plan); with the derived plan it is ``cuda_fused``
                  bit for bit
  ``auto``        ``REPRO_KMEANS_BACKEND`` if set, else ``cuda_tuned`` for
                  CUDA tensors and ``torch`` for CPU tensors

Given CPU tensors, the kernel wrappers of ``cuda``/``cuda_fused`` run the
plain versions.

``register_backend`` adds custom entries.
"""
from __future__ import annotations

import os
from typing import Callable, NamedTuple, Optional, Union

import torch

ENV_VAR = "REPRO_KMEANS_BACKEND"


class Prepared(NamedTuple):
    """The point set of one ``kmeans()`` call: (B, m, d) points and (B, m)
    weights (0 = masked slot, which contributes to no statistic)."""
    x: torch.Tensor
    w: torch.Tensor
    m: int
    d: int


class LloydStats(NamedTuple):
    """One Lloyd pass over a batch, all f32 but ``idx``."""
    sums: torch.Tensor     # (B, k, d) raw weighted per-cluster sums
    counts: torch.Tensor   # (B, k) raw weighted member counts
    sse: torch.Tensor      # (B,) weighted SSE at the given centers
    idx: torch.Tensor      # (B, m) int32 nearest center
    dist: torch.Tensor     # (B, m) squared distance to it


class LloydBackend:
    """Base class: the plain PyTorch implementation, and the contract."""

    name = "torch"

    def prepare(self, x: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> Prepared:
        b, m, d = x.shape
        if weights is None:
            weights = torch.ones((b, m), dtype=x.dtype, device=x.device)
        return Prepared(x, weights.to(x.dtype), m, d)

    def assign(self, prep: Prepared, centers: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        from repro_torch.kernels.ref import assign_argmin_ref
        return assign_argmin_ref(prep.x, centers)

    def step(self, prep: Prepared, centers: torch.Tensor) -> LloydStats:
        from repro_torch.kernels.ref import lloyd_step_ref
        return LloydStats(*lloyd_step_ref(prep.x, prep.w, centers))

    def sse(self, prep: Prepared, centers: torch.Tensor) -> torch.Tensor:
        _, dist = self.assign(prep, centers)
        w = prep.w.float()
        return torch.where(w != 0, dist * w, 0.0).sum(-1)

    def assign_points(self, x: torch.Tensor, centers: torch.Tensor, *,
                      block: Optional[int] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """Nearest-center id + squared distance per row of one (m, d)
        point set against one (k, d) center set.  With ``block`` the rows
        go ``block`` at a time, so the plain version's working set is
        O(block · k); each row's result depends on that row alone, so the
        values match the unblocked call."""
        m = x.shape[0]
        step = m if block is None or m <= block else block
        parts = [self.assign(self.prepare(x[None, i:i + step]),
                             centers[None]) for i in range(0, m, step)]
        idx = torch.cat([p[0][0] for p in parts])
        dist = torch.cat([p[1][0] for p in parts])
        return idx, dist

    # structural equality/hash: get_backend() returns a fresh instance per
    # resolution, but two same-type/same-config backends are the same
    # computation
    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self), tuple(sorted(self.__dict__.items(),
                                              key=lambda kv: kv[0]))))

    def __repr__(self):
        return f"<LloydBackend {self.name}>"


class CudaBackend(LloydBackend):
    """Unfused Hopper kernels, the counterpart of the JAX package's
    ``pallas`` backend: each Lloyd step is an assignment pass
    (``kernels/assign.py``) and a centroid-update pass
    (``kernels/centroid.py``), so it reads the points twice.  The
    assignment kernel also serves ``assign`` and the query path; it never
    forms the (m, k) distance matrix, so ``assign_points`` launches once
    for all rows of a CUDA tensor whatever ``block`` says.  Each launch
    runs the derived plan of ``kernels/tiles.py`` (``_config`` gives
    ``None``)."""

    name = "cuda"

    def _config(self, kernel: str, x: torch.Tensor, k: int):
        """The launch config of ``kernel`` on the (B, M, d) ``x`` against
        ``k`` centers: ``None``, the derived plan."""
        return None

    def assign(self, prep: Prepared, centers: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        from repro_torch.kernels.assign import assign_argmin
        return assign_argmin(prep.x, centers, self._config(
            "assign", prep.x, centers.shape[1]))

    def step(self, prep: Prepared, centers: torch.Tensor) -> LloydStats:
        from repro_torch.kernels.centroid import centroid_update
        idx, dist = self.assign(prep, centers)
        sums, counts = centroid_update(prep.x, idx, prep.w, centers.shape[1])
        w = prep.w.float()
        sse = torch.where(w != 0, dist * w, 0.0).sum(-1)
        return LloydStats(sums, counts, sse, idx, dist)

    def assign_points(self, x: torch.Tensor, centers: torch.Tensor, *,
                      block: Optional[int] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        if x.device.type == "cuda":
            block = None
        return super().assign_points(x, centers, block=block)


class CudaFusedBackend(CudaBackend):
    """The fused backend: one pass per Lloyd iteration (``kernels/lloyd.py``:
    assignment, weighted statistics and SSE together)."""

    name = "cuda_fused"

    def step(self, prep: Prepared, centers: torch.Tensor) -> LloydStats:
        from repro_torch.kernels.lloyd import lloyd_step
        return LloydStats(*lloyd_step(prep.x, prep.w, centers, self._config(
            "lloyd", prep.x, centers.shape[1])))


class CudaTunedBackend(CudaFusedBackend):
    """The fused backend with each launch's parameters looked up in the
    tuner's cache (:mod:`repro_torch.kernels.autotune`) instead of the
    derived plan: ``step`` looks up ``lloyd`` and ``assign`` looks up
    ``assign``.  A lookup is a host-side dict read keyed on the call's own
    (B, M, d), K, dtype and card; the tensor-core routes ignore the config.
    At the derived plan (an empty cache, the table's ``"*"`` rows) it is
    ``cuda_fused`` bit for bit; a row's ``lloyd`` blocks may move the last
    bits of the sums.

    The reference's tuned backend carries a K hint because its point
    padding depends on a tile keyed on K; here every lookup keys on its
    own launch and nothing is padded by a config, so the backend holds no
    state (``api.plan`` pre-warms the fit's shapes instead)."""

    name = "cuda_tuned"

    def _config(self, kernel: str, x: torch.Tensor, k: int):
        from repro_torch.kernels import autotune
        b, m, d = x.shape
        return autotune.lookup(kernel, b=b, m=m, d=d, k=k, dtype=x.dtype,
                               device=x.device)


BackendSpec = Union[str, LloydBackend, None]

_REGISTRY: dict[str, Callable[[], LloydBackend]] = {
    "torch": LloydBackend,
    "cuda": CudaBackend,
    "cuda_fused": CudaFusedBackend,
    "cuda_tuned": CudaTunedBackend,
}


def register_backend(name: str, factory: Callable[[], LloydBackend]) -> None:
    """Register a custom backend under ``name`` (callable returning an
    instance; called per ``get_backend`` resolution)."""
    _REGISTRY[name] = factory


def get_backend(spec: BackendSpec = None, *,
                device: "torch.device | str | None" = None) -> LloydBackend:
    """Resolve a backend: instance passthrough, name lookup, or ``None`` /
    ``"auto"`` -> ``REPRO_KMEANS_BACKEND`` env override, then the device
    the data lives on: ``torch`` for the CPU, ``cuda_tuned`` otherwise
    (``device=None`` means the entry points' default, CUDA)."""
    if isinstance(spec, LloydBackend):
        return spec
    name = spec or "auto"
    if name == "auto":
        name = os.environ.get(ENV_VAR) or "auto"
    if name == "auto":
        on_cpu = device is not None and torch.device(device).type == "cpu"
        name = "torch" if on_cpu else "cuda_tuned"
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise ValueError(
            f"unknown k-means backend {name!r}; known: "
            f"{sorted(_REGISTRY)} + 'auto'") from None


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY)) + ("auto",)
