"""The paper's two subclustering schemes (Algorithms 1 & 2), vectorised.

The port's counterpart of :mod:`repro.core.subcluster`, with the same
partitions, index for index.

Algorithm 1 (equal sized): with a fixed landmark L (the per-attribute
minimum), "repeatedly take the N points closest to L" is exactly "sort all
points by distance to L and cut into consecutive chunks of N" — one device
sort.  The sort is stable, as the reference's ``jnp.argsort``, so ties keep
point order.

Algorithm 2 (unequal sized): P evenly spaced landmarks on the segment
[L, H]; each point joins its nearest landmark.  Partition sizes are bounded
by a *capacity* (``ceil(M/P * capacity_factor)`` slots, MoE-router style);
overflow points are dropped from the local stage and counted in
``n_dropped``.
"""
from __future__ import annotations

import warnings
from typing import Callable, NamedTuple

import torch

from .kmeans import _linspace01


class Partition(NamedTuple):
    """Fixed-shape partition: ``indices[p, s]`` is the point id of slot
    ``s`` in partition ``p`` (0 where ``mask`` is False)."""
    indices: torch.Tensor    # (P, capacity) int64
    mask: torch.Tensor       # (P, capacity) bool
    n_dropped: torch.Tensor  # () int64 — points over capacity (Algo 2 only)


def feature_scale(x: torch.Tensor, eps: float = 1e-9
                  ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Min-max feature scaling (paper step 2); returns the scaled points and
    the (lo, span) pair that maps centers back to the input space."""
    lo = x.amin(0)
    span = (x.amax(0) - lo).clamp_min(eps)
    return (x - lo) / span, (lo, span)


def unscale(centers: torch.Tensor,
            params: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    lo, span = params
    return centers * span + lo


def equal_partition(x: torch.Tensor, n_sub: int) -> Partition:
    """Algorithm 1.  ``n_sub`` partitions of ceil(M/n_sub) slots; when M is
    not divisible the trailing slots of the last partition are masked."""
    m = x.shape[0]
    cap = -(-m // n_sub)  # ceil
    landmark = x.amin(0)
    d = ((x - landmark[None, :]) ** 2).sum(-1)
    order = torch.argsort(d, stable=True)
    pad = torch.full((n_sub * cap - m,), -1, dtype=order.dtype,
                     device=x.device)
    idx = torch.cat([order, pad]).view(n_sub, cap)
    mask = idx >= 0
    return Partition(torch.where(mask, idx, 0), mask,
                     torch.zeros((), dtype=torch.int64, device=x.device))


def unequal_landmarks(x: torch.Tensor, n_landmarks: int) -> torch.Tensor:
    """P evenly spaced landmarks on the [per-attr min, per-attr max]
    segment."""
    lo = x.amin(0)
    hi = x.amax(0)
    t = _linspace01(n_landmarks, x.dtype, x.device)[:, None]
    return lo[None, :] + t * (hi - lo)[None, :]


def unequal_partition(
    x: torch.Tensor, n_landmarks: int, *, capacity_factor: float = 2.0,
    capacity: int | None = None,
) -> Partition:
    """Algorithm 2 with MoE-style capacity bounding (see module docstring)."""
    m = x.shape[0]
    if capacity is None:
        if capacity_factor < 1.0:
            warnings.warn(
                f"unequal_partition: capacity_factor={capacity_factor} < 1 "
                f"bounds every partition below the even split "
                f"ceil(M/P)={-(-m // n_landmarks)}; overflow points WILL be "
                f"dropped from the local stage (n_dropped stays exact)",
                stacklevel=2)
        capacity = int(-(-m // n_landmarks) * capacity_factor)
        if capacity > m:
            warnings.warn(
                f"unequal_partition: capacity "
                f"ceil(M/P)*capacity_factor={capacity} exceeds M={m}; "
                f"clamping to M (capacity_factor={capacity_factor} has no "
                f"further effect at this size)", stacklevel=2)
        capacity = min(capacity, m)
    lms = unequal_landmarks(x, n_landmarks)
    d = ((x * x).sum(-1, keepdim=True) + (lms * lms).sum(-1)[None, :]
         - 2.0 * (x @ lms.T))
    assign = d.argmin(-1)

    order = torch.argsort(assign, stable=True)
    sorted_assign = assign[order]
    # rank of each point within its landmark group
    groups = torch.arange(n_landmarks, device=x.device)
    starts = torch.searchsorted(sorted_assign, groups, right=False)
    rank = torch.arange(m, device=x.device) - starts[sorted_assign]
    keep = rank < capacity
    slot = sorted_assign * capacity + rank
    flat = torch.full((n_landmarks * capacity,), -1, dtype=order.dtype,
                      device=x.device)
    flat[slot[keep]] = order[keep]          # overflow slots are masked out
    idx = flat.view(n_landmarks, capacity)
    mask = idx >= 0
    n_dropped = m - keep.sum()
    return Partition(torch.where(mask, idx, 0), mask, n_dropped)


def gather_partitions(x: torch.Tensor, part: Partition,
                      weights: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Materialise (P, capacity, d) point blocks + (P, capacity) weights.

    With ``weights`` (per-point mass, e.g. the member counts of a weighted
    center pool in the reduce tree) each slot carries ``mask *
    weights[index]`` instead of the 0/1 mask, so mass is conserved level
    to level."""
    pts = x[part.indices]
    w = part.mask.to(x.dtype)
    if weights is not None:
        w = w * weights.to(x.dtype)[part.indices]
    return pts, w


# ---------------------------------------------------------------------------
# Partitioner registry: ``(x, n_sub, capacity_factor) -> Partition``, what
# PartitionSpec.scheme / LevelSpec.scheme resolve against
# ---------------------------------------------------------------------------

PartitionerFn = Callable[[torch.Tensor, int, float], Partition]

_PARTITIONERS: dict[str, PartitionerFn] = {
    "equal": lambda x, n_sub, capacity_factor: equal_partition(x, n_sub),
    "unequal": lambda x, n_sub, capacity_factor: unequal_partition(
        x, n_sub, capacity_factor=capacity_factor),
}


def register_partitioner(name: str, fn: PartitionerFn) -> None:
    """Register ``fn(x, n_sub, capacity_factor) -> Partition`` under
    ``name`` (resolvable from ``PartitionSpec.scheme``)."""
    _PARTITIONERS[name] = fn


def get_partitioner(name: str) -> PartitionerFn:
    try:
        return _PARTITIONERS[name]
    except KeyError:
        raise ValueError(
            f"unknown partition scheme {name!r}; known: "
            f"{sorted(_PARTITIONERS)}") from None


def available_partitioners() -> tuple[str, ...]:
    return tuple(sorted(_PARTITIONERS))
