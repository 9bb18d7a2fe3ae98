"""The two collectives of the "model" axis, between the M "model"
positions of one data shard (the roles of Megatron's f and g, or of the
all-gather and all-reduce GSPMD puts around a tensor-parallel layer):

* :func:`to_model`: the same activations on the device of each position
  (a view where the device repeats); its backward adds the positions'
  gradients in mesh order, in f32, rounded once, on the source's device;
* :func:`from_model`: the positions' partial results added in mesh
  order, in f32, rounded once to the activations' type, the sum placed on
  every position's device (a view where the device repeats); its backward
  hands the incoming gradient (in the sum's type) to each position.

The adds run in the fixed mesh order, never through autograd's
accumulation of a tensor used twice, so repeated runs are bit-identical.
At M = 1 both return their input itself: no copy, no add, no cast, so a
"model" axis of 1 computes exactly what one device does.

:class:`ModelSplit` is what a data shard's positions compute with, as
the models read it from ``ctx["model_split"]``: the positions' devices,
the per-position weights of each module computed over "model", and the
counts of :func:`from_model`'s adds.  This module knows nothing of the
models or of the train step.
"""
from __future__ import annotations

import torch


def _ordered_sum(ts, device, dtype: torch.dtype):
    """The non-``None`` tensors of ``ts`` added in their order on
    ``device``: one alone as it is (moved, cast), several in f32 and
    rounded once to ``dtype``; ``None`` if there are none."""
    ts = [t for t in ts if t is not None]
    if not ts:
        return None
    if len(ts) == 1:
        return ts[0].to(device=device, dtype=dtype)
    acc = ts[0].to(device=device, dtype=torch.float32)
    for t in ts[1:]:
        acc = acc + t.to(device=device, dtype=torch.float32)
    return acc.to(dtype)


def _placed(t: torch.Tensor, devices) -> tuple:
    """``t`` on each of ``devices``: a view of it where the device is its
    own, else a copy."""
    return tuple(t.view_as(t) if torch.device(d) == t.device else t.to(d)
                 for d in devices)


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, devices):
        ctx.set_materialize_grads(False)
        ctx.device, ctx.dtype = x.device, x.dtype
        return _placed(x, devices)

    @staticmethod
    def backward(ctx, *grads):
        return _ordered_sum(grads, ctx.device, ctx.dtype), None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dtype, devices, *parts):
        ctx.set_materialize_grads(False)
        ctx.dtype, ctx.parts = dtype, [(p.device, p.dtype) for p in parts]
        first = parts[0].device
        acc = parts[0].to(torch.float32)
        for p in parts[1:]:
            acc = acc + p.to(device=first, dtype=torch.float32)
        return _placed(acc.to(dtype), devices)

    @staticmethod
    def backward(ctx, *grads):
        # the sum's gradient, in the sum's type: each partial's gradient
        # holds values of that type
        g = _ordered_sum(grads, ctx.parts[0][0], ctx.dtype)
        if g is None:
            return (None, None) + (None,) * len(ctx.parts)
        return (None, None) + tuple(g.to(device=d, dtype=t)
                                    for d, t in ctx.parts)


def to_model(x: torch.Tensor, devices) -> tuple:
    """``x`` on the device of each "model" position (``devices``, in
    mesh order); at one position ``(x,)`` itself."""
    if len(devices) == 1:
        return (x,)
    return _ToModel.apply(x, list(devices))


def from_model(parts, devices, dtype: torch.dtype) -> tuple:
    """The sum of the positions' partial results ``parts`` (one on each
    position's device, in mesh order), added in mesh order in f32 on the
    first position's device and rounded once to ``dtype``, on each of
    ``devices``; at one position ``(parts[0],)`` itself."""
    if len(parts) == 1:
        return (parts[0],)
    return _FromModel.apply(dtype, list(devices), *parts)


class ModelSplit:
    """A data shard's "model" positions, as the models compute on them
    (``ctx["model_split"]``).

    ``devices`` are the positions' devices in mesh order; ``weights``
    maps a module computed over "model" to one ``{name within the
    module: tensor}`` per position (that position's part of each weight
    split over "model"); ``counts`` (shared with the caller) counts
    :meth:`from_model`'s calls (``from_model_adds``) and the bytes they
    moved (``from_model_bytes``: the f32 partials of positions 1 .. M-1
    to the first, and the rounded sum back to each of them).  With one
    device no module is split and both collectives are the identity."""

    def __init__(self, devices, weights=None, counts=None):
        self.devices = [torch.device(d) for d in devices]
        self.weights = dict(weights or {})
        self.counts = counts if counts is not None else {}
        self.counts.setdefault("from_model_adds", 0)
        self.counts.setdefault("from_model_bytes", 0)

    def parts(self, module):
        """The per-position weights of ``module``, or ``None`` where it
        computes whole."""
        return self.weights.get(module)

    def with_weights(self, more: dict) -> "ModelSplit":
        """The same positions and counts, with ``more`` modules' weights
        (a layer's, for its call)."""
        return ModelSplit(self.devices, {**self.weights, **more},
                          self.counts)

    def to_model(self, x: torch.Tensor) -> tuple:
        return to_model(x, self.devices)

    def from_model(self, parts, dtype: torch.dtype) -> tuple:
        if len(parts) > 1:
            n = parts[0].numel()
            self.counts["from_model_adds"] += 1
            self.counts["from_model_bytes"] += (len(parts) - 1) * n * (
                4 + dtype.itemsize)
        return from_model(parts, self.devices, dtype)
