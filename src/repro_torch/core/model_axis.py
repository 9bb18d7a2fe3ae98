"""The two collectives of the "model" axis, between the M "model"
positions of one data shard (the roles of Megatron's f and g, or of the
all-gather and all-reduce GSPMD puts around a tensor-parallel layer):

* :func:`to_model`: the same activations on the device of each position
  (a view where the device repeats); its backward adds the positions'
  gradients in mesh order, in f32, rounded once, on the source's device;
* :func:`from_model`: the positions' partial results added in mesh
  order, in f32, rounded once to the activations' type, the sum placed on
  every position's device (a view where the device repeats); its backward
  hands the incoming gradient (in the sum's type) to each position;
* :func:`split_model`: equal slices of a whole tensor along one dim, each
  on its position's device (a view where the device repeats); its
  backward concatenates the positions' gradients in mesh order on the
  source's device, with no add;
* :func:`concat_model`: the positions' tensors concatenated along one dim
  on the first position's device; its backward hands each position its
  slice of the gradient.

The adds run in the fixed mesh order, never through autograd's
accumulation of a tensor used twice, so repeated runs are bit-identical.
At M = 1 all four return their input itself: no copy, no add, no cast, so a
"model" axis of 1 computes exactly what one device does.

:class:`ModelSplit` is what a data shard's positions compute with, as
the models read it from ``ctx["model_split"]``: the positions' devices,
the per-position weights of each module computed over "model", and the
counts of the collectives' calls and bytes.  This module knows nothing of the
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


class _SplitModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, devices):
        ctx.set_materialize_grads(False)
        ctx.device, ctx.dim = x.device, dim
        n = x.shape[dim] // len(devices)
        ctx.shape = x.shape[:dim] + (n,) + x.shape[dim + 1:]
        ctx.dtype = x.dtype
        return tuple(x.narrow(dim, m * n, n) if torch.device(d) == x.device
                     else x.narrow(dim, m * n, n).to(d)
                     for m, d in enumerate(devices))

    @staticmethod
    def backward(ctx, *grads):
        if all(g is None for g in grads):
            return None, None, None
        g = torch.cat([torch.zeros(ctx.shape, dtype=ctx.dtype,
                                   device=ctx.device) if g is None
                       else g.to(ctx.device) for g in grads], ctx.dim)
        return g, None, None


class _ConcatModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, *parts):
        ctx.set_materialize_grads(False)
        ctx.dim, ctx.parts = dim, [(p.device, p.shape[dim]) for p in parts]
        first = parts[0].device
        return torch.cat([p.to(first) for p in parts], dim)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return (None,) * (1 + len(ctx.parts))
        out, at = [], 0
        for dev, n in ctx.parts:
            out.append(g.narrow(ctx.dim, at, n).to(dev))
            at += n
        return (None, *out)


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


def split_model(x: torch.Tensor, devices, dim: int) -> tuple:
    """``x`` cut into ``len(devices)`` equal slices along ``dim``, slice m
    on position m's device (a view of ``x`` where that is ``x``'s own),
    in mesh order; the backward concatenates the slices' gradients on
    ``x``'s device, in mesh order (zeros for a slice with none), so no
    gradient is added.  At one position ``(x,)`` itself."""
    if len(devices) == 1:
        return (x,)
    if x.shape[dim] % len(devices):
        raise ValueError(f"split_model: {len(devices)} positions do not "
                         f"divide dim {dim} of {tuple(x.shape)}")
    return _SplitModel.apply(x, dim, list(devices))


def concat_model(parts, dim: int) -> torch.Tensor:
    """The positions' ``parts`` (in mesh order) concatenated along ``dim``
    on the first one's device; the backward hands each part its slice of
    the gradient, on its own device.  At one position ``parts[0]``
    itself."""
    if len(parts) == 1:
        return parts[0]
    return _ConcatModel.apply(dim, *parts)


COUNTS = ("from_model_adds", "from_model_bytes", "split_model_calls",
          "split_model_bytes", "concat_model_calls", "concat_model_bytes")


class ModelSplit:
    """A data shard's "model" positions, as the models compute on them
    (``ctx["model_split"]``).

    ``devices`` are the positions' devices in mesh order; ``weights``
    maps a module computed over "model" to one ``{name within the
    module: tensor}`` per position (that position's part of each weight
    split over "model"); ``counts`` (shared with the caller) counts
    :meth:`from_model`'s calls (``from_model_adds``) and the bytes they
    moved (``from_model_bytes``: the f32 partials of positions 1 .. M-1
    to the first, and the rounded sum back to each of them), and those of
    :meth:`split_model` and :meth:`concat_model` (``split_model_calls``,
    ``concat_model_calls``; ``split_model_bytes``, ``concat_model_bytes``:
    the slices of positions 1 .. M-1, sent from or to the first; made on
    their first call).  With one device no module is split and every
    collective is the identity."""

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

    def _count(self, name: str, parts_bytes: int) -> None:
        for key, n in ((name + "_calls", 1), (name + "_bytes", parts_bytes)):
            self.counts[key] = self.counts.get(key, 0) + n

    def split_model(self, x: torch.Tensor, dim: int) -> tuple:
        n = len(self.devices)
        if n > 1:
            self._count("split_model",
                        (n - 1) * x.numel() // n * x.element_size())
        return split_model(x, self.devices, dim)

    def concat_model(self, parts, dim: int) -> torch.Tensor:
        if len(parts) > 1:
            self._count("concat_model", sum(p.numel() * p.element_size()
                                            for p in parts[1:]))
        return concat_model(parts, dim)
