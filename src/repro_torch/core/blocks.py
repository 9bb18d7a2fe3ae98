"""The block layout of a leaf on a mesh: the storage under the train
state of :mod:`repro_torch.train.sharding`, read by the optimizers
(:mod:`repro_torch.optim`), the checkpoint (:mod:`repro_torch.ckpt`) and
the train step alike.

A spec (one entry per leading dim: a mesh axis name, a tuple of names, or
``None``) cuts each split dim of a leaf into equal parts over the product
of its entry's axes, in mesh order (a tuple entry in its axes' order), so
mesh position p holds one block, of the leaf's rank.  Positions that the
spec does not tell apart (a replicated leaf, a dim left whole) hold the
same block, stored once per distinct device, as
:func:`repro_torch.core.distributed.replicate` holds a copy: on one card
a mesh names ``cuda:0`` several times.  :func:`shard` cuts a whole leaf
into its blocks, :func:`gather` puts one back together on a device by
copies alone (exact), :func:`add_into` adds a whole gradient into a
layout's blocks on their devices, and :func:`position_bytes` counts what
each position holds.  A *region* of a leaf (what a "model" position
reads of it) has one entry a dim: a slice, or a tuple of slices, the
ranges of that dim taken in order and concatenated (Mamba2's
``in_proj``: its heads' ``z`` columns, their ``x`` columns, ``B``,
``C`` and their ``dt`` columns); :func:`gather` and :func:`add_into`
read and cut a region the same way.  A mesh here is a
:class:`~repro_torch.launch.mesh.Mesh` (``axis_names``, a ``shape``
dict and a ``devices`` array).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import tree


def axes_of(entry) -> tuple:
    """The mesh axes of one spec entry (a name or a tuple of names)."""
    return entry if isinstance(entry, tuple) else (entry,)


def ways(entry, mesh) -> int:
    """The number of parts a spec entry cuts its dim into on ``mesh``."""
    return math.prod(mesh.shape[a] for a in axes_of(entry))


def _region(shape, parts, key) -> tuple:
    """The slices of block ``key`` of a leaf of ``shape`` cut into
    ``parts`` along its dims."""
    return tuple(slice(i * (n // k), (i + 1) * (n // k))
                 for n, k, i in zip(shape, parts, key))


def _overlap(a: tuple, b: tuple):
    """The intersection of two regions (tuples of slices), or ``None``."""
    out = []
    for x, y in zip(a, b):
        lo, hi = max(x.start, y.start), min(x.stop, y.stop)
        if lo >= hi:
            return None
        out.append(slice(lo, hi))
    return tuple(out)


def _ranges(entry) -> tuple:
    """The ranges (slices) of one region entry, in order."""
    return entry if isinstance(entry, tuple) else (entry,)


def region_shape(region: tuple) -> list:
    """The shape of a region gathered: each dim the sum of its ranges."""
    return [sum(r.stop - r.start for r in _ranges(e)) for e in region]


def _pieces(region: tuple) -> list:
    """(a part of the leaf, of plain slices; where it lies in the region
    gathered) for each combination of the region's ranges (one, of no
    slices, for a 0-d leaf)."""
    pieces = [((), ())]
    for entry in region:
        at, grown = 0, []
        for r in _ranges(entry):
            where = slice(at, at + r.stop - r.start)
            grown += [(part + (r,), within + (where,))
                      for part, within in pieces]
            at = where.stop
        pieces = grown
    return pieces


def _within(sub: tuple, region: tuple) -> tuple:
    """``sub``, a part of ``region``, relative to ``region``'s start."""
    return tuple(slice(s.start - r.start, s.stop - r.start)
                 for s, r in zip(sub, region))


class Sharded:
    """One leaf in the block layout of its spec on a mesh.

    ``parts[i]`` is the number of equal parts dim i is cut into, a block's
    key its part along every dim; ``positions`` holds the (key, device) of
    every mesh position in mesh order, and ``blocks`` the tensor of each
    distinct (key, device): contiguous, of the leaf's rank, so a rule on
    ``dim()`` (AdamW's decay, Adafactor's factoring) reads a block as its
    leaf.  ``shape``, ``dtype``, ``dim()``, ``numel()`` and
    ``element_size()`` are the whole leaf's, so the spec functions and
    :func:`shard_bytes` read a tree of these as a tree of tensors."""

    def __init__(self, shape, dtype: torch.dtype, parts, positions: list,
                 blocks: dict, mesh=None):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.parts = tuple(parts)
        self.positions = positions
        self.blocks = blocks
        self.mesh = mesh

    @classmethod
    def whole(cls, t: torch.Tensor) -> "Sharded":
        """``t`` itself as a layout of one block (no copy)."""
        key = (0,) * t.dim()
        return cls(t.shape, t.dtype, (1,) * t.dim(), [(key, t.device)],
                   {(key, t.device): t})

    def dim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return math.prod(self.shape)

    def element_size(self) -> int:
        return self.dtype.itemsize

    @property
    def device(self) -> torch.device:
        """The first mesh position's device."""
        return self.positions[0][1]

    def region(self, key: tuple) -> tuple:
        return _region(self.shape, self.parts, key)

    def keys(self) -> list:
        """The distinct blocks' keys, in mesh order."""
        return list(dict.fromkeys(k for k, _ in self.positions))

    def units(self) -> list:
        """(key, device, tensor) of each stored block, in mesh order."""
        return [(k, d, self.blocks[(k, d)])
                for k, d in dict.fromkeys(self.positions)]

    def block(self, key: tuple, device=None) -> torch.Tensor:
        """Block ``key``: its copy on ``device`` where one is held there,
        else its first holder's."""
        if (key, device) in self.blocks:
            return self.blocks[(key, device)]
        return next(self.blocks[(k, d)] for k, d in self.positions
                    if k == key)

    def map(self, fn) -> "Sharded":
        """The same layout with ``fn(block)`` for each stored block."""
        blocks = {u: fn(t) for u, t in self.blocks.items()}
        return Sharded(self.shape, next(iter(blocks.values())).dtype,
                       self.parts, self.positions, blocks, self.mesh)

    def __repr__(self):
        return (f"Sharded({tuple(self.shape)}, {self.dtype}, parts="
                f"{self.parts}, {len(self.blocks)} blocks)")


def blocks_of(x) -> Sharded:
    """``x`` itself if it is a :class:`Sharded`, else a tensor as one
    block (:meth:`Sharded.whole`): the optimizers run one code over
    both."""
    return x if isinstance(x, Sharded) else Sharded.whole(x)


def is_sharded(t) -> bool:
    """Whether a tree's leaves are in the block layout."""
    return any(isinstance(x, Sharded) for x in tree.leaves(t))


def _layout(shape, spec, mesh) -> tuple:
    """(parts, [(key, device)] of every position of ``mesh``, in mesh
    order) of a leaf of ``shape`` under ``spec``."""
    entries = (list(spec) + [None] * len(shape))[:len(shape)]
    parts = tuple(1 if e is None else ways(e, mesh) for e in entries)
    for dim, (n, k) in enumerate(zip(shape, parts)):
        if n % k:
            raise ValueError(f"{spec} cuts dim {dim} of {tuple(shape)} into "
                             f"{k} unequal parts")
    positions = []
    for idx in np.ndindex(*mesh.devices.shape):
        at = dict(zip(mesh.axis_names, idx))
        key = tuple(0 if e is None else int(np.ravel_multi_index(
            tuple(at[a] for a in axes_of(e)),
            tuple(mesh.shape[a] for a in axes_of(e)))) for e in entries)
        positions.append((key, mesh.devices[idx]))
    return parts, positions


def shard(x: torch.Tensor, spec, mesh) -> Sharded:
    """``x`` cut into the blocks of ``spec`` on ``mesh``: each distinct
    (block, device) a copy of its slice, so ``x`` may be freed."""
    parts, positions = _layout(x.shape, spec, mesh)
    blocks: dict = {}
    for key, dev in positions:
        if (key, dev) not in blocks:
            src = x[_region(x.shape, parts, key)]
            blocks[(key, dev)] = torch.empty(src.shape, dtype=x.dtype,
                                             device=dev).copy_(src)
    return Sharded(x.shape, x.dtype, parts, positions, blocks, mesh)


def zeros(shape, dtype: torch.dtype, spec, mesh) -> Sharded:
    """A zeroed leaf of ``shape`` in the blocks of ``spec``."""
    parts, positions = _layout(shape, spec, mesh)
    blocks = {(k, d): torch.zeros([r.stop - r.start
                                   for r in _region(shape, parts, k)],
                                  dtype=dtype, device=d)
              for k, d in dict.fromkeys(positions)}
    return Sharded(shape, dtype, parts, positions, blocks, mesh)


def _read(s: Sharded, region: tuple, device, index: tuple = ()
          ) -> torch.Tensor:
    """A new tensor on ``device`` of ``region`` of ``s`` (of its member
    at ``index`` along the leading dims), copied from the blocks it
    overlaps."""
    k = len(index)
    out = torch.empty(region_shape(region), dtype=s.dtype, device=device)
    for part, at in _pieces(region):
        for key in s.keys():
            src = s.region(key)[k:]
            ov = _overlap(src, part)
            if ov is not None:
                out[at][_within(ov, part)].copy_(s.block(key, device)[index][
                    _within(ov, src)])
    return out


def gather(s: Sharded, device, index: tuple = (), region=None
           ) -> torch.Tensor:
    """The leaf whole on ``device``, or its member at ``index`` along its
    leading (stacking) dims, which no spec splits; with ``region`` (of
    that member) only that part of it (a "model" position's columns or
    rows, read over the blocks of every "data" position): its blocks
    copied into place, no arithmetic, so it is exact.  Where one block
    held on ``device`` is all of it (a leaf of one block, or a region
    that is one block), that block is given (a view at ``index``), not a
    copy."""
    device = torch.device(device)
    keys = s.keys()
    k = len(index)
    if any(p != 1 for p in s.parts[:k]):
        raise ValueError(f"gather: {s} is split along a stacking dim")
    if region is None:
        if len(keys) == 1 and (keys[0], device) in s.blocks:
            return s.blocks[(keys[0], device)][index]
        region = tuple(slice(0, n) for n in s.shape[k:])
    for key in keys:
        if s.region(key)[k:] == region and (key, device) in s.blocks:
            return s.blocks[(key, device)][index]
    return _read(s, region, device, index)


def add_into(s: Sharded, g: torch.Tensor, index: tuple = (), region=None
             ) -> None:
    """Add ``g`` (the whole leaf, or its member at ``index``; with
    ``region``, that part of it, cut as :func:`gather` puts it together)
    into each stored block of ``s``, the part of it the block holds, on
    the block's device: the owners' adds of a gradient into the
    accumulator."""
    k = len(index)
    if region is None:
        for key, dev, t in s.units():
            t[index].add_(g[s.region(key)[k:]].to(dev))
        return
    for part, at in _pieces(region):
        for key, dev, t in s.units():
            src = s.region(key)[k:]
            ov = _overlap(src, part)
            if ov is not None:
                t[index][_within(ov, src)].add_(
                    g[at][_within(ov, part)].to(dev))


def relayout(s: Sharded, like: Sharded) -> Sharded:
    """``s``'s values in the blocks of ``like``'s layout (new tensors,
    copied from the blocks each overlaps)."""
    blocks = {(k, d): _read(s, like.region(k), d)
              for k, d in dict.fromkeys(like.positions)}
    return Sharded(s.shape, s.dtype, like.parts, like.positions, blocks,
                   like.mesh)


def assign(dst: Sharded, src: Sharded) -> None:
    """Copy ``src``'s values into ``dst``'s blocks, in place, whatever
    the two layouts (an all-gather where ``dst`` is replicated)."""
    for key, dev, t in dst.units():
        region = dst.region(key)
        for skey in src.keys():
            sregion = src.region(skey)
            ov = _overlap(region, sregion)
            if ov is not None:
                t[_within(ov, region)].copy_(src.block(skey, dev)[
                    _within(ov, sregion)])


def moved(x, device):
    """A tensor (a step's scalar) on ``device``; a number as it is."""
    return x.to(device) if isinstance(x, torch.Tensor) else x


def sum_into(partials: dict, region: tuple, device) -> torch.Tensor:
    """``region`` of a sum over a leaf's blocks: f32 zeros on ``device``
    plus each partial (``{key: (its region, values)}``, in mesh order)
    where it overlaps."""
    out = torch.zeros([r.stop - r.start for r in region],
                      dtype=torch.float32, device=device)
    for r, t in partials.values():
        ov = _overlap(r, region)
        if ov is not None:
            out[_within(ov, region)].add_(t[_within(ov, r)].to(device))
    return out


def covering(units: dict, region: tuple, device) -> torch.Tensor:
    """``region`` of the first stored block (``{(key, device): (its
    region, values)}``) that holds all of it, one on ``device`` first."""
    held = sorted(units.items(), key=lambda u: u[0][1] != device)
    for _, (r, t) in held:
        if _overlap(r, region) == region:
            return t[_within(region, r)].to(device)
    raise ValueError(f"no block holds {region}")


def shard_tree(tree_like, specs, mesh):
    return tree.map_(lambda t, s: shard(t, s, mesh), tree_like, specs)


def gather_tree(tree_like, device):
    """Each :class:`Sharded` leaf whole on ``device`` (other leaves as
    they are)."""
    return tree.map_(lambda s: gather(s, device) if isinstance(s, Sharded)
                     else s, tree_like)


def position_bytes(tree_like, mesh) -> np.ndarray:
    """The bytes each mesh position holds of ``tree_like``'s
    :class:`Sharded` leaves: an int array of the mesh's shape."""
    out = np.zeros(mesh.devices.size, dtype=np.int64)
    for leaf in tree.leaves(tree_like):
        if isinstance(leaf, Sharded):
            for i, unit in enumerate(leaf.positions):
                t = leaf.blocks[unit]
                out[i] += t.numel() * t.element_size()
    return out.reshape(mesh.devices.shape)
