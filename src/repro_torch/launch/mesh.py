"""Device meshes of the PyTorch port: the counterpart of
:mod:`repro.launch.mesh` (and of the JAX package's ``compat.make_mesh``).

A :class:`Mesh` is an ordered array of ``torch.device``s with named axes.
The multi-device executors (:mod:`repro_torch.core.distributed`) run one
controller over it: the ``i``-th entry along the data axis is shard ``i``,
whose work is queued on that entry's device, and the collectives are
explicit combinations in mesh order.

A mesh may name one device several times.  Its shards then run one after
another on that device with the multi-shard semantics unchanged, as the
JAX package's tests run W virtual CPU devices on one host
(``--xla_force_host_platform_device_count``): the sharded paths can be
tested on the CPU in one process, and run on a single card.

The constructors are functions: importing this module touches no device.
"""
from __future__ import annotations

import math
from typing import Iterable, Sequence

import numpy as np
import torch


def _device(d: "torch.device | str") -> torch.device:
    """A mesh entry: the CPU, or a CUDA card that exists (an index-less
    ``"cuda"`` means the current card)."""
    dev = torch.device(d)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"mesh: unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"mesh: {dev} named, but no CUDA device is "
                           f"available")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise ValueError(f"mesh: {dev} named, but only "
                         f"{torch.cuda.device_count()} CUDA devices exist")
    return torch.device("cuda", index)


class Mesh:
    """An ordered array of devices with one name per axis.

    ``devices`` is a numpy object array of ``torch.device`` of the mesh's
    shape, ``axis_names`` a tuple, ``shape`` a dict from axis name to size
    (as a JAX mesh's).  Entries may repeat."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        self.devices = np.empty(devices.shape, dtype=object)
        for i in np.ndindex(devices.shape):
            self.devices[i] = _device(devices[i])
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh: {self.devices.ndim}-D devices for axes "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh: repeated axis name in "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis``, the other axes at index 0: one per
        shard of data split along ``axis`` (a sharded array is replicated
        along the other axes)."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no {axis!r} axis (axes: "
                             f"{self.axis_names})")
        pick = tuple(slice(None) if a == axis else 0
                     for a in self.axis_names)
        return list(self.devices[pick])

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def check_mesh(mesh) -> Mesh:
    """``mesh`` itself, if it is a :class:`Mesh`; a ``TypeError``
    otherwise (a JAX mesh included)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"expected a repro_torch.launch.mesh.Mesh as mesh=, "
                        f"got {type(mesh).__name__}")
    return mesh


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Iterable | None = None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes``.  With ``devices=None``
    it takes the first ``prod(shape)`` CUDA cards and raises when there are
    fewer (it never substitutes the CPU); an explicit list (``torch.device``
    or strings, in mesh order) may repeat a device."""
    n = math.prod(shape)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass devices= "
                "(e.g. ['cpu'] * n) for a mesh on the CPU")
        count = torch.cuda.device_count()
        if count < n:
            raise ValueError(f"make_mesh: a {tuple(shape)} mesh needs {n} "
                             f"CUDA devices, {count} are visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    if len(devices) != n:
        raise ValueError(f"make_mesh: {len(devices)} devices for a "
                         f"{tuple(shape)} mesh")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(shape)), axes)


class AbstractMesh:
    """A mesh's axis names and sizes without devices (JAX's
    ``AbstractMesh``): what the partition rules
    (:mod:`repro_torch.train.sharding`) read, for meshes larger than the
    visible cards (the dry run's production meshes)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh: shape {tuple(shape)} for axes "
                             f"{tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.size = math.prod(shape)

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def _production(multi_pod: bool) -> tuple[tuple, tuple]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 devices ("data", "model"); two pods add a leading "pod"
    axis.  Raises with fewer CUDA cards."""
    return make_mesh(*_production(multi_pod))


def production_mesh_shape(*, multi_pod: bool = False) -> AbstractMesh:
    """The axes of :func:`make_production_mesh`, without its devices."""
    return AbstractMesh(*_production(multi_pod))


def make_host_mesh(n_data: int = 1, n_model: int = 1, *,
                   device: "torch.device | str | None" = None) -> Mesh:
    """A small ("data", "model") mesh for tests and examples: the first
    ``n_data * n_model`` cards, or with ``device`` that one device repeated
    (``device="cpu"`` for the plain versions)."""
    n = n_data * n_model
    return make_mesh((n_data, n_model), ("data", "model"),
                     None if device is None else [device] * n)
