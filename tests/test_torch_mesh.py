"""The port's device meshes (``repro_torch.launch.mesh``): explicit meshes
on the CPU (entries may repeat), the constructors' shapes and axis names
as the JAX package's ``launch.mesh`` gives them, and no silent CPU in
place of a missing card."""
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import (Mesh, check_mesh, make_host_mesh,
                                     make_mesh, make_production_mesh)


def test_explicit_mesh_repeats_a_device():
    mesh = make_mesh((4,), ("data",), ["cpu"] * 4)
    assert isinstance(mesh, Mesh)
    assert mesh.axis_names == ("data",)
    assert mesh.shape == {"data": 4} and mesh.size == 4
    assert mesh.devices.shape == (4,)
    assert mesh.axis_devices("data") == [torch.device("cpu")] * 4
    assert list(mesh.devices.flat) == [torch.device("cpu")] * 4


def test_two_axis_mesh_shards_along_one_axis():
    mesh = make_host_mesh(2, 3, device="cpu")
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 2, "model": 3}
    assert len(mesh.axis_devices("data")) == 2
    assert len(mesh.axis_devices("model")) == 3
    with pytest.raises(ValueError, match="no 'pod' axis"):
        mesh.axis_devices("pod")


@pytest.mark.parametrize("devices,axes,match", [
    (["cpu"] * 3, ("data",), "3 devices for a"),
    (["cpu"] * 4, ("data", "data"), "repeated axis"),
    (["meta"] * 4, ("data",), "unsupported device"),
])
def test_bad_meshes_raise(devices, axes, match):
    shape = (4,) if len(axes) == 1 else (2, 2)
    with pytest.raises(ValueError, match=match):
        make_mesh(shape, axes, devices)


def test_mesh_shape_must_match_the_axes():
    with pytest.raises(ValueError, match="2-D devices"):
        Mesh(np.array([["cpu"] * 2] * 2, dtype=object), ("data",))


def test_no_card_is_never_replaced_by_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((1,), ("data",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((2,), ("data",), ["cuda", "cpu"])


def test_too_few_cards_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 256 CUDA devices, 1 are"):
        make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 CUDA devices"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="only 1 CUDA devices exist"):
        make_mesh((2,), ("data",), ["cuda:0", "cuda:1"])


def test_check_mesh_rejects_other_types():
    mesh = make_mesh((1,), ("data",), ["cpu"])
    assert check_mesh(mesh) is mesh
    with pytest.raises(TypeError, match="Mesh"):
        check_mesh(object())
