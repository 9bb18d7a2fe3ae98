"""The port's partition rules (``repro_torch.train.sharding``) against the
JAX package's, leaf by leaf: parameter, gradient and optimizer-state specs
for all ten configs at full size on the two production meshes (16 x 16
and 2 x 16 x 16), the port's side over ``convert.stacked_like`` and its
optimizers' ``init`` on ``meta``, the reference's over ``jax.eval_shape``
trees; batch specs over ``input_specs``; cache specs over reduced
``init_caches`` of the full and clustered kinds; and ``shard_bytes``
against the same sum over the reference's specs.  The reference's
functions read only a mesh's ``axis_names`` and ``shape``, so they get a
plain object with those two."""
import functools
import math
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS
from repro.configs import SHAPES as JSHAPES
from repro.configs import ShapeConfig as JShape
from repro.configs import get_config as jget_config
from repro.models.registry import build_model as jbuild_model
from repro.models.registry import input_specs as jinput_specs
from repro.optim import get_optimizer as jget_optimizer
from repro.train import sharding as js
from repro_torch import tree
from repro_torch.configs import SHAPES, ShapeConfig, get_config
from repro_torch.convert import stacked_like
from repro_torch.launch.mesh import (AbstractMesh, make_host_mesh,
                                     production_mesh_shape)
from repro_torch.models import build_model
from repro_torch.models.registry import cache_kind, input_specs
from repro_torch.optim import get_optimizer
from repro_torch.train import sharding as ts

MESHES = {"single": production_mesh_shape(),
          "multi": production_mesh_shape(multi_pod=True),
          "2x4": AbstractMesh((2, 4), ("data", "model")),
          "2x2x2": AbstractMesh((2, 2, 2), ("pod", "data", "model"))}
OPTIMIZERS = ("adamw", "adafactor")


def _jmesh(mesh):
    return types.SimpleNamespace(axis_names=mesh.axis_names,
                                 shape=dict(mesh.shape))


def _jspecs(t) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        t, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s)
            for path, s in flat}


def _tspecs(t) -> dict:
    out = {tree.key_of(p): s for p, s in tree.items(t)}
    assert all(isinstance(s, ts.PartitionSpec) for s in out.values())
    return {k: tuple(s) for k, s in out.items()}


@functools.lru_cache(maxsize=None)
def _trees(arch: str, opt_name: str):
    """(reference params, reference optimizer state) as ShapeDtypeStructs
    and (port params, port optimizer state) on ``meta``, at full size."""
    sds = jax.eval_shape(jbuild_model(jget_config(arch)).init,
                         jax.random.PRNGKey(0))
    jopt = jget_optimizer(opt_name, master_weights=True)
    params = stacked_like(get_config(arch))
    topt = get_optimizer(opt_name, master_weights=True)
    return sds, jax.eval_shape(jopt.init, sds), params, topt.init(params)


def _ref_bytes(sds, jspecs, mesh) -> int:
    """The bytes one device holds of ``sds`` under the reference's
    specs."""
    total = 0
    for (_, leaf), spec in zip(
            jax.tree_util.tree_flatten_with_path(sds)[0],
            jax.tree_util.tree_leaves(
                jspecs, is_leaf=lambda x: isinstance(x, JP))):
        dims = list(leaf.shape)
        for i, ax in enumerate(spec):
            if ax is not None:
                ways = math.prod(mesh.shape[a] for a in
                                 (ax if isinstance(ax, tuple) else (ax,)))
                dims[i] = -(-dims[i] // ways)
        total += math.prod(dims) * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_grad_and_opt_state_specs_match_the_reference(arch,
                                                            mesh_name):
    mesh = MESHES[mesh_name]
    jm = _jmesh(mesh)
    for opt_name in OPTIMIZERS:
        sds, jopt, params, topt = _trees(arch, opt_name)
        want_p = js.param_specs(sds, jm)
        got_p = ts.param_specs(params, mesh)
        assert _tspecs(got_p) == _jspecs(want_p)
        assert _tspecs(ts.grad_specs(params, mesh)) == _jspecs(
            js.grad_specs(sds, jm))
        want_o = js.opt_state_specs(jopt, want_p, jm)
        got_o = ts.opt_state_specs(topt, got_p, mesh)
        assert _tspecs(got_o) == _jspecs(want_o), opt_name
        # what one device holds, against the reference's specs' sum
        assert ts.shard_bytes(params, got_p, mesh) == _ref_bytes(
            sds, want_p, mesh)
        assert ts.shard_bytes(topt, got_o, mesh) == _ref_bytes(
            jopt, want_o, mesh)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_match_the_reference(arch, mesh_name):
    mesh, jm = MESHES[mesh_name], _jmesh(MESHES[mesh_name])
    for name, shape in SHAPES.items():
        want = jinput_specs(jget_config(arch), JSHAPES[name])
        got = input_specs(get_config(arch), shape)
        assert _tspecs(ts.batch_specs(got, mesh)) == _jspecs(
            js.batch_specs(want, jm)), name
        assert ts.shard_bytes(got, ts.batch_specs(got, mesh), mesh) == \
            _ref_bytes(want, js.batch_specs(want, jm), mesh)


_CACHE_SHAPES = {
    "full": (ShapeConfig("d", 64, 4, "decode"), JShape("d", 64, 4, "decode")),
    "clustered": (ShapeConfig("c", 64, 4, "decode", cluster_compression=4,
                              cluster_window=16),
                  JShape("c", 64, 4, "decode", cluster_compression=4,
                         cluster_window=16))}


# every cache kind an arch decodes on (xlstm's O(1) state and whisper's
# full cache take no clustered kind)
_CACHE_CASES = [(a, k) for a in ARCH_IDS for k in _CACHE_SHAPES
                if cache_kind(get_config(a), _CACHE_SHAPES[k][0]) == k]


@pytest.mark.parametrize("arch,kind", _CACHE_CASES)
def test_cache_specs_match_the_reference(arch, kind):
    """On reduced ``init_caches`` (batch 4), on the production meshes and
    on two small ones whose "model" axis divides the reduced dims."""
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    shape, jshape = _CACHE_SHAPES[kind]
    jm = jbuild_model(jcfg)
    want_c = jax.eval_shape(lambda: jm.init_caches(4, jshape, kind))
    got_c = build_model(cfg, device="meta").init_caches(4, shape, kind)
    for mesh in MESHES.values():
        want = js.cache_specs(want_c, _jmesh(mesh), 4)
        got = ts.cache_specs(got_c, mesh, 4)
        assert _tspecs(got) == _jspecs(want)
        assert ts.shard_bytes(got_c, got, mesh) == _ref_bytes(want_c, want,
                                                              mesh)


def test_spec_for_strips_the_shared_prefix_and_missing_axes():
    """zamba2's ``shared/`` block has no layer dim; an axis the mesh lacks
    is dropped; a dim the axis does not divide stays whole."""
    axes = ("data", "model")
    assert ts.spec_for("shared/attn/wq", 2, axes) == ("data", "model")
    assert ts.spec_for("g_blocks/attn/wq", 3, axes) == (None, "data",
                                                        "model")
    assert ts.spec_for("g_blocks/attn/wq", 3, ("data",)) == (None, "data",
                                                             None)
    mesh = MESHES["single"]
    assert ts.filter_divisible(ts.P("data", "model"), (51865, 512),
                               mesh) == (None, "model")
    assert ts.filter_divisible(ts.P(("pod", "data")), (64, 3),
                               MESHES["multi"]) == (("pod", "data"), None)


def test_batch_devices_are_the_data_entries_in_mesh_order():
    """The shards of a ("data", "model") mesh are its "data" entries at
    model index 0; the mesh's size along "data" is dp."""
    mesh = make_host_mesh(3, 2, device="cpu")
    assert ts.batch_axis(mesh) == "data" and ts.dp_size(mesh) == 3
    assert ts.batch_devices(mesh) == [torch.device("cpu")] * 3
    assert ts.dp_size(MESHES["multi"]) == 32
    assert ts.batch_axis(MESHES["multi"]) == ("pod", "data")
