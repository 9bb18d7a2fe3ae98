"""The port's partitions are the JAX package's, index for index."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import subcluster as jax_sub
from repro.data.synthetic import blobs
from repro_torch.core import subcluster as sub


@pytest.fixture(scope="module")
def pts():
    return blobs(3000, n_clusters=6, dim=2, seed=3)[0]


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a.indices), b.indices.numpy())
    np.testing.assert_array_equal(np.asarray(a.mask), b.mask.numpy())
    assert int(a.n_dropped) == int(b.n_dropped)


@pytest.mark.parametrize("n_sub", [4, 7, 13, 64])
def test_equal_partition_exact(pts, n_sub):
    xs, _ = jax_sub.feature_scale(jnp.asarray(pts))
    ref = jax_sub.equal_partition(xs, n_sub)
    got = sub.equal_partition(torch.from_numpy(np.array(xs)), n_sub)
    _same(ref, got)


@pytest.mark.parametrize("n_sub,factor", [(4, 2.0), (7, 2.0), (13, 1.0),
                                          (6, 0.5)])
def test_unequal_partition_exact_including_drops(pts, n_sub, factor):
    xs, _ = jax_sub.feature_scale(jnp.asarray(pts))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jax_sub.unequal_partition(xs, n_sub, capacity_factor=factor)
        got = sub.unequal_partition(torch.from_numpy(np.array(xs)), n_sub,
                                    capacity_factor=factor)
    _same(ref, got)
    if factor < 1.0:
        assert int(got.n_dropped) > 0


def test_unequal_partition_warnings(pts):
    x = torch.from_numpy(pts)
    with pytest.warns(UserWarning, match="capacity_factor=0.5 < 1"):
        sub.unequal_partition(x, 6, capacity_factor=0.5)
    with pytest.warns(UserWarning, match="clamping to M"):
        sub.unequal_partition(x[:10], 2, capacity_factor=4.0)


def test_scale_and_weighted_gather_match_jax(pts):
    rng = np.random.default_rng(0)
    mass = rng.integers(0, 5, 3000).astype(np.float32)
    xs_j, (lo_j, span_j) = jax_sub.feature_scale(jnp.asarray(pts))
    xs_t, (lo_t, span_t) = sub.feature_scale(torch.from_numpy(pts))
    np.testing.assert_array_equal(xs_t.numpy(), np.asarray(xs_j))
    part_j = jax_sub.equal_partition(xs_j, 5)
    part_t = sub.equal_partition(xs_t, 5)
    pj, wj = jax_sub.gather_partitions(xs_j, part_j, weights=jnp.asarray(mass))
    pt, wt = sub.gather_partitions(xs_t, part_t, weights=torch.from_numpy(mass))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_allclose(
        sub.unscale(xs_t, (lo_t, span_t)).numpy(), pts, rtol=1e-5, atol=1e-5)


def test_partitioner_registry():
    assert set(sub.available_partitioners()) >= {"equal", "unequal"}
    sub.register_partitioner("halves", lambda x, n, f: sub.equal_partition(x, 2))
    try:
        part = sub.get_partitioner("halves")(torch.zeros(10, 2), 8, 2.0)
        assert part.indices.shape == (2, 5)
    finally:
        sub._PARTITIONERS.pop("halves")
    with pytest.raises(ValueError, match="unknown partition scheme"):
        sub.get_partitioner("nope")
