"""The port's ClusterSpec serialises and hashes exactly as the JAX
package's, so a spec moves between the two unchanged."""
import dataclasses
import json
from pathlib import Path

import pytest

from repro.core import spec as jax_spec
from repro_torch.core import spec as tspec
from repro_torch.core.backend import CudaFusedBackend

SPECS = sorted(Path(__file__).resolve().parents[1].glob(
    "benchmarks/specs/*.json"))
CLUSTER_SPECS = [p for p in SPECS if "cluster_spec" in json.loads(p.read_text())]


def test_there_are_committed_specs():
    assert len(CLUSTER_SPECS) >= 5


@pytest.mark.parametrize("path", CLUSTER_SPECS, ids=lambda p: p.stem)
def test_committed_spec_round_trips_with_the_reference_hash(path):
    d = json.loads(path.read_text())["cluster_spec"]
    ref = jax_spec.ClusterSpec.from_dict(d)
    got = tspec.ClusterSpec.from_dict(d)
    assert got.to_dict() == ref.to_dict()
    assert got.stable_hash() == ref.stable_hash()
    assert tspec.ClusterSpec.from_dict(got.to_dict()) == got
    assert got.pool_schedule(100_000) == ref.pool_schedule(100_000)
    assert (tuple(dataclasses.asdict(lv) for lv in got.level_schedule())
            == tuple(dataclasses.asdict(lv) for lv in ref.level_schedule()))


@pytest.mark.parametrize("kwargs", [
    dict(), dict(tol=1e-3), dict(tol=1e-3, minibatch=64), dict(levels=3),
    dict(scheme="unequal", capacity_factor=1.5, chunk_points=4096),
])
def test_make_matches_reference(kwargs):
    ref = jax_spec.ClusterSpec.make(40, **kwargs)
    got = tspec.ClusterSpec.make(40, **kwargs)
    assert got.to_dict() == ref.to_dict()
    assert got.stable_hash() == ref.stable_hash()
    assert got.merge.effective_stop == tspec.StopSpec(
        **dataclasses.asdict(ref.merge.effective_stop))


def test_backend_instance_serialises_by_name():
    spec = tspec.ClusterSpec.make(8, backend=CudaFusedBackend())
    assert spec.to_dict()["execution"]["backend"] == "cuda_fused"
    assert spec.stable_hash() == tspec.ClusterSpec.make(8).stable_hash()


def test_replace_and_validation():
    spec = tspec.ClusterSpec.make(8)
    assert spec.replace(n_sub=16, mode="single").partition.n_sub == 16
    with pytest.raises(TypeError, match="ambiguous"):
        spec.replace(iters=3)
    with pytest.raises(ValueError):
        tspec.ClusterSpec.from_dict({"merge": {"k": 3}, "bogus": 1})
    with pytest.raises(ValueError):
        tspec.StopSpec(metric="nope")
