"""The port's multi-device executors (``repro_torch.core.distributed``,
``repro_torch.stream.distributed``) on CPU meshes, against the JAX
package's and against the port's own one-device paths.

Exactness against the reference is held on randomness-free specs
(``init="landmark"`` in every stage, ``tol=0``), at rtol 1e-5 on centers,
local centers and SSE (measured: at most 2.3e-7 on centers and local
centers, 3.6e-6 on the SSE; the stream's coreset 9.3e-6), and exactly on
the weights.  The sizes carry no near-ties: 3 local centers per partition
of about 190 points of ``blobs(3000, n_clusters=6)`` (compression 50, the
sizes of ``test_torch_pipeline.py``'s landmark test), and for the stream 8
local centers per 256 points (``test_torch_stream.py``'s sizes), so every
local center sits well inside its blob and no assignment is decided by
rounding.  The distributed merge is free of randomness only while the
strided candidates hold at least k live distinct centers (its exhausted
pool draws jitter): the one-device case uses compression 250 for that.

Four shards against the reference run in one JAX subprocess per module
(the XLA flag for 4 host devices must be set before JAX is imported);
the port runs a mesh of 4 ``cpu`` entries in this process.  The shards'
sums meet in mesh order in the port and in XLA's order in the reference,
so the two agree within rounding, not bit for bit.  Within the port a
one-shard run is the one-device path bit for bit."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro import compat
from repro.core import ClusterSpec as JaxSpec
from repro.core import LevelSpec as JaxLevel
from repro.core import fit_chunked_dist as jax_fit_chunked_dist
from repro.core import make_distributed_sampled_kmeans as jax_make_dist
from repro.data import ArraySource as JaxArraySource
from repro.data.synthetic import blobs
from repro.telemetry import RecordingLogger as JaxRecordingLogger
from repro_torch.api import SampledKMeans, execute, plan
from repro_torch.core import (ChunkDistStats, ChunkSpec, ClusterSpec,
                              ExecutionSpec, LevelSpec, LocalSpec, MergeSpec,
                              PartitionSpec, StopSpec, fit_chunked,
                              fit_chunked_dist, fit_from_spec,
                              make_distributed_sampled_kmeans,
                              merge_pool_distributed, relative_error,
                              standard_kmeans)
from repro_torch.core.device import derive_seed
from repro_torch.core.distributed import (_distributed_merge, mesh_concat,
                                          mesh_sum, replicate)
from repro_torch.core.backend import get_backend
from repro_torch.data import ArraySource, IterSource, SyntheticSource
from repro_torch.data import drifting_blobs
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.stream import (StreamConfig, StreamingClusterer,
                                make_sharded_update)
from repro_torch.telemetry import RecordingLogger

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5


def _mesh(n: int):
    return make_mesh((n,), ("data",), ["cpu"] * n)


@pytest.fixture(scope="module")
def pts():
    return blobs(3000, n_clusters=6, dim=2, seed=3)[0]


def _landmark(cls, level_cls, merge, levels=False, compression=50,
              chunk=None):
    spec = cls.make(6, n_sub=4, compression=compression, init="landmark",
                    local_iters=10, global_iters=10, restarts=2)
    spec = spec.replace(merge_path=merge)
    if levels:
        spec = spec.replace(levels=(level_cls(
            n_sub=2, compression=2, iters=5, init="landmark"),))
    if chunk:
        spec = spec.replace(chunk_points=chunk)
    return spec


def _close(got, want, what):
    """``got`` (a torch tensor) against the reference's array at RTOL; a
    reference result that the mesh tiled W times (its out_specs shard the
    already gathered pool) is compared once."""
    got, want = got.numpy(), np.asarray(want)
    if want.shape != got.shape:
        tiles = want.reshape(-1, *got.shape)
        assert (tiles == tiles[0]).all(), what
        want = tiles[0]
    np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=what)


# ---------------------------------------------------------------------------
# Four shards against the JAX package (one subprocess for the module)
# ---------------------------------------------------------------------------

_JAX4 = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.core import (ChunkSpec, ClusterSpec, LevelSpec, fit_chunked_dist,
                        make_distributed_sampled_kmeans)
from repro.data import ArraySource
from repro.data.synthetic import blobs, drifting_blobs
from repro.stream import StreamConfig, StreamingClusterer, make_sharded_update
assert len(jax.devices()) == 4
mesh = compat.make_mesh((4,), ("data",))
shard = NamedSharding(mesh, P("data"))
out = {}
pts = blobs(3000, n_clusters=6, dim=2, seed=3)[0]
def spec(merge, levels, chunk=None):
    s = ClusterSpec.make(6, n_sub=4, compression=50, init="landmark",
                         local_iters=10, global_iters=10, restarts=2)
    s = s.replace(merge_path=merge)
    if levels:
        s = s.replace(levels=(LevelSpec(n_sub=2, compression=2, iters=5,
                                        init="landmark"),))
    if chunk:
        s = s.replace(chunk=ChunkSpec(chunk_points=chunk))
    return s
for merge in ("replicated", "distributed"):
    for lv in (0, 1):
        r = make_distributed_sampled_kmeans(mesh, spec=spec(merge, lv))(
            jax.device_put(jnp.asarray(pts), shard), jax.random.PRNGKey(0))
        for f in r._fields:
            out[f"shard_map/{merge}/{lv}/{f}"] = np.asarray(getattr(r, f))
    r, st = fit_chunked_dist(ArraySource(jnp.asarray(pts)),
                             spec(merge, 1, chunk=250), mesh,
                             jax.random.PRNGKey(0))
    for f in r._fields:
        out[f"chunked_dist/{merge}/{f}"] = np.asarray(getattr(r, f))
    for f in ("per_device_chunks", "per_device_points", "pool_size"):
        out[f"chunked_dist/{merge}/{f}"] = np.asarray(getattr(st, f))
chunks = drifting_blobs(3, 1024, n_clusters=6, dim=2, seed=0, drift=0.02)[0]
sc = StreamingClusterer(StreamConfig(k=6, n_sub=1, compression=32,
                                     buffer_size=512, decay=0.97,
                                     init_mode="landmark"))
update = make_sharded_update(sc, mesh)
state = sc.init(dim=2, key=jax.random.PRNGKey(0))
for t, ch in enumerate(chunks):
    state = update(state, jax.device_put(jnp.asarray(ch), shard))
    for f in ("centers", "coreset", "coreset_w", "n_seen", "step"):
        out[f"stream/{t}/{f}"] = np.asarray(getattr(state, f))
np.savez(sys.argv[1], **out)
print("JAX4_OK")
"""


@pytest.fixture(scope="module")
def jax4(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax4") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _JAX4, str(path)],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=ROOT)
    assert "JAX4_OK" in r.stdout, r.stdout + r.stderr
    return dict(np.load(path))


@pytest.mark.parametrize("levels", [False, True])
@pytest.mark.parametrize("merge", ["replicated", "distributed"])
def test_shard_map_on_4_shards_matches_jax(jax4, pts, merge, levels):
    res = make_distributed_sampled_kmeans(
        _mesh(4), spec=_landmark(ClusterSpec, LevelSpec, merge, levels))(pts)
    for f in res._fields:
        _close(getattr(res, f), jax4[f"shard_map/{merge}/{int(levels)}/{f}"],
               f)
    np.testing.assert_array_equal(
        res.local_weights.numpy(),
        jax4[f"shard_map/{merge}/{int(levels)}/local_weights"][
            :res.local_weights.shape[0]])


@pytest.mark.parametrize("merge", ["replicated", "distributed"])
def test_chunked_dist_on_4_shards_matches_jax(jax4, pts, merge):
    """12 chunks of 250, 3 a shard, one landmark reduce level per shard,
    exact SSE summed over the shards."""
    res, stats = fit_chunked_dist(
        ArraySource(pts),
        _landmark(ClusterSpec, LevelSpec, merge, True, chunk=250), _mesh(4))
    for f in ("centers", "local_centers", "sse"):
        _close(getattr(res, f), jax4[f"chunked_dist/{merge}/{f}"], f)
    np.testing.assert_array_equal(res.local_weights.numpy(),
                                  jax4[f"chunked_dist/{merge}/local_weights"])
    assert int(res.n_dropped) == int(jax4[f"chunked_dist/{merge}/n_dropped"])
    for f in ("per_device_chunks", "per_device_points", "pool_size"):
        assert np.array_equal(np.asarray(getattr(stats, f)),
                              jax4[f"chunked_dist/{merge}/{f}"]), f


def test_sharded_stream_update_on_4_shards_matches_jax(jax4):
    """Three updates of 1024 points, 256 a shard (one partition of 8 local
    centers each), the state compared after every update."""
    chunks = drifting_blobs(3, 1024, n_clusters=6, dim=2, seed=0,
                            drift=0.02)[0]
    sc = StreamingClusterer(StreamConfig(
        k=6, n_sub=1, compression=32, buffer_size=512, decay=0.97,
        init_mode="landmark"), device="cpu")
    update = make_sharded_update(sc, _mesh(4))
    state = sc.init(dim=2, seed=0)
    for t, ch in enumerate(chunks):
        state = update(state, ch)
        for f in ("centers", "coreset"):
            _close(getattr(state, f), jax4[f"stream/{t}/{f}"], f"{f} {t}")
        np.testing.assert_array_equal(state.coreset_w.numpy(),
                                      jax4[f"stream/{t}/coreset_w"])
        assert float(state.n_seen) == float(jax4[f"stream/{t}/n_seen"])
        assert int(state.step) == int(jax4[f"stream/{t}/step"]) == t + 1


# ---------------------------------------------------------------------------
# One device against the JAX package, in process
# ---------------------------------------------------------------------------

def _jax_mesh1():
    return compat.make_mesh((1,), ("data",))


@pytest.mark.parametrize("merge", ["replicated", "distributed"])
def test_shard_map_on_one_device_matches_jax(pts, merge):
    mesh = _jax_mesh1()
    xd = jax.device_put(jnp.asarray(pts), NamedSharding(mesh, P("data")))
    ref = jax_make_dist(mesh, spec=_landmark(JaxSpec, JaxLevel, merge,
                                             compression=250))(
        xd, jax.random.PRNGKey(0))
    got = make_distributed_sampled_kmeans(
        _mesh(1), spec=_landmark(ClusterSpec, LevelSpec, merge,
                                 compression=250))(pts, 0)
    for f in got._fields:
        _close(getattr(got, f), getattr(ref, f), f)


@pytest.mark.parametrize("merge", ["replicated", "distributed"])
def test_chunked_dist_on_one_device_matches_jax(pts, merge):
    """4 chunks on one shard (chunk 0 on the local stream, chunks 1-3 on
    their children), compression 250."""
    ref, ref_stats = jax_fit_chunked_dist(
        JaxArraySource(jnp.asarray(pts)),
        _landmark(JaxSpec, JaxLevel, merge, compression=250, chunk=750),
        _jax_mesh1(), jax.random.PRNGKey(0))
    got, stats = fit_chunked_dist(
        ArraySource(pts),
        _landmark(ClusterSpec, LevelSpec, merge, compression=250, chunk=750),
        _mesh(1))
    for f in ("centers", "local_centers", "sse"):
        _close(getattr(got, f), getattr(ref, f), f)
    np.testing.assert_array_equal(got.local_weights.numpy(),
                                  np.asarray(ref.local_weights))
    assert stats._asdict() == ref_stats._asdict()


# ---------------------------------------------------------------------------
# One shard: the one-device paths bit for bit
# ---------------------------------------------------------------------------

SPEC = ClusterSpec(
    partition=PartitionSpec(scheme="equal", n_sub=4),
    local=LocalSpec(compression=5, iters=5),
    merge=MergeSpec(k=5, iters=10, restarts=2),
    chunk=ChunkSpec(chunk_points=500),
    execution=ExecutionSpec(mode="chunked_dist"),
)


def _synthetic(n, seed=0):
    return SyntheticSource(n_points=n, dim=3, n_clusters=4, seed=seed)


def _assert_equal(a, b):
    for name, u, v in zip(a._fields, a, b):
        assert torch.equal(u, v), name


def test_one_shard_is_fit_chunked_bit_for_bit():
    """Several chunks, a level, scaling, exact SSE: centers, local
    centers, weights, SSE and n_dropped equal ``fit_chunked``'s."""
    spec = SPEC.replace(levels=(LevelSpec(n_sub=4, compression=2, iters=3),))
    src = _synthetic(2000, seed=1)
    ref, ref_stats = fit_chunked(src, spec, 7, device="cpu")
    res, stats = fit_chunked_dist(src, spec, _mesh(1), 7)
    assert isinstance(stats, ChunkDistStats) and stats.n_devices == 1
    assert stats.per_device_chunks == (ref_stats.n_chunks,)
    assert stats.pool_size == ref_stats.pool_size
    assert stats.peak_pool_rows == ref_stats.peak_pool_rows
    _assert_equal(res, ref)


def test_one_shard_auto_facade_equals_the_direct_call():
    src = _synthetic(2000, seed=2)
    ref, _ = fit_chunked_dist(src, SPEC, _mesh(1), 3)
    est = SampledKMeans(SPEC.replace(mode="auto"), mesh=_mesh(1)).fit(
        src, seed=3)
    assert isinstance(est.chunk_stats_, ChunkDistStats)
    _assert_equal(est.result_, ref)


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("merge", ["replicated", "distributed"])
def test_shard_map_facade_equals_the_direct_call(pts, n_shards, merge):
    spec = ClusterSpec.make(6, n_sub=4, compression=5).replace(
        merge_path=merge)
    ref = make_distributed_sampled_kmeans(_mesh(n_shards), spec=spec)(pts, 4)
    est = SampledKMeans(spec, mesh=_mesh(n_shards)).fit(pts, seed=4)
    assert est.result_ is not None and est.chunk_stats_ is None
    for f in ref._fields:
        assert torch.equal(getattr(est.result_, f), getattr(ref, f)), f
    assert est.predict(pts).shape == (3000,)


def test_one_shard_shard_map_is_the_single_fit(pts):
    """Shard 0 draws the single fit's streams: centers, local centers and
    SSE equal ``fit_from_spec``'s; the weights are the merge's."""
    spec = ClusterSpec.make(6, n_sub=4, compression=5).replace(
        levels=(LevelSpec(n_sub=2, compression=2, iters=3),))
    ref = fit_from_spec(pts, spec, 9, device="cpu")
    got = make_distributed_sampled_kmeans(_mesh(1), spec=spec)(pts, 9)
    for f in ("centers", "local_centers", "sse"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert torch.equal(got.local_weights, (ref.local_weights > 0).float())


def test_one_shard_sharded_update_is_update(pts):
    sc = StreamingClusterer(ClusterSpec.make(6, n_sub=4, compression=5),
                            device="cpu")
    update = make_sharded_update(sc, _mesh(1))
    a = b = sc.init(dim=2, seed=4)
    for ch in np.split(pts, 3):
        a, b = update(a, ch), sc.update(b, ch)
        for f in ("centers", "coreset", "coreset_w", "n_seen", "step"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert a.key == b.key


def test_distributed_merge_agrees_with_merge_pool_distributed():
    """The executor's distributed merge is ``merge_pool_distributed`` on
    the same pools under the fit's global stream; on one shard those pools
    are ``fit_chunked``'s."""
    spec = SPEC.replace(scale=False, merge_path="distributed")
    src = _synthetic(2000, seed=4)
    ref, _ = fit_chunked(src, spec, 11, device="cpu")
    res, _ = fit_chunked_dist(src, spec, _mesh(1), 11)
    assert torch.equal(res.local_centers, ref.local_centers)
    expect, n_iter = merge_pool_distributed(
        [ref.local_centers], [ref.local_weights], spec, _mesh(1),
        derive_seed(11, 1))
    assert torch.equal(expect, res.centers) and int(n_iter) == 10


# ---------------------------------------------------------------------------
# The reference's invariants
# ---------------------------------------------------------------------------

def test_distributed_merge_pads_ragged_pools():
    """Zero-weight padding rows carry no weight into the greedy picks or
    the Lloyd rounds: while the pool fits the candidate budget max(2k, 8)
    the padded merge is the unpadded one bit for bit."""
    spec = SPEC.replace(merge=MergeSpec(k=8, iters=10))
    rng = np.random.default_rng(0)
    pool = rng.normal(size=(12, 3)).astype(np.float32)    # 12 < 2k
    w = rng.uniform(1.0, 5.0, 12).astype(np.float32)
    base, _ = merge_pool_distributed([pool], [w], spec, _mesh(1), 1)
    padded, _ = merge_pool_distributed(
        [np.concatenate([pool, np.zeros((4, 3), np.float32)])],
        [np.concatenate([w, np.zeros(4, np.float32)])], spec, _mesh(1), 1)
    assert torch.equal(base, padded)
    # ragged pools over two shards: the short one pads
    two, _ = merge_pool_distributed([pool[:7], pool[7:]], [w[:7], w[7:]],
                                    spec, _mesh(2), 1)
    assert two.shape == (8, 3) and bool(torch.isfinite(two).all())


def test_exhausted_pool_jitter_gives_distinct_centers():
    """Fewer live distinct candidates than k: the surplus picks are
    jittered, so no center row repeats (a duplicate would be a cluster
    that never wins a point)."""
    spec = SPEC.replace(merge=MergeSpec(k=6, iters=3))
    pool = np.repeat(np.eye(3, dtype=np.float32), 4, axis=0)  # 3 distinct
    w = np.ones(12, np.float32)
    centers, _ = merge_pool_distributed([pool[:6], pool[6:]], [w[:6], w[6:]],
                                        spec, _mesh(2), 5)
    assert torch.unique(centers, dim=0).shape[0] == 6
    again, _ = merge_pool_distributed([pool[:6], pool[6:]], [w[:6], w[6:]],
                                      spec, _mesh(2), 5)
    assert torch.equal(centers, again)


def test_distributed_merge_tol_stops_on_the_summed_sse():
    """``tol > 0``: every shard takes the rounds the summed SSE decides;
    a converging pool stops early, and the one-shard run of one pool
    agrees with the same pool split over two shards."""
    rng = np.random.default_rng(1)
    pool = torch.from_numpy(np.concatenate(
        [rng.normal(c, 0.05, (8, 2)) for c in ((0, 0), (3, 0), (0, 3))]
    ).astype(np.float32))
    w = torch.ones(24)
    stop = StopSpec(max_iters=50, tol=1e-4)
    be = get_backend("torch")
    dev = [torch.device("cpu")]
    one, it1 = _distributed_merge([pool], [w], 3, stop, 0, be, dev)
    two, it2 = _distributed_merge([pool[:12], pool[12:]], [w[:12], w[12:]],
                                  3, stop, 0, be, dev * 2)
    assert 1 <= int(it1) < 50 and int(it2) < 50
    torch.testing.assert_close(torch.sort(one, 0).values,
                               torch.sort(two, 0).values, rtol=1e-5,
                               atol=1e-6)


def test_pool_sse_policy():
    spec = SPEC.replace(chunk=ChunkSpec(chunk_points=500, sse="pool"))
    res, stats = fit_chunked_dist(_synthetic(2000, seed=6), spec, _mesh(2), 0)
    assert stats.passes == 2           # scale + fold, no SSE pass
    assert float(res.sse) >= 0.0


def test_bounded_accumulator_per_device_peak_and_schedule():
    """40 chunks over 2 shards with a level: each shard's pending chunk
    pools fold early, so the per-shard peak stays below its 20 unflushed
    chunk pools (it is the one-device executor's peak on one shard's
    chunks), and the final pool is the per-shard schedule's."""
    spec = ClusterSpec(
        partition=PartitionSpec(n_sub=4),
        local=LocalSpec(compression=5, iters=3),
        merge=MergeSpec(k=5, iters=5, restarts=1),
        levels=(LevelSpec(n_sub=4, compression=2, iters=2),),
        chunk=ChunkSpec(chunk_points=100),
        execution=ExecutionSpec(mode="chunked_dist"),
    )
    src = _synthetic(4000, seed=8)
    res, stats = fit_chunked_dist(src, spec, _mesh(2), 5)
    per_chunk_pool = 4 * (25 // 5)
    assert stats.per_device_chunks == (20, 20)
    _, one = fit_chunked(src.shard(0, 2), spec, 5, device="cpu")
    assert 0 < stats.peak_pool_rows == one.peak_pool_rows \
        < 20 * per_chunk_pool
    assert stats.pool_size == spec.chunked_dist_pool_schedule(4000, 2)[-1]
    assert bool(torch.isfinite(res.centers).all())


def test_round_robin_balance_and_empty_shards():
    """10 chunks over 3 shards deal 4, 3, 3 (rows and chunks); 3 chunks
    over 4 shards leave one empty, which contributes nothing."""
    _, stats = fit_chunked_dist(_synthetic(5000, seed=2), SPEC, _mesh(3), 0)
    assert stats.per_device_chunks == (4, 3, 3)
    assert stats.per_device_points == (2000, 1500, 1500)
    assert max(stats.per_device_chunks) - min(stats.per_device_chunks) <= 1
    for merge in ("replicated", "distributed"):
        res, st = fit_chunked_dist(_synthetic(1500, seed=2),
                                   SPEC.replace(merge_path=merge), _mesh(4),
                                   0)
        assert st.per_device_chunks == (1, 1, 1, 0)
        assert st.pool_size == 3 * 4 * (125 // 5)
        assert bool(torch.isfinite(res.centers).all())


@pytest.mark.parametrize("merge", ["replicated", "distributed"])
def test_repeated_fits_are_bit_identical(pts, merge):
    spec = ClusterSpec.make(6, n_sub=4, compression=5).replace(
        merge_path=merge, levels=(LevelSpec(n_sub=2, compression=2,
                                            iters=3),))
    fn = make_distributed_sampled_kmeans(_mesh(4), spec=spec)
    a, b, c = fn(pts, 1), fn(pts, 1), fn(pts, 2)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert not torch.equal(a.centers, c.centers)
    cspec = SPEC.replace(merge_path=merge)
    src = _synthetic(2000, seed=3)
    _assert_equal(fit_chunked_dist(src, cspec, _mesh(2), 1)[0],
                  fit_chunked_dist(src, cspec, _mesh(2), 1)[0])


@pytest.mark.parametrize("merge", ["replicated", "distributed"])
def test_kmeanspp_shard_map_within_15pct_of_standard(merge):
    """The reference's quality bound for the sharded fit
    (tests/test_pipeline.py), on 8 shards of 512 points."""
    x = blobs(4096, n_clusters=4, dim=2, seed=5)[0]
    full = float(standard_kmeans(x, 4, iters=30, device="cpu").sse)
    flat = ClusterSpec(partition=PartitionSpec(n_sub=2),
                       local=LocalSpec(compression=5, iters=10),
                       merge=MergeSpec(k=4, iters=25))
    for spec in (flat, flat.replace(
            levels=(LevelSpec(n_sub=2, compression=2, iters=6),))):
        res = make_distributed_sampled_kmeans(_mesh(8), spec=spec,
                                              merge=merge)(x, 0)
        assert relative_error(float(res.sse), full) < 0.15


@pytest.mark.parametrize("backend", ["cuda_fused", "cuda"])
def test_kernel_wrappers_take_the_sharded_inputs(pts, backend):
    """The kernels' wrappers (their plain versions on CPU tensors) serve
    every stage of both sharded fits: the same fit as the torch backend."""
    spec = ClusterSpec.make(6, n_sub=4, compression=50, init="landmark")
    for merge in ("replicated", "distributed"):
        s = spec.replace(merge_path=merge)
        a = make_distributed_sampled_kmeans(_mesh(4), spec=s,
                                            backend=backend)(pts)
        b = make_distributed_sampled_kmeans(_mesh(4), spec=s,
                                            backend="torch")(pts)
        torch.testing.assert_close(a.centers, b.centers, rtol=1e-5,
                                   atol=1e-6)


def test_collectives_keep_mesh_order_and_share_copies():
    parts = [torch.full((2,), float(i)) for i in range(3)]
    assert mesh_concat(parts, torch.device("cpu")).tolist() == \
        [0, 0, 1, 1, 2, 2]
    assert mesh_sum(parts, torch.device("cpu")).tolist() == [3.0, 3.0]
    t = torch.ones(3)
    copies = replicate(t, [torch.device("cpu")] * 4)
    assert all(c is t for c in copies)


def test_sharded_update_from_a_spec_and_its_checks():
    spec = ClusterSpec.make(4, n_sub=2, compression=8)
    chunks = drifting_blobs(2, 512, n_clusters=4, dim=2, seed=1)[0]
    update = make_sharded_update(spec, make_host_mesh(2, 2, device="cpu"))
    sc = StreamingClusterer(spec, device="cpu")
    state = sc.init(dim=2, seed=3)
    for ch in chunks:
        state = update(state, ch)
    assert int(state.step) == 2 and float(state.n_seen) == 1024.0
    assert bool(torch.isfinite(state.centers).all())
    with pytest.raises(ValueError, match="do not divide"):
        update(state, chunks[0][:511])
    with pytest.raises(TypeError, match="Mesh"):
        make_sharded_update(spec, object())


# ---------------------------------------------------------------------------
# Planner and facade
# ---------------------------------------------------------------------------

def test_plan_auto_resolves_the_mesh_modes():
    src = _synthetic(2000)
    auto = SPEC.replace(mode="auto")
    assert plan(auto, src.shape, mesh=_mesh(1), source=src).mode == \
        "chunked_dist"
    assert plan(auto, (2000, 3), mesh=_mesh(1)).mode == "shard_map"
    assert plan(auto, src.shape, source=src, device="cpu").mode == "chunked"
    assert plan(auto, (2000, 3), device="cpu").mode == "single"
    pl = plan(auto, (2000, 3), mesh=_mesh(2))
    assert pl.device == torch.device("cpu") and pl.backend.name == "torch"


@pytest.mark.parametrize("mode,shape,mesh,match", [
    ("chunked_dist", (2000, 3), None, "needs a mesh"),
    ("shard_map", (2000, 3), None, "needs a mesh"),
    ("chunked_dist", (2000, 3), "2d", "1-D mesh"),
    ("shard_map", (2001, 3), 2, "do not divide"),
    ("shard_map", (2000, 3), "model", "no 'data' axis"),
    ("chunked_dist", (2000, 3), 8, "not enough to feed"),
])
def test_plan_rejects_bad_mesh_runs(mode, shape, mesh, match):
    meshes = {None: None, 2: _mesh(2), 8: _mesh(8),
              "2d": make_host_mesh(1, 1, device="cpu"),
              "model": make_mesh((2,), ("model",), ["cpu"] * 2)}
    with pytest.raises(ValueError, match=match):
        plan(SPEC.replace(mode=mode), shape, mesh=meshes[mesh],
             device="cpu")


def test_plan_rejects_a_starved_sharded_merge():
    with pytest.raises(ValueError, match="representatives"):
        plan(SPEC.replace(merge=MergeSpec(k=500, iters=5)), (2000, 3),
             mesh=_mesh(1))


def test_mesh_modes_reject_what_they_cannot_run(pts):
    with pytest.raises(ValueError, match="no points"):
        fit_chunked_dist(IterSource(lambda: iter([]), dim=3), SPEC, _mesh(1))
    with pytest.raises(ValueError, match="1-D mesh"):
        fit_chunked_dist(_synthetic(2000), SPEC,
                         make_host_mesh(1, 1, device="cpu"))
    with pytest.raises(ValueError, match="needs a resident array"):
        execute(plan(SPEC.replace(mode="shard_map"), mesh=_mesh(1)),
                IterSource([pts]))
    with pytest.raises(ValueError, match="do not divide"):
        make_distributed_sampled_kmeans(_mesh(7), spec=SPEC)(pts)
    with pytest.raises(TypeError, match="Mesh"):
        SampledKMeans(SPEC, mesh=_jax_mesh1())


# ---------------------------------------------------------------------------
# Telemetry: the reference's record names and fields
# ---------------------------------------------------------------------------

def test_shard_map_telemetry_matches_the_jax_schema(pts):
    spec = ClusterSpec.make(6, n_sub=4, compression=50, init="landmark")
    log = RecordingLogger()
    logged = make_distributed_sampled_kmeans(_mesh(2), spec=spec,
                                             logger=log)(pts, 0)
    plain = make_distributed_sampled_kmeans(_mesh(2), spec=spec)(pts, 0)
    assert torch.equal(logged.centers, plain.centers)
    ref = JaxRecordingLogger()
    mesh = _jax_mesh1()
    jax_make_dist(mesh, spec=JaxSpec.from_dict(spec.to_dict()), logger=ref)(
        jax.device_put(jnp.asarray(pts), NamedSharding(mesh, P("data"))),
        jax.random.PRNGKey(0))
    for name in ("fit_shard_map", "dist_fit"):
        mine = log.named(name)[0]
        theirs = [e for e in ref.events if e["name"] == name][0]
        assert set(mine) == set(theirs), name
    assert log.named("fit_shard_map")[0]["devices"] == 2


def test_chunked_dist_telemetry_matches_the_jax_schema(pts):
    spec = _landmark(ClusterSpec, LevelSpec, "distributed", True, chunk=250)
    log = RecordingLogger()
    logged, _ = fit_chunked_dist(ArraySource(pts), spec, _mesh(1), 1,
                                 logger=log)
    plain, _ = fit_chunked_dist(ArraySource(pts), spec, _mesh(1), 1)
    _assert_equal(logged, plain)
    ref = JaxRecordingLogger()
    jax_fit_chunked_dist(JaxArraySource(jnp.asarray(pts)),
                         JaxSpec.from_dict(spec.to_dict()), _jax_mesh1(),
                         jax.random.PRNGKey(1), logger=ref)
    names = {e["name"] for e in log.events}
    assert names == {e["name"] for e in ref.events}
    for name in ("fit_chunked_dist", "fold", "merge", "reduce_level"):
        mine = log.named(name)[0]
        theirs = [e for e in ref.events if e["name"] == name][0]
        assert set(mine) == set(theirs), name
