"""The port's streaming engine against the JAX package's: its stages
exactly, a landmark-init stream update by update (started from a JAX state
carried across with ``convert.stream_state_from_jax``), and the
reference's acceptance checks (SSE within 15% of the batch oracle, drift
tracking, cold start), plus ``partial_fit`` and ``mode="stream"``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import drifting_blobs as jax_drifting_blobs
from repro.stream import StreamConfig as JaxStreamConfig
from repro.stream import StreamingClusterer as JaxStreamingClusterer
from repro.stream import fold_coreset as jax_fold_coreset
from repro.stream import reseed_dead_centers as jax_reseed
from repro_torch import convert
from repro_torch.api import SampledKMeans
from repro_torch.core import ChunkSpec, ClusterSpec, sampled_kmeans, sse
from repro_torch.data import IterSource, drifting_blobs
from repro_torch.stream import (StreamConfig, StreamingClusterer,
                                fold_and_merge, fold_coreset,
                                reseed_dead_centers, summarize_chunk)
from repro_torch.telemetry import RecordingLogger


@pytest.fixture(scope="module")
def drift_stream():
    # 12 chunks x 1024 points, mild drift: the reference's acceptance data
    return drifting_blobs(12, 1024, n_clusters=6, dim=2, seed=0, drift=0.02)


def _stream_all(sc, chunks, seed=0):
    state = sc.init(dim=chunks.shape[-1], seed=seed)
    for ch in chunks:
        state = sc.update(state, ch)
    return state


def test_drifting_blobs_are_the_jax_packages():
    for a, b in zip(drifting_blobs(5, 300, n_clusters=4, dim=3, seed=2,
                                   drift=0.1),
                    jax_drifting_blobs(5, 300, n_clusters=4, dim=3, seed=2,
                                       drift=0.1)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The stages, exactly
# ---------------------------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("case", ["distinct", "zero_ties", "all_empty"])
def test_fold_coreset_equals_the_reference(case):
    rng = np.random.default_rng(4)
    buf = rng.normal(size=(16, 3)).astype(np.float32)
    w = rng.uniform(0.5, 3.0, 16).astype(np.float32)
    new = rng.normal(size=(12, 3)).astype(np.float32)
    nw = rng.uniform(0.5, 3.0, 12).astype(np.float32)
    if case == "zero_ties":        # empty slots and dead centers: weight 0
        w[::3] = 0.0
        nw[1::2] = 0.0
        w[5] = nw[4] = 2.0          # equal weights across the two parts
    if case == "all_empty":
        w[:] = 0.0
        nw[:] = 0.0
    ref_pts, ref_w = jax_fold_coreset(*map(jnp.asarray, (buf, w, new, nw)),
                                      0.9)
    pts, ws = fold_coreset(*map(_t, (buf, w, new, nw)), 0.9)
    np.testing.assert_array_equal(pts.numpy(), np.asarray(ref_pts))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(ref_w))


def test_fold_coreset_keeps_the_heaviest():
    pts, ws = fold_coreset(_t([[0.0], [1.0], [2.0]]), _t([5.0, 0.1, 3.0]),
                           _t([[9.0], [8.0]]), _t([4.0, 0.05]), decay=0.5)
    assert sorted(pts.ravel().tolist()) == [0.0, 2.0, 9.0]
    np.testing.assert_allclose(sorted(ws.tolist()), [1.5, 2.5, 4.0])


@pytest.mark.parametrize("case", ["some_dead", "none_dead", "all_dead",
                                  "cold_start"])
def test_reseed_dead_centers_equals_the_reference(case):
    rng = np.random.default_rng(7)
    coreset = rng.uniform(0, 10, (64, 2)).astype(np.float32)
    w = rng.uniform(0.1, 5.0, 64).astype(np.float32)
    w[::5] = 0.0                                  # empty slots
    centers = coreset[[1, 2, 3, 4, 6, 7, 8, 9]].copy()
    if case == "some_dead":
        centers[[2, 5]] = -100.0                  # far from every point
    if case == "all_dead":                        # no mass: no live center
        w[:] = 0.0
    if case == "cold_start":                      # init(): all centers at 0,
        centers[:] = 0.0                          # every distance a tie
    ref = jax_reseed(jnp.asarray(centers), jnp.asarray(coreset),
                     jnp.asarray(w), 1e-6)
    got = reseed_dead_centers(_t(centers), _t(coreset), _t(w), 1e-6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if case == "none_dead":
        np.testing.assert_array_equal(got.numpy(), centers)


def test_reseed_moves_only_dead_centers():
    coreset = _t([[0.0, 0.0], [10.0, 10.0], [20.0, 0.0]])
    out = reseed_dead_centers(_t([[0.0, 0.0], [-100.0, -100.0]]), coreset,
                              _t([1.0, 5.0, 5.0]), 1e-6)
    np.testing.assert_allclose(out[0].numpy(), [0.0, 0.0])
    assert float((out[1] - coreset).norm(dim=1).min()) < 1e-5
    assert float(out[1].norm()) > 1.0


# ---------------------------------------------------------------------------
# A landmark stream, update by update, against the reference
# ---------------------------------------------------------------------------

# 8 local centers per 256-point partition: coarse enough that the local
# assignments have no near-ties (at compression 4 labels flip under any
# change of arithmetic, as ROADMAP §3 notes for the batch pipeline)
_LANDMARK = dict(k=6, n_sub=4, compression=32, buffer_size=512, decay=0.97,
                 init_mode="landmark")


def test_landmark_stream_matches_jax_update_by_update(drift_stream):
    chunks, _, _ = drift_stream
    ref_sc = JaxStreamingClusterer(JaxStreamConfig(**_LANDMARK))
    sc = StreamingClusterer(StreamConfig(**_LANDMARK), device="cpu")
    ref = ref_sc.init(dim=2, key=jax.random.PRNGKey(0))
    state = convert.stream_state_from_jax(
        ref._replace(**{f: np.asarray(getattr(ref, f))
                        for f in ref._fields if f != "key"}), seed=0,
        device="cpu")
    for t, ch in enumerate(chunks):
        ref = ref_sc.update(ref, jnp.asarray(ch))
        state = sc.update(state, ch)
        np.testing.assert_allclose(state.centers.numpy(),
                                   np.asarray(ref.centers), rtol=1e-5,
                                   err_msg=f"update {t}")
        np.testing.assert_allclose(state.coreset.numpy(),
                                   np.asarray(ref.coreset), rtol=1e-5,
                                   err_msg=f"update {t}")
        np.testing.assert_array_equal(state.coreset_w.numpy(),
                                      np.asarray(ref.coreset_w))
        assert float(state.n_seen) == float(ref.n_seen) == 1024 * (t + 1)
        assert int(state.step) == int(ref.step) == t + 1


def test_stream_state_from_jax_continues_a_reference_stream(drift_stream):
    chunks, _, _ = drift_stream
    ref_sc = JaxStreamingClusterer(JaxStreamConfig(**_LANDMARK))
    ref = ref_sc.init(dim=2, key=jax.random.PRNGKey(0))
    for ch in chunks[:3]:
        ref = ref_sc.update(ref, jnp.asarray(ch))
    state = convert.stream_state_from_jax(
        ref._replace(**{f: np.asarray(getattr(ref, f))
                        for f in ref._fields if f != "key"}), seed=5,
        device="cpu")
    assert state.key == 5 and state.step.dtype == torch.int32
    assert int(state.step) == 3 and float(state.n_seen) == 3072.0
    sc = StreamingClusterer(StreamConfig(**_LANDMARK), device="cpu")
    ref = ref_sc.update(ref, jnp.asarray(chunks[3]))
    state = sc.update(state, chunks[3])
    np.testing.assert_allclose(state.centers.numpy(), np.asarray(ref.centers),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# The reference's acceptance checks, in the port
# ---------------------------------------------------------------------------

def test_stream_sse_within_15pct_of_batch_oracle(drift_stream):
    chunks, _, _ = drift_stream
    sc = StreamingClusterer(StreamConfig(k=6, n_sub=8, compression=4,
                                         buffer_size=512, decay=0.97),
                            device="cpu")
    state = _stream_all(sc, chunks)
    full = torch.from_numpy(chunks.reshape(-1, 2))
    oracle = sampled_kmeans(full, 6, spec=ClusterSpec.make(6, n_sub=8,
                                                           compression=5),
                            seed=0, device="cpu")
    assert float(sse(full, state.centers)) <= 1.15 * float(oracle.sse)


def test_stream_tracks_drift_better_than_frozen():
    k = 5
    chunks, _, traj = drifting_blobs(20, 512, n_clusters=k, dim=2, seed=2,
                                     drift=0.15)
    sc = StreamingClusterer(StreamConfig(k=k, n_sub=4, compression=4,
                                         buffer_size=256, decay=0.8),
                            device="cpu")
    state = _stream_all(sc, chunks)
    frozen = sampled_kmeans(chunks[0], k, spec=ClusterSpec.make(k), seed=0,
                            device="cpu").centers

    def rmse(found):
        d = np.linalg.norm(found.numpy()[None] - traj[-1][:, None], axis=-1)
        return float(np.sqrt((d.min(1) ** 2).mean()))

    assert rmse(state.centers) < 0.5 * rmse(frozen)


def test_cold_start_self_heals(drift_stream):
    chunks, _, _ = drift_stream
    sc = StreamingClusterer(StreamConfig(k=6, n_sub=8, buffer_size=512),
                            device="cpu")
    state = _stream_all(sc, chunks[:4])
    idx, total = sc.query(state, chunks[3])
    assert np.unique(idx.numpy()).size == 6
    assert torch.equal(total, sse(torch.from_numpy(chunks[3]),
                                  state.centers))


def test_update_is_pure_and_deterministic(drift_stream):
    chunks, _, _ = drift_stream
    sc = StreamingClusterer(StreamConfig(k=6, n_sub=8, buffer_size=256),
                            device="cpu")
    s0 = sc.init(dim=2, seed=3)
    s1 = sc.update(s0, chunks[0])
    s2 = sc.update(s0, chunks[0])
    for a, b in zip(s1, s2):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    assert int(s0.step) == 0 and int(s1.step) == 1 and s1.key != s0.key
    assert float(s1.n_seen) == 1024.0


def test_update_through_the_kernel_wrappers(drift_stream):
    """The cuda_fused backend on CPU tensors (the wrappers check the
    kernels' input contract, then run the plain versions) updates and
    queries exactly as the torch backend."""
    chunks, _, _ = drift_stream
    cfg = StreamConfig(k=6, n_sub=8, buffer_size=256)
    a = StreamingClusterer(cfg, backend="cuda_fused", device="cpu")
    b = StreamingClusterer(cfg, backend="torch", device="cpu")
    sa, sb = _stream_all(a, chunks[:3]), _stream_all(b, chunks[:3])
    assert torch.equal(sa.centers, sb.centers)
    assert torch.equal(a.query(sa, chunks[3])[0], b.query(sb, chunks[3])[0])


def test_stages_compose_into_an_update(drift_stream):
    """update = summarize_chunk + fold_and_merge on the split seeds."""
    from repro_torch.core.device import derive_seed, make_generator
    chunks, _, _ = drift_stream
    cfg = StreamConfig(k=6, n_sub=8, buffer_size=256)
    sc = StreamingClusterer(cfg, backend="torch", device="cpu")
    s0 = sc.init(dim=2, seed=4)
    x = torch.from_numpy(chunks[0])
    lc, lw = summarize_chunk(x, cfg, make_generator(derive_seed(4, 0), "cpu"),
                             "torch")
    by_hand = fold_and_merge(s0, lc, lw, 1024, cfg, derive_seed(4, 1),
                             "torch")
    assert torch.equal(by_hand.centers, sc.update(s0, x).centers)


# ---------------------------------------------------------------------------
# The facade: partial_fit and mode="stream"
# ---------------------------------------------------------------------------

def test_partial_fit_equals_update(drift_stream):
    chunks, _, _ = drift_stream
    spec = ClusterSpec.make(6, n_sub=8, compression=5)
    est = SampledKMeans(spec, device="cpu", buffer_size=256, decay=0.9)
    for ch in chunks[:5]:
        est.partial_fit(ch, seed=2)
    sc = StreamingClusterer(StreamConfig.from_spec(spec, buffer_size=256,
                                                   decay=0.9), device="cpu")
    state = _stream_all(sc, chunks[:5], seed=2)
    assert torch.equal(est.centers_, state.centers)
    assert torch.equal(est.stream_state.coreset_w, state.coreset_w)
    assert est.sse_ is None and int(est.stream_state.step) == 5
    est.fit(chunks[0])                  # fit discards the stream
    assert est.stream_state is None


def test_fit_in_stream_mode(drift_stream):
    chunks, _, _ = drift_stream
    spec = ClusterSpec.make(6, n_sub=8, compression=5, mode="stream").replace(
        chunk=ChunkSpec(chunk_points=1024))
    src = IterSource(list(chunks[:6]))
    est = SampledKMeans(spec, device="cpu").fit(src, seed=1)
    state = _stream_all(StreamingClusterer(StreamConfig.from_spec(spec),
                                           device="cpu"), chunks[:6], seed=1)
    assert torch.equal(est.centers_, state.centers)
    full = torch.from_numpy(chunks[:6].reshape(-1, 2))
    torch.testing.assert_close(est.sse_, sse(full, est.centers_), rtol=1e-6,
                               atol=0.0)
    one = SampledKMeans(spec, device="cpu").fit(chunks[0], seed=1)
    assert int(one.stream_state.step) == 1


def test_stream_tick_telemetry_is_host_side(drift_stream):
    chunks, _, _ = drift_stream
    log = RecordingLogger()
    cfg = StreamConfig(k=6, n_sub=8, buffer_size=256)
    logged = _stream_all(StreamingClusterer(cfg, logger=log, device="cpu"),
                         chunks[:3])
    plain = _stream_all(StreamingClusterer(cfg, device="cpu"), chunks[:3])
    assert torch.equal(logged.centers, plain.centers)
    ticks = log.named("stream_tick")
    assert [e["step"] for e in ticks] == [1, 2, 3]
    assert all(e["step_units"] == 1024 for e in ticks)
