"""The port's clustered-KV refresh and serving engine against the JAX
package's, on the CPU in f32: the refresh (randomness-free: the warm start
is an array and there is one restart) to 1e-5 with counts exact, the
batched k-means's per-lane array init, and greedy tokens of
``ServeEngine`` for the full and the clustered cache; plus ports of the
reference's serving tests and the engine's config checks."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeConfig as JShape
from repro.configs import get_config as jget_config
from repro.models.registry import build_model as jbuild_model
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.stream.kv import refresh_clustered_cache as jrefresh
from repro.stream.kv import refresh_layer_cache as jrefresh_layer
from repro_torch.configs import ARCH_IDS, ShapeConfig, get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.core import (ClusterSpec, LevelSpec, StopSpec,
                              kmeans_batched)
from repro_torch.models import EncDecLM, build_model
from repro_torch.serve import ServeConfig, ServeEngine, resolve_recompress
from repro_torch.stream import refresh_clustered_cache, refresh_layer_cache
from repro_torch.telemetry import RecordingLogger


def _np(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _same(got, want):
    """Centroids to 1e-5, counts exactly."""
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5)
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))


# ---------------------------------------------------------------------------
# the refresh
# ---------------------------------------------------------------------------

def test_refresh_from_empty_cache_matches_reference():
    """An empty (zero-filled) cache: k-means starts from 64 identical
    centers at 0, ties go to the lowest index, so each Lloyd iteration can
    bring one more centroid to life — after max_iters=4, 5 live centroids
    (at most), mass 32 conserved; a second refresh adds more."""
    shape = (2, 1, 2)
    kc = np.zeros(shape + (64, 16), np.float32)
    cnt = np.zeros(shape + (64,), np.float32)
    wk, wv = _np(*shape, 32, 16, seed=1), _np(*shape, 32, 16, seed=2)
    val = np.ones(shape + (32,), np.float32)
    want = jrefresh(*map(jnp.asarray, (kc, kc, cnt, wk, wv, val)),
                    backend="jnp")
    got = refresh_clustered_cache(*map(torch.from_numpy,
                                       (kc, kc.copy(), cnt, wk, wv, val)),
                                  backend="torch")
    _same(got, want)
    live = (got[2] > 0).sum(-1)
    assert int(live.max()) == 5 and live.tolist() == \
        (np.asarray(want[2]) > 0).sum(-1).tolist()
    assert torch.all(got[2].sum(-1) == 32.0)
    wk2 = _np(*shape, 32, 16, seed=3)
    want2 = jrefresh(want[0], want[1], want[2], jnp.asarray(wk2),
                     jnp.asarray(wv), jnp.asarray(val), backend="jnp")
    got2 = refresh_clustered_cache(got[0], got[1], got[2],
                                   torch.from_numpy(wk2), torch.from_numpy(wv),
                                   torch.from_numpy(val), backend="torch")
    _same(got2, want2)
    assert int((got2[2] > 0).sum(-1).max()) > 5
    assert torch.all(got2[2].sum(-1) == 64.0)


@pytest.mark.parametrize("iters", [1, 3])
def test_refresh_with_live_centroids_matches_reference(iters):
    rng = np.random.default_rng(4)
    shape = (2, 2, 2)
    kc, vc = _np(*shape, 24, 8, seed=5), _np(*shape, 24, 8, seed=6)
    cnt = rng.integers(0, 4, shape + (24,)).astype(np.float32)
    wk, wv = _np(*shape, 12, 8, seed=7), _np(*shape, 12, 8, seed=8)
    val = (rng.random(shape + (12,)) > 0.3).astype(np.float32)
    want = jrefresh(*map(jnp.asarray, (kc, vc, cnt, wk, wv, val)),
                    stop=None, iters=iters, backend="jnp")
    got = refresh_clustered_cache(*map(torch.from_numpy,
                                       (kc, vc, cnt, wk, wv, val)),
                                  iters=iters, backend="torch")
    _same(got, want)
    np.testing.assert_allclose(float(got[2].sum()),
                               float(cnt.sum() + val.sum()), rtol=1e-6)


def test_refresh_layer_cache_matches_reference():
    L, B, kv, n, W, dh = 2, 1, 2, 8, 4, 4
    cache = {"kc": np.zeros((L, B, kv, n, dh), np.float32),
             "vc": np.zeros((L, B, kv, n, dh), np.float32),
             "counts": np.zeros((L, B, kv, n), np.float32),
             "wk": _np(L, B, kv, W, dh, seed=9),
             "wv": _np(L, B, kv, W, dh, seed=10),
             "slot_pos": np.array([[0, 1, 2, 3], [0, 1, -1, 3]], np.int32)}
    want = jrefresh_layer({k: jnp.asarray(v) for k, v in cache.items()},
                          jnp.asarray(W - 1, jnp.int32), iters=2,
                          backend="jnp")
    got = refresh_layer_cache({k: torch.from_numpy(v.copy())
                               for k, v in cache.items()}, W - 1, iters=2,
                              backend="torch")
    _same((got["kc"], got["vc"], got["counts"]),
          (want["kc"], want["vc"], want["counts"]))
    assert float(got["counts"].sum()) == L * B * kv * W - B * kv
    assert torch.all(got["slot_pos"] == -1)


def test_refresh_stop_alias_spec_and_levels():
    rng = np.random.default_rng(11)
    args = [torch.from_numpy(a) for a in (
        _np(2, 16, 4, seed=12), _np(2, 16, 4, seed=13),
        rng.uniform(1, 5, (2, 16)).astype(np.float32),
        _np(2, 8, 4, seed=14), _np(2, 8, 4, seed=15),
        np.ones((2, 8), np.float32))]
    a = refresh_clustered_cache(*args, iters=3, backend="torch")
    b = refresh_clustered_cache(*args, stop=StopSpec(max_iters=3),
                                backend="torch")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(TypeError):
        refresh_clustered_cache(*args, iters=3, stop=StopSpec(),
                                backend="torch")
    spec = ClusterSpec.make(16, global_iters=3)
    assert spec.merge.effective_stop == StopSpec(max_iters=3)
    c = refresh_clustered_cache(*args, spec=spec, backend="torch")
    assert all(torch.equal(x, y) for x, y in zip(a, c))
    # spec.levels pre-reduces each lane's pool; the original points are
    # re-assigned, so mass is still conserved
    level = LevelSpec(n_sub=2, compression=2)
    lv = ClusterSpec.make(16, global_iters=3, levels=(level,))
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # equal scheme: no warning
        d = refresh_clustered_cache(*args, spec=lv, backend="torch")
    np.testing.assert_allclose(float(d[2].sum()), float(args[2].sum() + 16),
                               rtol=1e-5)
    assert all(torch.isfinite(t).all() for t in d)
    uneq = ClusterSpec.make(16, global_iters=3, levels=(
        LevelSpec(n_sub=2, compression=2, scheme="unequal"),))
    with pytest.warns(UserWarning, match="unequal"):
        refresh_clustered_cache(*args, spec=uneq, backend="torch")


def test_per_lane_array_init_matches_reference_vmap():
    """One (k, d) warm start per lane: restart 0 of each lane keeps its
    own init (the reference's vmap over kmeans(init=...))."""
    from repro.core.kmeans import kmeans as jkmeans
    x = _np(3, 40, 5, seed=16)
    w = np.random.default_rng(17).uniform(0, 2, (3, 40)).astype(np.float32)
    init = _np(3, 6, 5, seed=18)
    want = jax.vmap(lambda x_, w_, c_: jkmeans(
        x_, 6, weights=w_, init=c_, iters=4, backend="jnp"))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(init))
    got = kmeans_batched(torch.from_numpy(x), 6,
                         weights=torch.from_numpy(w),
                         generator=torch.Generator().manual_seed(0),
                         init=torch.from_numpy(init), backend="torch",
                         stop=StopSpec(max_iters=4))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers),
                               rtol=1e-5, atol=1e-5)
    assert np.array_equal(got.assignment.numpy(),
                          np.asarray(want.assignment))
    np.testing.assert_allclose(got.counts.numpy(), np.asarray(want.counts),
                               rtol=1e-6)
    # restarts > 1: lane-wise jitter around each lane's own init
    r = kmeans_batched(torch.from_numpy(x), 6, weights=torch.from_numpy(w),
                       generator=torch.Generator().manual_seed(0),
                       init=torch.from_numpy(init), backend="torch",
                       restarts=3, stop=StopSpec(max_iters=4))
    assert r.centers.shape == (3, 6, 5)
    assert torch.all(r.sse <= got.sse + 1e-4)
    with pytest.raises(ValueError, match="array init"):
        kmeans_batched(torch.from_numpy(x), 6, weights=torch.from_numpy(w),
                       generator=torch.Generator(), init=torch.zeros(2, 6, 5),
                       backend="torch", stop=StopSpec(max_iters=1))


# ---------------------------------------------------------------------------
# the engine against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llama_pair():
    jcfg = jget_config("llama3-8b").reduced()
    cfg = get_config("llama3-8b").reduced()
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(cfg,
                                             jax.tree.map(np.asarray, jp)))
    return jcfg, cfg, jp, model


@pytest.mark.parametrize("kind", ["full", "clustered"])
def test_greedy_tokens_equal_reference_engine(llama_pair, kind):
    """Greedy generation: the same tokens as the JAX engine.  The clustered
    case refreshes every 8 tokens into 16 centroids (two refreshes in the
    prefill, one in decode); its ring is as long as the head dim, where
    the reference's ring is right (ROADMAP §3)."""
    jcfg, cfg, jp, model = llama_pair
    extra = dict(cluster_compression=4, cluster_window=16) \
        if kind == "clustered" else {}
    every = 8 if kind == "clustered" else 0
    prompt = np.random.default_rng(19).integers(0, cfg.vocab, (2, 18))
    want = JServeEngine(jcfg, JShape("s", 64, 2, "decode", **extra), jp,
                        JServeConfig(max_tokens=6, recompress_every=every)
                        ).generate(jnp.asarray(prompt, jnp.int32))
    eng = ServeEngine(cfg, ShapeConfig("s", 64, 2, "decode", **extra), model,
                      ServeConfig(max_tokens=6, recompress_every=every))
    assert eng.kind == kind
    got = eng.generate(torch.from_numpy(prompt))
    assert got.dtype == np.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, np.asarray(want))
    if kind == "clustered":
        caches, _, _ = eng.prefill(torch.from_numpy(prompt))
        np.testing.assert_allclose(caches["blocks"]["counts"].sum(-1),
                                   16.0)       # two refreshes of 8 tokens


# ---------------------------------------------------------------------------
# ports of tests/test_serve.py and test_stream.py's engine tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def internlm():
    cfg = get_config("internlm2-20b").reduced()
    return cfg, build_model(cfg, device="cpu").init_params(0)


def test_serve_engine_greedy_deterministic(internlm):
    cfg, model = internlm
    eng = ServeEngine(cfg, ShapeConfig("s", 64, 2, "decode"), model,
                      ServeConfig(max_tokens=6))
    prompt = torch.ones((2, 4), dtype=torch.long)
    out1, out2 = eng.generate(prompt), eng.generate(prompt)
    np.testing.assert_array_equal(out1, out2)
    assert out1.shape == (2, 6)


def test_serve_engine_sampling_fresh_stream_per_call(internlm):
    """temperature > 0 without a seed draws a fresh stream per call, so
    repeated calls do not sample identical tokens; a seed reproduces."""
    cfg, model = internlm
    eng = ServeEngine(cfg, ShapeConfig("s", 64, 2, "decode"), model,
                      ServeConfig(max_tokens=8, temperature=1.0))
    prompt = torch.ones((2, 4), dtype=torch.long)
    out1, out2 = eng.generate(prompt), eng.generate(prompt)
    assert not np.array_equal(out1, out2)
    np.testing.assert_array_equal(eng.generate(prompt, seed=7),
                                  eng.generate(prompt, seed=7))
    again = ServeEngine(cfg, ShapeConfig("s", 64, 2, "decode"), model,
                        ServeConfig(max_tokens=8, temperature=1.0))
    np.testing.assert_array_equal(again.generate(prompt), out1)


def test_serve_engine_telemetry_parity(internlm):
    """decode_rate ticks appear when a logger is attached, and the tokens
    are bit for bit the unlogged run's."""
    cfg, model = internlm
    shape = ShapeConfig("s", 64, 2, "decode")
    prompt = torch.ones((2, 4), dtype=torch.long)
    plain = ServeEngine(cfg, shape, model,
                        ServeConfig(max_tokens=6)).generate(prompt)
    rec = RecordingLogger()
    logged = ServeEngine(cfg, shape, model, ServeConfig(max_tokens=6),
                         logger=rec).generate(prompt)
    np.testing.assert_array_equal(plain, logged)
    ticks = [e for e in rec.events if e["name"] == "decode_rate"]
    assert len(ticks) == 6 and all(e["kind"] == "rate" for e in ticks)


def test_serve_engine_recompress_timers_and_mass(llama_pair):
    _, cfg, _, model = llama_pair
    rec = RecordingLogger()
    eng = ServeEngine(cfg, ShapeConfig("c", 64, 1, "decode",
                                       cluster_compression=8,
                                       cluster_window=16), model,
                      ServeConfig(max_tokens=6, recompress_every=8),
                      logger=rec)
    caches, _, _ = eng.prefill(torch.ones((1, 10), dtype=torch.long))
    # one refresh fired during the 10-token prefill (at position 8)
    assert torch.all(caches["blocks"]["counts"].sum(-1) == 8.0)
    assert eng.generate(torch.ones((1, 10), dtype=torch.long)).shape == (1, 6)
    timers = [e for e in rec.events if e["name"] == "recompress"]
    assert [e["pos"] for e in timers] == [8, 8, 16]


def test_serve_engine_rejects_lossy_recompress_cadence(llama_pair):
    _, cfg, _, model = llama_pair
    shape = ShapeConfig("c", 64, 1, "decode", cluster_compression=8,
                        cluster_window=16)
    with pytest.raises(ValueError, match="cluster_window"):
        ServeEngine(cfg, shape, model,
                    ServeConfig(max_tokens=4, recompress_every=64))


def test_serve_engine_wants_the_model_of_its_config(llama_pair):
    _, cfg, _, model = llama_pair
    with pytest.raises(TypeError, match="DecoderLM"):
        ServeEngine(get_config("internlm2-20b").reduced(),
                    ShapeConfig("s", 8, 1, "decode"), model)


def test_resolve_recompress_precedence():
    stop, backend = resolve_recompress(ServeConfig())
    assert stop == StopSpec(max_iters=4) and backend == "auto"
    stop, _ = resolve_recompress(
        ServeConfig(recompress_stop=StopSpec(max_iters=9, tol=1e-3)))
    assert stop.max_iters == 9 and stop.tol == 1e-3
    with pytest.warns(DeprecationWarning):
        stop, _ = resolve_recompress(ServeConfig(recompress_iters=7))
    assert stop == StopSpec(max_iters=7)
    spec = ClusterSpec.make(8, tol=1e-3)
    with pytest.warns(DeprecationWarning):
        stop, backend = resolve_recompress(
            ServeConfig(recompress_iters=7, recompress_spec=spec))
    assert stop == spec.merge.effective_stop
    assert backend == spec.execution.backend
    with pytest.raises(ValueError):
        resolve_recompress(ServeConfig(recompress_iters=7,
                                       recompress_stop=StopSpec()))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_build_model_builds_every_family(arch):
    """The attention families build (gemma3, dbrx, llama4 and internvl2
    among them), the recurrent ones (xlstm, zamba2) and the
    encoder-decoder (whisper)."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    assert model.cfg == cfg
    if cfg.family != "audio":
        patterned = cfg.local_per_global or cfg.family in ("ssm", "hybrid")
        assert model.group == ("super" if patterned else "blocks")
    else:
        assert arch == "whisper-base" and isinstance(model, EncDecLM)
        assert (len(model.enc), len(model.dec)) == (cfg.encoder_layers,
                                                    cfg.n_layers)


@pytest.mark.parametrize("arch", ["gemma3-12b", "dbrx-132b",
                                  "llama4-maverick-400b-a17b",
                                  "internvl2-2b", "xlstm-1.3b",
                                  "zamba2-2.7b", "whisper-base"])
def test_build_model_defaults_to_cuda(arch, monkeypatch):
    """The families built from the attention block, the recurrent ones and
    the encoder-decoder run on the card unless the caller asks for the
    CPU: without one, the default raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(get_config(arch).reduced())


def test_launcher_refuses_checkpoints(tmp_path):
    """``--ckpt-dir`` restores a trainer's checkpoint (test_torch_train.py)
    and refuses a directory that holds no complete one."""
    from repro_torch.launch.serve import main
    (tmp_path / ".tmp_step_00000002_1").mkdir()
    for d in (tmp_path / "nonexistent", tmp_path):
        with pytest.raises(FileNotFoundError, match="checkpoint"):
            main(["--reduced", "--ckpt-dir", str(d)])
