"""The port's launch-parameter autotuner (``repro_torch/kernels/autotune.py``
and ``tune_table.py``) on the CPU: cache keying and layering, the sweep's
contract (dedupe through the clamps of ``tiles.py``, checks against the
plain version and against the derived plan bit for bit, determinism, the
derived plan never beaten by a slower winner), the clamps at their edges,
the ``cuda_tuned`` backend (registered, hashable, the ``torch`` backend bit
for bit on CPU tensors, the JAX package's ``pallas_tuned`` step within
1e-4), and ``plan()``'s pre-warm of the fit's Lloyd shapes.  Case for case the counterpart of
``tests/test_autotune.py`` where the concept exists in the port.

Off the card the wrappers run the plain versions whatever the config says,
and the clamps reckon a card's occupancy from shared memory and threads
(``sm_count=132``, the H100's SMs)."""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import get_backend as jax_backend
from repro_torch.core.backend import (ENV_VAR as BACKEND_ENV, CudaBackend,
                                      CudaFusedBackend, CudaTunedBackend,
                                      LloydBackend, available_backends,
                                      get_backend)
from repro_torch.kernels import autotune, tiles, tune_table
from repro_torch.kernels.autotune import DEFAULT, TileConfig

ROOT = Path(__file__).resolve().parents[1]
SMS = 132
CPU = dict(device="cpu", sm_count=SMS)


@pytest.fixture(autouse=True)
def _fresh_caches(monkeypatch):
    """Every test starts with empty tuner caches and no persistent path."""
    monkeypatch.delenv(autotune.ENV_VAR, raising=False)
    autotune.clear_caches()
    yield
    autotune.clear_caches()


def _stub_timer(times):
    """A deterministic time_fn: pops preset durations in call order."""
    seq = list(times)

    def time_fn(run_once):
        run_once()              # still executes the candidate
        return seq.pop(0)
    return time_fn


# ---------------------------------------------------------------------------
# keys and cache layers
# ---------------------------------------------------------------------------

def test_cache_key_buckets_nearby_shapes_together():
    kw = dict(device_kind="x", backend="cuda")
    k1 = autotune.cache_key("lloyd", b=60, m=200_000, d=3, k=200, **kw)
    k2 = autotune.cache_key("lloyd", b=64, m=262_144, d=4, k=256, **kw)
    assert k1 == k2 == "lloyd|B64_M262144_d4_K256|float32|x|cuda"
    # crossing a power of two in M or B, or a register width in d, splits
    assert autotune.cache_key("lloyd", b=64, m=300_000, d=4, k=256,
                              **kw) != k1
    assert autotune.cache_key("lloyd", b=65, m=262_144, d=4, k=256,
                              **kw) != k1
    assert autotune.cache_key("lloyd", b=64, m=262_144, d=5, k=256,
                              **kw) != k1
    # dtype, card, backend and kernel all split the key
    for other in (dict(dtype=torch.bfloat16, **kw),
                  dict(device_kind="y", backend="cuda"),
                  dict(device_kind="x", backend="cpu")):
        assert autotune.cache_key("lloyd", b=60, m=200_000, d=3, k=200,
                                  **other) != k1
    assert autotune.cache_key("assign", b=60, m=200_000, d=3, k=200,
                              **kw) != k1
    # d past the register widths buckets as 0; the PQ geometry is exact
    assert "_d0_" in autotune.shape_bucket("lloyd", b=1, m=8, d=200, k=8)
    assert autotune.shape_bucket("scan", b=100, l=1586, msub=64,
                                 c=256) == "B128_L2048_m64_C256"
    assert autotune.cache_key("scan", b=1, l=8, msub=8, c=16,
                              device="cpu").endswith("|cpu|cpu")


def test_lookup_hits_memory_after_first_resolution():
    dims = dict(b=4, m=4096, d=8, k=64, device="cpu")
    cfg, src = autotune.lookup("lloyd", with_source=True, **dims)
    assert (cfg, src) == (DEFAULT, "table")       # the "*" row
    cfg2, src2 = autotune.lookup("lloyd", with_source=True, **dims)
    assert (cfg2, src2) == (cfg, "memory")
    _, src3 = autotune.lookup("lloyd", b=4, m=40_960, d=8, k=64,
                              device="cpu", with_source=True)
    assert src3 != "memory"                       # another bucket misses


def test_persistent_cache_round_trip(tmp_path):
    p = tmp_path / "tune.json"
    dims = dict(b=4, m=4096, d=8, k=64)
    key = autotune.cache_key("lloyd", device_kind="testdev", backend="cuda",
                             **dims)
    assert autotune.save_entry(key, TileConfig(center_tile=32, blocks=8),
                               path=p)
    autotune.clear_caches()               # a "new process"
    cfg, src = autotune.lookup("lloyd", device_kind="testdev",
                               backend="cuda", path=p, with_source=True,
                               **dims)
    assert (src, cfg) == ("disk", TileConfig(center_tile=32, blocks=8))
    doc = json.loads(p.read_text())
    assert doc["schema"] == autotune.CACHE_SCHEMA
    assert doc["entries"][key] == {"center_tile": 32, "blocks": 8}


def test_persistent_cache_env_var(tmp_path, monkeypatch):
    p = tmp_path / "tune.json"
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(p))
    assert autotune.ENV_VAR == "REPRO_TORCH_TUNE_CACHE"
    key = autotune.cache_key("scan", b=8, l=1024, msub=8, c=16,
                             device_kind="testdev", backend="cuda")
    assert autotune.save_entry(key, TileConfig(blocks=16))
    autotune.clear_caches()
    cfg, src = autotune.lookup("scan", b=8, l=1024, msub=8, c=16,
                               device_kind="testdev", backend="cuda",
                               with_source=True)
    assert (src, cfg) == ("disk", TileConfig(blocks=16))
    # path=False skips the disk layer whatever the variable says
    autotune.clear_caches()
    _, src = autotune.lookup("scan", b=8, l=1024, msub=8, c=16,
                             device_kind="testdev", backend="cuda",
                             path=False, with_source=True)
    assert src == "table"
    # the reference's variable names another file, which the port ignores
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE")
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(p))
    autotune.clear_caches()
    _, src = autotune.lookup("scan", b=8, l=1024, msub=8, c=16,
                             device_kind="testdev", backend="cuda",
                             with_source=True)
    assert src == "table"


def test_corrupt_cache_file_falls_through(tmp_path):
    p = tmp_path / "tune.json"
    p.write_text("{ this is not json")
    dims = dict(b=4, m=4096, d=8, k=64, device_kind="dv", backend="cuda")
    cfg, src = autotune.lookup("lloyd", path=p, with_source=True, **dims)
    assert (cfg, src) == (DEFAULT, "table")
    # partly corrupt: good entries survive, bad ones (the reference's VMEM
    # fields among them) are skipped
    key = autotune.cache_key("lloyd", **dims)
    p.write_text(json.dumps({"schema": 1, "entries": {
        key: {"blocks": 4}, "bad": {"blocks": "huge"}, "worse": [1, 2],
        "tpu": {"block_m": 256, "block_k": 256}}}))
    autotune.clear_caches()
    cfg, src = autotune.lookup("lloyd", path=p, with_source=True, **dims)
    assert (src, cfg) == ("disk", TileConfig(blocks=4))
    # a path that cannot be read at all falls through too
    autotune.clear_caches()
    _, src = autotune.lookup("lloyd", path=tmp_path / "missing" / "t.json",
                             with_source=True, **dims)
    assert src == "table"


def test_committed_table_loads_and_validates():
    assert tune_table.validate_table() >= len(autotune.KERNELS)
    for kernel in autotune.KERNELS:
        # an unknown card falls to the "*" row, the derived plan
        assert tune_table.load_default(kernel, "Quantum FPGA 9000",
                                       "B1_M1_d2_K1") == DEFAULT
        assert list(tune_table.TABLE[kernel])[-1] == "*"
        for pattern, buckets in tune_table.TABLE[kernel].items():
            for bucket, fields in buckets.items():
                got = tune_table.load_default(
                    kernel, "cpu" if pattern == "*" else f"X {pattern} Y",
                    bucket)
                assert got == TileConfig.from_dict(fields)
    assert tune_table.load_default("warp", "cpu") is None


@pytest.mark.parametrize("kernel,dims,want", [
    ("assign", dict(b=1, m=262_144, d=8, k=64), TileConfig(points=1)),
    ("assign", dict(b=1, m=200_000, d=5, k=50), TileConfig(points=1)),
    ("assign", dict(b=1, m=500_000, d=2, k=1000), DEFAULT),   # predict
    ("lloyd", dict(b=64, m=7813, d=2, k=1562), DEFAULT),      # local
    ("lloyd", dict(b=4, m=6554, d=64, k=256), TileConfig(center_tile=256)),
    ("lloyd", dict(b=8, m=89_616, d=8, k=175), TileConfig(blocks=128)),
    ("scan", dict(b=128, l=1586, msub=64, c=256), DEFAULT),
])
def test_committed_h100_rows_resolve_by_card_and_bucket(kernel, dims, want):
    """An H100's name matches its rows; another shape of the same bucket
    gets the same row; a bucket without a row, the derived plan."""
    kw = dict(device_kind="NVIDIA H100 80GB HBM3", backend="cuda",
              with_source=True, **dims)
    assert autotune.lookup(kernel, **kw) == (want, "table")
    assert autotune.lookup(kernel, **kw) == (want, "memory")
    kw["device_kind"] = "NVIDIA A100-SXM4-80GB"
    assert autotune.lookup(kernel, **kw) == (DEFAULT, "table")


@pytest.mark.parametrize("bad,match", [
    ({"attn": {"*": {"*": {}}}}, "unknown kernel"),
    ({"scan": {"H100": {"*": {"blocks": 4}}}}, "end with"),
    ({"scan": {"*": {"*": {"blocks": 4}}}}, "derived plan"),
    ({"scan": {"H100": {"B1_M2_d2_K4": {"blocks": 4}}, "*": {"*": {}}}},
     "not a scan bucket"),
    ({"scan": {"H100": {"*": {"center_tile": 4}}, "*": {"*": {}}}},
     "takes no"),
    ({"lloyd": {"H100": {"*": {"blocks": -1}}, "*": {"*": {}}}},
     "non-negative"),
])
def test_validate_table_rejects_malformed_rows(monkeypatch, bad, match):
    monkeypatch.setattr(tune_table, "TABLE", bad)
    with pytest.raises(ValueError, match=match):
        tune_table.validate_table()


def test_lookup_rejects_bad_dims():
    with pytest.raises(ValueError, match="unknown tunable kernel"):
        autotune.lookup("attn", b=1, m=8, d=8, k=8, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        autotune.lookup("lloyd", m=8, d=8, k=8, device="cpu")
    with pytest.raises(ValueError, match="unexpected"):
        autotune.lookup("lloyd", b=1, m=8, d=8, k=8, l=8, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        autotune.lookup("scan", b=1, l=0, msub=8, c=16, device="cpu")


def test_tile_config_round_trips_and_rejects_bad_entries():
    cfg = TileConfig(center_tile=64, points=4)
    assert cfg.to_dict() == {"center_tile": 64, "points": 4}
    assert TileConfig.from_dict(cfg.to_dict()) == cfg
    assert TileConfig.from_dict({}) == DEFAULT
    for bad in ({"block_m": 256}, {"blocks": True}, {"blocks": 1.5}, [1]):
        with pytest.raises(ValueError):
            TileConfig.from_dict(bad)


# ---------------------------------------------------------------------------
# the clamps of tiles.py, and the derived plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,d,tile,reserved,want", [
    (16, 2, 0, 0, 16),                  # 0: the formula (all k resident)
    (16, 2, 64, 0, 16),                 # k < tile: at most k
    (1562, 2, 4, 0, 4),
    (10 ** 6, 2, 10 ** 6, 0, tiles.MAX_SMEM_BYTES // 16),  # a block's smem
    (10 ** 6, 2, 10 ** 6, 100_000, (tiles.MAX_SMEM_BYTES - 100_000) // 16),
    (10 ** 6, 64, 0, 0, tiles.CENTER_SMEM_BYTES // (4 * 68)),
])
def test_clamp_center_tile_edges(k, d, tile, reserved, want):
    assert tiles.clamp_center_tile(k, d, tile, reserved) == want


@pytest.mark.parametrize("b,m,k,d,per_sm,blocks,want", [
    (1, 10 * 256, 5, 2, 4, 1000, 10),           # at most its tiles
    (64, 7813, 1562, 2, 4, 1000, 4 * SMS // 64),  # one wave
    (64, 7813, 1562, 2, 4, 3, 3),
    # the (B, G, K, d+1) partials within SCRATCH_BYTES
    (2, 10 ** 7, 20_000, 64, 8, 10 ** 6,
     tiles.SCRATCH_BYTES // (4 * 2 * 20_000 * 65)),
])
def test_lloyd_blocks_clamp_edges(b, m, k, d, per_sm, blocks, want):
    assert tiles.lloyd_blocks(b, m, k, d, SMS, per_sm, blocks) == want


@pytest.mark.parametrize("b,m,d,points,want", [
    (1, 500_000, 2, 4, 4), (1, 500_000, 2, 1, 1), (1, 100, 2, 4, 4),
    (1, 500_000, 16, 4, 4),
    (1, 500_000, 17, 4, 1),             # register width 32 > 16: one point
    (1, 500_000, 200, 4, 1),            # no register width at all
])
def test_assign_points_clamp_edges(b, m, d, points, want):
    assert tiles.assign_points(b, m, d, SMS, points) == want


def test_block_clamps_one_wave_and_items():
    # the assignment: one wave, at most the entry's 32-point items
    assert tiles.assign_blocks(1, 500_000, 4, 6, SMS, 10 ** 6) == 6 * SMS
    assert tiles.assign_blocks(1, 1000, 1, 6, SMS, 10 ** 6) == 32
    assert tiles.assign_blocks(1, 1000, 1, 6, SMS, 7) == 7
    # the centroid warp path: the merge's partial bytes bound it too
    most = tiles.centroid_blocks(4, 10 ** 6, 1000, 2, SMS)
    assert tiles.centroid_blocks(4, 10 ** 6, 1000, 2, SMS, 10 ** 6) == most
    assert most <= tiles.CENTROID_MERGE_BYTES // (4 * 1000 * 3)
    assert tiles.centroid_blocks(4, 10 ** 6, 1000, 2, SMS, 3) == 3
    # the scan: one wave, at most the entry's tiles
    assert tiles.scan_plan(256, 1586, 8, SMS, 10 ** 6).blocks == 4
    assert tiles.scan_plan(1, 1586, 8, SMS, 10 ** 6).blocks == 7
    assert tiles.scan_plan(1, 1586, 8, SMS, 2) == tiles.ScanPlan(2, 1)


def _reckoned(kernel, dims):
    return autotune._reckoned_occupancy(kernel, dims, torch.float32)


# the unfused cuda backend's launches (its local and merge stages at
# paper_500k, oocore_5m's fold, shard_map_500k's local stage, the PQ
# training): they run the derived plan, which the tuner's clamps must
# reproduce all the same
UNFUSED_SHAPES = {
    "assign": (
        autotune._pts("cuda_local", 64, 7813, 1562, 2),
        autotune._pts("cuda_merge", 4, 99_968, 1000, 2, True),
        autotune._pts("oocore_cuda_fold", 16, 16_384, 256, 8),
        autotune._pts("shard_map_cuda_local", 16, 7813, 1562, 2)),
    "centroid": (
        autotune._pts("cuda_local", 64, 7813, 1562, 2),
        autotune._pts("cuda_merge", 4, 99_968, 1000, 2, True),
        autotune._pts("pq_200k", 64, 32_768, 256, 1),
        autotune._pts("oocore_cuda_fold", 16, 16_384, 256, 8),
        autotune._pts("shard_map_cuda_local", 16, 7813, 1562, 2)),
}


@pytest.mark.parametrize("kernel,shape", [
    (kernel, s) for kernel in ("lloyd", "assign", "centroid")
    for s in (autotune.SWEEP_SHAPES.get(kernel, ())
              + UNFUSED_SHAPES.get(kernel, ()))],
    ids=lambda v: getattr(v, "name", v))
def test_no_override_is_todays_plan(kernel, shape):
    """Without an override every plan function returns the formula's plan
    at the paths' shapes, and the derived plan's effective config is it."""
    b, m, k, d = (shape.dims[a] for a in ("b", "m", "k", "d"))
    occ = _reckoned(kernel, shape.dims)
    eff = autotune.effective_config(kernel, DEFAULT, sm_count=SMS,
                                    **shape.dims)
    if kernel == "lloyd":
        if tiles.lloyd_route(k, d) == "tc":
            assert eff == DEFAULT
            return
        bk = tiles.center_tile(k, d)
        want = (bk, tiles.lloyd_blocks(b, m, k, d, SMS, occ(bk)))
        assert tuple(tiles.lloyd_plan(b, m, k, d, SMS, occ)) == want
        assert tiles.lloyd_plan(b, m, k, d, SMS, occ, 0, 0) == want
        assert (eff.center_tile, eff.blocks) == want
    elif kernel == "assign":
        if tiles.assign_route(k, d) == "tc":
            assert eff == DEFAULT
            return
        bk = tiles.center_tile(k, d)
        p = tiles.assign_points(b, m, d, SMS)
        want = (bk, p, tiles.assign_blocks(b, m, p, occ(bk, p > 1), SMS))
        assert tuple(tiles.assign_plan(b, m, k, d, SMS, occ)) == want
        assert (eff.center_tile, eff.points, eff.blocks) == want
    else:
        assert eff == TileConfig(blocks=tiles.centroid_blocks(b, m, k, d,
                                                              SMS))
    # a requested config equal to the derived plan's launch is that launch
    assert autotune.effective_config(kernel, eff, sm_count=SMS,
                                     **shape.dims) == eff


def test_no_override_is_todays_scan_plan():
    for shape in autotune.SWEEP_SHAPES["scan"]:
        dims = shape.dims
        per_sm = _reckoned("scan", dims)()
        want = tiles.scan_plan(dims["b"], dims["l"], per_sm, SMS)
        eff = autotune.effective_config("scan", DEFAULT, sm_count=SMS,
                                        **dims)
        assert eff == TileConfig(blocks=want.blocks)


def test_routes_without_a_config_collapse_to_the_derived_plan():
    big = TileConfig(center_tile=64, blocks=3, points=4)
    # the tensor-core routes (the refresh's Lloyd, the index routing) and
    # the centroid update's sort path take no config
    assert autotune.effective_config("lloyd", big, sm_count=SMS, b=256,
                                     m=9216, k=8192, d=128) == DEFAULT
    assert autotune.effective_config("assign", big, sm_count=SMS, b=1,
                                     m=65_536, k=256, d=64) == DEFAULT
    assert autotune.effective_config("centroid", big, sm_count=SMS, b=4,
                                     m=9216, k=8192, d=128) == DEFAULT


def test_relative_config_keeps_the_formula_where_the_winner_did():
    derived = TileConfig(center_tile=1562, blocks=6)
    assert autotune.relative_config(derived, derived) == DEFAULT
    assert autotune.relative_config(TileConfig(center_tile=1562, blocks=3),
                                    derived) == TileConfig(blocks=3)


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

LLOYD = dict(b=2, m=512, d=2, k=16)


def test_tune_is_deterministic_under_a_fixed_timing_stub():
    cands = [TileConfig(blocks=1), TileConfig(center_tile=4)]
    picks = set()
    for _ in range(3):
        autotune.clear_caches()
        res = autotune.tune("lloyd", candidates=cands, save=False,
                            time_fn=_stub_timer([3e-3, 1e-3, 2e-3, 3e-3]),
                            **CPU, **LLOYD)
        picks.add(res.config)
    assert picks == {TileConfig(blocks=1)}          # the 2nd swept: fastest
    assert res.effective == TileConfig(center_tile=16, blocks=1)
    assert res.speedup_vs_default == pytest.approx(3.0)
    assert res.spread == 0.0                         # 3e-3 both times
    # an exact tie breaks on sweep order, and the derived plan runs first
    autotune.clear_caches()
    res = autotune.tune("lloyd", candidates=cands, save=False,
                        time_fn=_stub_timer([1e-3] * 4), **CPU, **LLOYD)
    assert res.config == DEFAULT and res.speedup_vs_default == 1.0


def test_tune_dedupes_candidates_through_the_clamps():
    # k = 16 and 2 tiles of points: every tile >= 16 is the one resident
    # tile, every blocks >= 2 the derived two blocks
    cands = [TileConfig(center_tile=4, blocks=1),
             TileConfig(center_tile=128, blocks=1),
             TileConfig(center_tile=512, blocks=8),
             TileConfig(blocks=64)]
    res = autotune.tune("lloyd", candidates=cands, save=False,
                        time_fn=_stub_timer([1e-3] * 10), **CPU, **LLOYD)
    launches = [c.config for c in res.candidates]
    assert len(launches) == len(set(launches))
    assert launches == [TileConfig(center_tile=16, blocks=2),
                        TileConfig(center_tile=4, blocks=1),
                        TileConfig(center_tile=16, blocks=1)]
    assert res.candidates[0].requested == (
        DEFAULT, TileConfig(center_tile=512, blocks=8),
        TileConfig(blocks=64))


def _poisoned(kernel, poison):
    real = autotune.CASES[kernel]

    def make(*args):
        case = real(*args)

        def run(cfg):
            return poison(cfg, tuple(case.run(cfg)))
        return case._replace(run=run)
    return make


def test_tune_rejects_numeric_mismatch(monkeypatch):
    """A candidate whose outputs disagree with the plain version may never
    win, however fast it times."""
    monkeypatch.setitem(autotune.CASES, "lloyd", _poisoned(
        "lloyd", lambda cfg, out: ((out[0] + 1.0,) + out[1:]
                                   if cfg.blocks == 1 else out)))
    res = autotune.tune("lloyd", candidates=[TileConfig(blocks=1)],
                        save=False, time_fn=_stub_timer([1e-3, 1e-3]),
                        **CPU, **LLOYD)
    assert res.config == DEFAULT
    rejected = [c for c in res.candidates if not c.ok]
    assert len(rejected) == 1 and rejected[0].config.blocks == 1
    assert rejected[0].time_s is None and "sums off" in rejected[0].note


def test_tune_holds_value_invariant_axes_bit_for_bit(monkeypatch):
    """A change within the plain version's tolerance is still rejected on
    an axis that moves no value (the assignment's points), and accepted,
    recorded as moving bits, on the Lloyd kernel's blocks."""
    monkeypatch.setitem(autotune.CASES, "assign", _poisoned(
        "assign", lambda cfg, out: ((out[0], out[1] * (1 + 1e-6))
                                    if cfg.points == 4 else out)))
    res = autotune.tune("assign", candidates=[TileConfig(points=4)],
                        save=False, time_fn=_stub_timer([1e-3] * 3),
                        **CPU, b=1, m=64, d=2, k=8)
    bad = [c for c in res.candidates if not c.ok]
    assert len(bad) == 1 and "bit for bit" in bad[0].note

    def nudge(cfg, out):
        if cfg.blocks != 1:
            return out
        return (out[0] * (1 + 1e-7), out[1], out[2] * (1 + 1e-7), *out[3:])
    monkeypatch.setitem(autotune.CASES, "lloyd", _poisoned("lloyd", nudge))
    res = autotune.tune("lloyd", candidates=[TileConfig(blocks=1)],
                        save=False, time_fn=_stub_timer([2e-3, 1e-3, 2e-3]),
                        **CPU, **LLOYD)
    moved = {c.config.blocks: c.moved for c in res.candidates}
    assert moved == {2: (), 1: ("blocks",)}
    assert res.config == TileConfig(blocks=1)
    # the same nudge on the center tile alone is rejected
    monkeypatch.setitem(autotune.CASES, "lloyd", _poisoned(
        "lloyd", lambda cfg, out: ((out[0] * (1 + 1e-7),) + out[1:]
                                   if cfg.center_tile == 4 else out)))
    res = autotune.tune("lloyd", candidates=[TileConfig(center_tile=4)],
                        save=False, time_fn=_stub_timer([1e-3] * 3),
                        **CPU, **LLOYD)
    assert [c.ok for c in res.candidates] == [True, False]


@pytest.mark.parametrize("kernel", autotune.KERNELS)
def test_tune_moved_bits_rules(kernel):
    a = torch.zeros(3)
    out = (a, a + 1, a + 2, a.int(), a + 3)
    n = {"lloyd": 5, "assign": 2, "centroid": 2, "scan": 1}[kernel]
    same = out[:n]
    assert autotune.moved_bits(kernel, same, same, ("blocks",)) == ((), None)
    first = (same[0] + 1e-7,) + same[1:]
    moved, why = autotune.moved_bits(kernel, first, same, ("blocks",))
    if kernel in autotune.BIT_AXES:
        assert (moved, why) == (("blocks",), None)
    else:
        assert moved == () and "bit for bit" in why
    # no bit-moving axis changed: any difference is a rejection
    assert autotune.moved_bits(kernel, first, same, ())[1] is not None


def test_tune_all_rejected_is_an_error(monkeypatch):
    monkeypatch.setitem(autotune.CASES, "lloyd", _poisoned(
        "lloyd", lambda cfg, out: (out[0] + 1.0,) + out[1:]))
    with pytest.raises(RuntimeError, match="every candidate was rejected"):
        autotune.tune("lloyd", candidates=[TileConfig(blocks=1)],
                      save=False, **CPU, **LLOYD)


def test_tune_launch_failures(monkeypatch):
    """A candidate that fails to launch is recorded as rejected; the derived
    plan failing is an error."""
    def fail(when):
        def poison(cfg, out):
            if when(cfg):
                raise RuntimeError("kernel launch failed with CUDA error 1")
            return out
        return _poisoned("scan", poison)
    monkeypatch.setitem(autotune.CASES, "scan",
                        fail(lambda cfg: cfg.blocks == 1))
    dims = dict(b=2, l=2000, msub=4, c=16)
    res = autotune.tune("scan", candidates=[TileConfig(blocks=1)],
                        save=False, time_fn=_stub_timer([1e-3] * 2),
                        **CPU, **dims)
    assert [c.ok for c in res.candidates] == [True, False]
    assert "raised RuntimeError" in res.candidates[1].note
    monkeypatch.setitem(autotune.CASES, "scan", fail(lambda cfg: True))
    with pytest.raises(RuntimeError, match="CUDA error"):
        autotune.tune("scan", candidates=[TileConfig(blocks=1)], save=False,
                      **CPU, **dims)


def test_tune_winner_never_loses_to_default_and_caches(tmp_path):
    p = tmp_path / "t.json"
    res = autotune.tune("lloyd", candidates=[TileConfig(blocks=1)],
                        time_fn=_stub_timer([1e-3, 5e-3, 1e-3]), path=p,
                        **CPU, **LLOYD)
    assert res.speedup_vs_default >= 1.0 and res.config == DEFAULT
    cfg, src = autotune.lookup("lloyd", device="cpu", with_source=True,
                               **LLOYD)
    assert (src, cfg) == ("memory", res.config)
    autotune.clear_caches()
    cfg, src = autotune.lookup("lloyd", device="cpu", path=p,
                               with_source=True, **LLOYD)
    assert (src, cfg) == ("disk", DEFAULT)
    with pytest.raises(ValueError, match="sm_count"):
        autotune.tune("lloyd", device="cpu", save=False, **LLOYD)


@pytest.mark.parametrize("kernel,dims", [
    ("lloyd", dict(b=3, m=700, d=5, k=13)),
    ("assign", dict(b=2, m=512, d=16, k=16)),
    ("centroid", dict(b=2, m=512, d=3, k=16)),
    ("scan", dict(b=2, l=300, msub=4, c=16)),
])
def test_tune_sweeps_every_kernel(kernel, dims):
    res = autotune.tune(kernel, iters=1, warmup=0, save=False,
                        time_fn=None if kernel == "scan" else
                        _stub_timer([1e-3] * 200), **CPU, **dims)
    assert res.speedup_vs_default >= 1.0
    assert all(c.ok for c in res.candidates)
    assert res.table_config == DEFAULT and res.table_time_s is not None
    assert res.key.endswith("|float32|cpu|cpu")


def test_suggest_rows_needs_a_gain_at_every_shape_of_a_bucket():
    def rec(bucket, derived, spread, times):
        return dict(kernel="lloyd", bucket=bucket, derived_ms=derived,
                    spread=spread, candidates=[
                        dict(ok=True, ms=t, requested=[r])
                        for r, t in times])
    b8, b4 = {"blocks": 8}, {"blocks": 4}
    recs = [rec("A", 1.0, 0.02, [({}, 1.0), (b8, 0.8), (b4, 0.9)]),
            rec("A", 2.0, 0.02, [({}, 2.0), (b8, 1.9), (b4, 1.7)]),
            rec("B", 1.0, 0.02, [({}, 1.0), (b8, 0.9)]),
            rec("B", 1.0, 0.02, [({}, 1.0), (b8, 1.1)]),
            rec("C", 1.0, 0.30, [({}, 1.0), (b8, 0.9)])]
    # A: blocks=4 is worst 0.9 of the derived plan, blocks=8 worst 0.95;
    # B: the derived plan wins at one shape; C: within the spread
    assert autotune.suggest_rows(recs) == {"lloyd": {"A": b4}}


def test_sweep_record_schema_and_suggestion():
    """One sweep point's record (the campaign's unit, what the card's
    sweep prints a line of) and the rows suggested from it."""
    shape = autotune.Shape("tiny", dict(b=2, m=3000, k=40, d=2))
    r = autotune.sweep_shape("lloyd", shape, iters=1, device="cpu",
                             sm_count=SMS, candidates=[TileConfig(blocks=1)])
    assert r["bucket"] == "B2_M4096_d2_K64" and r["key"].endswith("|cpu")
    assert r["derived_ms"] > 0 and r["best_ms"] <= r["derived_ms"]
    assert r["table_config"] == {} and r["table_ms"] == r["derived_ms"]
    assert [c["launch"]["blocks"] for c in r["candidates"]] == [12, 1]
    assert r["candidates"][0]["requested"] == [{}]
    json.dumps(r)
    rows = autotune.suggest_rows([r])
    gain = r["derived_ms"] / r["candidates"][1]["ms"] - 1 > r["spread"]
    assert rows == ({"lloyd": {r["bucket"]: {"blocks": 1}}} if gain else {})


def test_check_defaults_passes():
    assert autotune.check_defaults(verbose=False) >= len(autotune.KERNELS)
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.kernels.autotune",
         "--check-defaults"], capture_output=True, text=True, timeout=120,
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                       "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr
    assert "tune_table OK" in r.stdout and "Warning" not in r.stderr


def test_check_defaults_ignores_the_env_cache(tmp_path, monkeypatch):
    """A persistent file holding an entry for every probe key does not
    change what ``--check-defaults`` resolves: it checks the table alone."""
    p = tmp_path / "tune.json"
    monkeypatch.setenv(autotune.ENV_VAR, str(p))
    for kernel, shapes in autotune.SWEEP_SHAPES.items():
        key = autotune.cache_key(kernel, device="cpu", **shapes[0].dims)
        assert autotune.save_entry(key, TileConfig(blocks=3))
    autotune.clear_caches()
    assert autotune.check_defaults(verbose=False) >= len(autotune.KERNELS)


def test_sweep_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert autotune.main(["--sweep", "--smoke"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the scan's lookup
# ---------------------------------------------------------------------------

def test_scan_config_none_consults_the_cache(monkeypatch):
    from repro_torch.kernels.ref import adc_scan_ref
    from repro_torch.kernels.scan import adc_scan_cuda
    seen = []
    real = autotune.lookup
    monkeypatch.setattr(autotune, "lookup", lambda kernel, **kw: seen.append(
        (kernel, kw)) or real(kernel, **kw))
    rng = np.random.default_rng(0)
    luts = torch.from_numpy(rng.random((3, 4, 16), dtype=np.float32))
    codes = torch.from_numpy(rng.integers(0, 16, (3, 500, 4), dtype=np.uint8))
    got = adc_scan_cuda(luts, codes)
    assert seen == [("scan", dict(b=3, l=500, msub=4, c=16,
                                  dtype=torch.float32, device=luts.device))]
    assert torch.equal(got, adc_scan_ref(luts, codes))
    for blocks in (1, 2, 64):           # an explicit config skips the lookup
        assert torch.equal(adc_scan_cuda(luts, codes, TileConfig(
            blocks=blocks)), got)
    assert len(seen) == 1


# ---------------------------------------------------------------------------
# the cuda_tuned backend
# ---------------------------------------------------------------------------

def test_cuda_tuned_registered():
    assert "cuda_tuned" in available_backends()
    be = get_backend("cuda_tuned")
    assert isinstance(be, CudaTunedBackend)
    assert isinstance(be, CudaFusedBackend) and isinstance(be, CudaBackend)


def test_auto_resolves_cuda_tuned_on_the_card_and_torch_on_the_cpu(
        monkeypatch):
    monkeypatch.delenv(BACKEND_ENV, raising=False)
    assert get_backend("auto", device="cpu").name == "torch"
    assert get_backend("auto", device="cuda").name == "cuda_tuned"
    assert get_backend(None).name == "cuda_tuned"
    monkeypatch.setenv(BACKEND_ENV, "cuda_fused")       # the env var wins
    assert get_backend("auto", device="cuda").name == "cuda_fused"


def test_cuda_tuned_is_stateless_and_hashable():
    be = get_backend("cuda_tuned")
    assert be == CudaTunedBackend() and hash(be) == hash(CudaTunedBackend())
    assert be is not get_backend("cuda_tuned") and be.__dict__ == {}
    assert be != CudaFusedBackend() and be != CudaBackend()
    assert len({be, CudaTunedBackend(), CudaFusedBackend()}) == 2


def _lloyd_inputs(seed, b=3, m=400, d=5, k=11):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(b, m, d)).astype(np.float32))
    w = torch.from_numpy((rng.uniform(size=(b, m)) > 0.2).astype(np.float32))
    return x, w, x[:, :k].clone()


def test_cuda_tuned_on_cpu_tensors_is_the_torch_backend():
    x, w, c = _lloyd_inputs(1)
    tuned, plain = CudaTunedBackend(), LloydBackend()
    prep = tuned.prepare(x, w)
    for a, b in zip(tuned.step(prep, c), plain.step(prep, c)):
        assert torch.equal(a, b)
    for a, b in zip(tuned.assign(prep, c), plain.assign(prep, c)):
        assert torch.equal(a, b)
    assert torch.equal(tuned.sse(prep, c), plain.sse(prep, c))
    for a, b in zip(tuned.assign_points(x[0], c[0], block=64),
                    plain.assign_points(x[0], c[0], block=64)):
        assert torch.equal(a, b)


def test_cuda_tuned_fit_on_cpu_is_the_torch_fit_bit_for_bit():
    from repro_torch.api import SampledKMeans
    from repro_torch.core import ClusterSpec
    from repro_torch.data import blobs
    pts = blobs(2000, n_clusters=5, dim=3, seed=4)[0]

    def fit(backend):
        spec = ClusterSpec.make(5, n_sub=4, compression=20, local_iters=5,
                                global_iters=5, restarts=2, backend=backend)
        return SampledKMeans(spec, device="cpu").fit(pts, seed=3)
    a, b = fit("cuda_tuned"), fit("torch")
    assert torch.equal(a.centers_, b.centers_)
    assert torch.equal(a.sse_, b.sse_)
    assert torch.equal(a.predict(pts), b.predict(pts))


def test_cuda_tuned_step_matches_jax_pallas_tuned():
    """The tuned backends of both packages on the same inputs: the JAX
    package's ``pallas_tuned`` step (interpret mode) and the port's
    ``cuda_tuned`` step (its plain version off the card), at 1e-4."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(700, 9)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 700).astype(np.float32)
    c = x[:13].copy()
    jbe = jax_backend("pallas_tuned").with_k_hint(13)
    jsums, jcounts, jsse = jbe.step(jbe.prepare(jnp.asarray(x),
                                                jnp.asarray(w)),
                                    jnp.asarray(c))
    tbe = get_backend("cuda_tuned")
    got = tbe.step(tbe.prepare(torch.from_numpy(x)[None],
                               torch.from_numpy(w)[None]),
                   torch.from_numpy(c)[None])
    np.testing.assert_allclose(got.sums[0].numpy(), np.asarray(jsums),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.counts[0].numpy(), np.asarray(jcounts),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got.sse[0]), float(jsse), rtol=1e-4)
    jax.clear_caches()


@pytest.mark.parametrize("spec_kw", [
    dict(),                                             # the flat pipeline
    dict(levels=2),                                     # a reduce level
    dict(scheme="unequal", capacity_factor=1.5),        # Algorithm 2
    dict(minibatch=50),                                 # mini-batch merge
], ids=["flat", "level", "unequal", "minibatch"])
def test_plan_prewarms_every_lloyd_launch_of_the_fit(monkeypatch, spec_kw):
    """``plan()`` pulls each Lloyd shape of a single fit into the LRU, so
    every Lloyd lookup of the fit that follows, the first at each shape
    included, is a memory hit; the shapes are those the fit launches."""
    from repro_torch.api import execute, plan
    from repro_torch.core import ClusterSpec
    from repro_torch.data import blobs
    pts = blobs(2003, n_clusters=6, dim=3, seed=2)[0]
    spec = ClusterSpec.make(6, n_sub=4, compression=10, local_iters=3,
                            global_iters=3, restarts=2, backend="cuda_tuned",
                            **spec_kw)
    pl = plan(spec, data_shape=tuple(pts.shape), device="cpu")
    assert isinstance(pl.backend, CudaTunedBackend)
    want = spec.lloyd_shapes(pts.shape[0])
    for b, m, k in want:
        key = autotune.cache_key("lloyd", b=b, m=m, d=3, k=k, device="cpu")
        assert key in autotune._MEM
    seen = []
    real = autotune.lookup
    monkeypatch.setattr(autotune, "lookup", lambda kernel, **kw: seen.append(
        (kernel, (kw["b"], kw["m"], kw["k"]),
         real(kernel, with_source=True, **kw)[1])) or real(kernel, **kw))
    execute(pl, pts, seed=0)
    lloyd = [(shape, src) for kernel, shape, src in seen if kernel == "lloyd"]
    assert lloyd and {src for _, src in lloyd} == {"memory"}
    assert set(dict(lloyd)) == set(want)


def test_plan_prewarms_nothing_off_the_tuned_single_fit(monkeypatch):
    from repro_torch.api import plan
    from repro_torch.core import ClusterSpec
    calls = []
    monkeypatch.setattr(autotune, "prewarm",
                        lambda kernel, **kw: calls.append(kernel))
    # the torch backend on the CPU, and a plan without a data shape
    assert plan(ClusterSpec.make(40), data_shape=(4096, 32),
                device="cpu").backend.name == "torch"
    plan(ClusterSpec.make(40, backend="cuda_tuned"), device="cpu")
    assert calls == []
    plan(ClusterSpec.make(40, backend="cuda_tuned"), data_shape=(4096, 32),
         device="cpu")
    assert calls and set(calls) == {"lloyd"}
