"""The port's IVF/PQ index (``repro_torch.index``) against the JAX
package's: spec round-trips and hashes, fail-fast planning, encode / LUT /
search parity on an index carried across from the JAX package, and the
port's own builds (recall, out-of-core identity, padding, telemetry).

Tolerances: ADC distances rtol 1e-5 (f32 sums in another order); exact
distances also a cancellation allowance of 4 ulps of |x|^2 + |q|^2 (the
expanded form |x|^2 + |q|^2 - 2 x.q rounds at that scale, whatever the
distance); ids and codes equal except at near-ties, where the two
candidates' distances are equal within those tolerances; recall@10 >= 0.9
(tests/test_index.py's floor)."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index import IndexSpec as JaxIndexSpec
from repro.index import build_index as jax_build
from repro.index import exact_search as jax_exact
from repro.index.pq import build_luts as jax_luts
from repro.index.pq import encode_residuals as jax_encode
from repro_torch import convert
from repro_torch.core.backend import LloydBackend
from repro_torch.data import IterSource
from repro_torch.index import (IndexSpec, PQSpec, build_index, decode,
                               encode_residuals, exact_search, plan_index,
                               recall_at_k, search, split_subspaces,
                               train_codebooks)
from repro_torch.index.ivf import _probe_cells
from repro_torch.index.pq import build_luts
from repro_torch.telemetry import RecordingLogger

SPECS = sorted((Path(__file__).resolve().parents[1] / "benchmarks"
                / "specs").glob("index_*.json"))


@pytest.fixture(scope="module")
def corpus():
    """tests/test_index.py's corpus: 6000 x 8 around 16 centers."""
    rng = np.random.default_rng(3)
    centers = rng.uniform(0, 10, (16, 8)).astype(np.float32)
    ids = rng.integers(0, 16, 6000)
    x = (centers[ids] + rng.normal(0, 0.35, (6000, 8))).astype(np.float32)
    q = (centers[rng.integers(0, 16, 48)]
         + rng.normal(0, 0.35, (48, 8))).astype(np.float32)
    return x, q


def _spec(cls):
    return cls.make(nlist=16, n_subspaces=8, bits=8, nprobe=4,
                    train_points=1500, n_sub=4, chunk_points=1024)


@pytest.fixture(scope="module")
def built(corpus):
    return build_index(corpus[0], _spec(IndexSpec), 5, device="cpu")


@pytest.fixture(scope="module")
def jax_index(corpus):
    index, _ = jax_build(corpus[0], _spec(JaxIndexSpec),
                         jax.random.PRNGKey(5))
    return index


@pytest.fixture(scope="module")
def carried(jax_index):
    return convert.index_from_jax(
        jax_index.spec.to_dict(), np.asarray(jax_index.coarse_centers),
        np.asarray(jax_index.codebooks), np.asarray(jax_index.codes),
        np.asarray(jax_index.ids), np.asarray(jax_index.counts),
        device="cpu")


def _near_tie_ok(got_i, want_i, got_d, want_d, rtol=1e-5, atol=1e-6):
    """Distances at (rtol, atol); ids equal wherever a neighbouring
    distance is not within the same tolerance."""
    np.testing.assert_allclose(got_d, want_d, rtol=rtol, atol=atol)
    diff = got_i != want_i
    if diff.any():
        # a swapped id is only allowed between (near-)equal distances
        close = np.isclose(want_d[:, 1:], want_d[:, :-1], rtol=rtol,
                           atol=2 * atol)
        tie = np.zeros_like(want_d, bool)
        tie[:, 1:] |= close
        tie[:, :-1] |= close
        assert tie[diff].all(), (want_d[diff], got_d[diff])


# ---------------------------------------------------------------------------
# spec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", SPECS, ids=lambda p: p.stem)
def test_bench_spec_hash_equals_jax(path):
    d = json.loads(path.read_text())["index_spec"]
    ours, ref = IndexSpec.from_dict(d), JaxIndexSpec.from_dict(d)
    assert ours.to_dict() == ref.to_dict()
    assert ours.stable_hash() == ref.stable_hash()
    assert IndexSpec.from_dict(ours.to_dict()) == ours


def test_index_spec_roundtrip_make_and_replace():
    spec = IndexSpec.make(nlist=64, n_subspaces=8, bits=4, nprobe=4,
                          train_points=2048, n_sub=4)
    ref = JaxIndexSpec.make(nlist=64, n_subspaces=8, bits=4, nprobe=4,
                            train_points=2048, n_sub=4)
    assert spec.stable_hash() == ref.stable_hash()
    assert IndexSpec.from_dict(spec.to_dict()) == spec
    assert spec.nlist == 64 and spec.pq.n_codes == 16
    assert spec.coarse.merge.init == "kmeans||"
    assert spec.replace(bits=8).pq.bits == 8
    assert spec.replace(chunk_points=1234).coarse.chunk.chunk_points == 1234
    assert spec.replace(mode="single").stable_hash() == spec.stable_hash()
    assert spec.replace(nprobe=17).stable_hash() != spec.stable_hash()
    d = spec.to_dict()
    d["typo"] = 1
    with pytest.raises(ValueError, match="typo"):
        IndexSpec.from_dict(d)
    with pytest.raises(ValueError, match="bits"):
        PQSpec(bits=5)


def test_plan_index_fail_fast():
    spec = IndexSpec.make(nlist=32, n_subspaces=8, train_points=2048)
    with pytest.raises(ValueError, match="divide"):
        plan_index(spec, (10_000, 12), device="cpu")
    with pytest.raises(ValueError, match="nprobe"):
        plan_index(spec.replace(nprobe=33), (10_000, 16), device="cpu")
    with pytest.raises(ValueError, match="codebooks"):
        plan_index(IndexSpec.make(nlist=8, bits=8, train_points=100),
                   device="cpu")
    with pytest.raises(ValueError, match="nlist"):
        plan_index(IndexSpec.make(nlist=512, bits=4, train_points=256),
                   device="cpu")
    ip = plan_index(spec, (10_000, 16), device="cpu")
    assert ip.nlist == 32 and ip.coarse.mode == "single"
    assert ip.dim == 16 and ip.n_points == 10_000
    assert ip.device.type == "cpu" and ip.backend.name == "torch"


# ---------------------------------------------------------------------------
# parity on an index carried across from the JAX package
# ---------------------------------------------------------------------------

def test_carried_index_keeps_the_arrays(jax_index, carried):
    assert carried.spec.stable_hash() == jax_index.spec.stable_hash()
    assert carried.n_points == jax_index.n_points == 6000
    assert carried.cap == jax_index.cap
    np.testing.assert_array_equal(carried.codes.numpy(),
                                  np.asarray(jax_index.codes))
    with pytest.raises(ValueError, match="do not match"):
        convert.index_from_jax(jax_index.spec.to_dict(),
                               np.asarray(jax_index.coarse_centers)[:3],
                               np.asarray(jax_index.codebooks),
                               np.asarray(jax_index.codes),
                               np.asarray(jax_index.ids),
                               np.asarray(jax_index.counts), device="cpu")


def test_encode_matches_jax(corpus, jax_index):
    x, _ = corpus
    cb = np.array(jax_index.codebooks)
    resid = x - np.asarray(jax_index.coarse_centers)[np.arange(6000) % 16]
    want = np.asarray(jax_encode(jnp.asarray(resid), jnp.asarray(cb)))
    got = encode_residuals(torch.from_numpy(resid),
                           torch.from_numpy(cb)).numpy()
    assert got.dtype == np.uint8
    diff = got != want
    # a differing code is a near-tie: both entries equally close
    m, c, ds = cb.shape
    r = resid.reshape(-1, m, ds)
    rows, subs = np.nonzero(diff)
    dg = ((r[rows, subs] - cb[subs, got[rows, subs]]) ** 2).sum(-1)
    dw = ((r[rows, subs] - cb[subs, want[rows, subs]]) ** 2).sum(-1)
    assert np.allclose(dg, dw, rtol=1e-5, atol=1e-6)
    assert diff.mean() < 1e-3


def test_luts_and_probes_match_jax(corpus, jax_index, carried):
    _, q = corpus
    cells = _probe_cells(torch.from_numpy(q), carried.coarse_centers, 4)
    got = build_luts(torch.from_numpy(q), cells, carried.coarse_centers,
                     carried.codebooks)
    want = jax_luts(jnp.asarray(q), jnp.asarray(cells.numpy()),
                    jax_index.coarse_centers, jax_index.codebooks)
    assert got.shape == (48, 4, 8, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("nprobe,k", [(1, 10), (4, 10), (16, 25)])
def test_search_matches_jax(corpus, jax_index, carried, nprobe, k):
    _, q = corpus
    want_d, want_i = jax_index.search(q, k=k, nprobe=nprobe)
    got_d, got_i = carried.search(q, k=k, nprobe=nprobe)
    assert got_i.dtype == torch.int32 and got_d.dtype == torch.float32
    _near_tie_ok(got_i.numpy(), np.asarray(want_i), got_d.numpy(),
                 np.asarray(want_d))


def test_exact_search_matches_jax(corpus):
    x, q = corpus
    want_d, want_i = jax_exact(x, q, k=10)
    got_d, got_i = exact_search(x, q, k=10, device="cpu")
    cancel = 4 * np.finfo(np.float32).eps * float(
        (x * x).sum(1).max() + (q * q).sum(1).max())
    _near_tie_ok(got_i.numpy(), np.asarray(want_i), got_d.numpy(),
                 np.asarray(want_d), atol=cancel)
    src = IterSource(lambda: (x[i:i + 611] for i in range(0, len(x), 611)),
                     dim=8)
    d2, i2 = exact_search(src, q, k=10, chunk_points=577, device="cpu")
    assert torch.equal(i2, got_i)
    torch.testing.assert_close(d2, got_d, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the port's own builds
# ---------------------------------------------------------------------------

def test_search_beats_recall_floor(corpus, built):
    x, q = corpus
    index, stats = built
    assert stats.n_points == 6000 and stats.passes == 2
    _, true_ids = exact_search(x, q, k=10, device="cpu")
    _, ids = index.search(q, k=10, nprobe=4)
    assert recall_at_k(ids, true_ids) >= 0.9


def test_build_out_of_core_identical(corpus, built):
    x, _ = corpus
    index, _ = built
    src = IterSource(lambda: (x[i:i + 997] for i in range(0, len(x), 997)),
                     dim=8, n_points=len(x))
    ooc, stats = build_index(src, _spec(IndexSpec), 5, device="cpu")
    for name in ("coarse_centers", "codebooks", "codes", "ids", "counts"):
        assert torch.equal(getattr(index, name), getattr(ooc, name)), name
    assert stats.n_chunks > 1 and stats.max_chunk_points <= 1024
    assert stats.train_rows == 1500
    assert stats.max_resident_rows < len(x) / 2


def test_search_distances_sorted_and_blocks_identical(corpus, built):
    _, q = corpus
    index, _ = built
    d, ids = index.search(q, k=10)
    assert (d.diff(dim=1) >= 0).all() and torch.isfinite(d).all()
    assert (ids >= 0).all()
    d_full, _ = index.search(q, k=10, nprobe=index.nlist)
    assert (d_full[:, 0] <= d[:, 0] + 1e-6).all()
    d7, i7 = index.search(q, k=5, q_block=7)
    d48, i48 = index.search(q, k=5, q_block=48)
    assert torch.equal(i7, i48) and torch.equal(d7, d48)


def test_search_empty_cells_pad_with_minus_one():
    """Fewer points than k: every real point surfaces once, the rest of
    the top-k is inf / -1."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 10, (20, 8)).astype(np.float32)
    spec = IndexSpec.make(nlist=4, n_subspaces=4, bits=4, nprobe=4,
                          train_points=32, n_sub=2, compression=1,
                          restarts=1)
    index, _ = build_index(x, spec, device="cpu")
    assert index.n_points == 20 and index.n_nonempty <= 4
    d, ids = search(index, x[:3], k=25, nprobe=4)
    for row_d, row_i in zip(d, ids):
        real = row_i >= 0
        assert int(real.sum()) == 20
        assert sorted(row_i[real].tolist()) == list(range(20))
        assert torch.isinf(row_d[~real]).all()


def test_pq_roundtrip_error_small():
    rng = np.random.default_rng(0)
    centers = rng.uniform(0, 10, (4, 8)).astype(np.float32)
    x = torch.from_numpy((centers[rng.integers(0, 4, 2000)]
                          + rng.normal(0, 0.3, (2000, 8))).astype(np.float32))
    coarse = torch.from_numpy(centers)
    cells, _ = LloydBackend().assign_points(x, coarse)
    resid = x - coarse[cells.long()]
    cb = train_codebooks(resid, PQSpec(n_subspaces=8, bits=8, iters=8), 0)
    assert cb.shape == (8, 256, 1)
    codes = encode_residuals(resid, cb, block=500)
    assert torch.equal(codes, encode_residuals(resid, cb, block=None))
    recon = decode(cells, codes, coarse, cb)
    err = float(((recon - x) ** 2).sum(-1).mean())
    assert err < 0.05 * float((resid ** 2).sum(-1).mean())


def test_codebooks_train_as_one_batched_fit():
    """Every Lloyd step of the codebook fits serves all subspaces at once
    (one kernel launch per iteration on the card)."""
    shapes = []

    class Spy(LloydBackend):
        def step(self, prep, centers):
            shapes.append(tuple(prep.x.shape))
            return super().step(prep, centers)

    x = torch.randn(300, 12, generator=torch.Generator().manual_seed(0))
    sub = split_subspaces(x, 6)
    assert sub.shape == (6, 300, 2) and sub.is_contiguous()
    assert torch.equal(sub[1, 3], x[3, 2:4])
    with pytest.raises(ValueError, match="divide"):
        split_subspaces(x, 5)
    cb = train_codebooks(x, PQSpec(n_subspaces=6, bits=4, iters=3), 0,
                         backend=Spy())
    assert cb.shape == (6, 16, 2)
    assert shapes == [(6, 300, 2)] * 4           # 3 iterations + final pass


def test_build_and_search_telemetry(corpus, built):
    x, q = corpus
    log = RecordingLogger()
    build_index(x, _spec(IndexSpec), device="cpu", logger=log)
    names = {e["name"] for e in log.events}
    assert {"index_build", "index_train_sample", "index_train_coarse",
            "index_train_pq", "index_encode", "index_assemble",
            "index_built"} <= names
    assert log.named("index_built")[-1]["n_points"] == len(x)
    log = RecordingLogger()
    built[0].search(q[:8], k=5, logger=log)
    names = [e["name"] for e in log.events]
    assert {"index_probe", "index_scan", "index_search"} <= set(names)
    rates = log.named("index_query_rate")
    assert rates and rates[-1]["step_units"] == 8


def test_build_and_search_reject_bad_calls(corpus, built):
    x, q = corpus
    index, _ = built
    with pytest.raises(ValueError, match="nprobe"):
        index.search(q, k=5, nprobe=index.nlist + 1)
    with pytest.raises(ValueError, match="queries"):
        index.search(q[:, :4], k=5)
    with pytest.raises(TypeError, match="mesh"):
        build_index(x, _spec(IndexSpec), mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="no rows"):
        build_index(IterSource(lambda: iter([]), dim=8), _spec(IndexSpec),
                    device="cpu")
    assert recall_at_k(np.array([[0, 1, 9, 8]]), np.array([[0, 1, 2, 3]])) \
        == 0.5
    assert recall_at_k(torch.tensor([[1, 0, 7, 7]]),
                       torch.tensor([[0, 1, -1, -1]])) == 1.0
