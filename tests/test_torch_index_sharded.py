"""The IVF/PQ index built over a device mesh (``build_index(mesh=)``):
training is the unsharded build's and encoding is row by row, so the
sharded index is the unsharded one bit for bit, with ids assigned
shard-major.  For contiguous row-range shards (``ArraySource``) that is
the source's row order; for chunk-strided shards (an ``IterSource``) the
ids number the rows shard by shard, and each row keeps its cell and
codes."""
import numpy as np
import pytest
import torch

from repro_torch.data import ArraySource, IterSource
from repro_torch.index import IndexSpec, build_index, plan_index
from repro_torch.launch.mesh import make_mesh
from repro_torch.telemetry import RecordingLogger


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


SPEC = IndexSpec.make(nlist=16, n_subspaces=8, bits=8, nprobe=4,
                      train_points=1500, n_sub=4, chunk_points=1024)


def _mesh(n):
    return make_mesh((n,), ("data",), ["cpu"] * n)


@pytest.fixture(scope="module")
def unsharded(corpus):
    return build_index(ArraySource(corpus[0]), SPEC, 5, device="cpu")


def _assert_same_index(a, b):
    for f in ("coarse_centers", "codebooks", "codes", "ids", "counts"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_row_range_shards_build_the_unsharded_index(corpus, unsharded,
                                                     n_shards):
    index, stats = build_index(ArraySource(corpus[0]), SPEC, 5,
                               mesh=_mesh(n_shards))
    _assert_same_index(index, unsharded[0])
    assert stats.n_shards == n_shards and stats.n_points == 6000
    # 6000 rows in 1024-row chunks: 6 chunks unsharded, more once the
    # shards' ragged tails split
    assert stats.n_chunks >= unsharded[1].n_chunks
    q = torch.from_numpy(corpus[1])
    for a, b in zip(index.search(q, 10), unsharded[0].search(q, 10)):
        assert torch.equal(a, b)


def test_strided_shards_number_rows_shard_by_shard(corpus, unsharded):
    """An IterSource shards by chunk (shard i keeps chunks i, i + n, ...):
    ids are positions in the shard-major stream, and every row keeps the
    unsharded build's cell and codes."""
    x = corpus[0]
    src = IterSource(lambda: iter(np.array_split(x, 7)), dim=8,
                     n_points=6000)
    index, stats = build_index(src, SPEC, 5, mesh=_mesh(2))
    ref = unsharded[0]
    assert stats.n_shards == 2 and torch.equal(index.counts, ref.counts)
    assert torch.equal(index.coarse_centers, ref.coarse_centers)
    # shard-major position -> source row (chunks 0, 2, 4 then 1, 3, 5)
    starts = [(j * 1024, min((j + 1) * 1024, 6000)) for j in range(6)]
    rows = np.concatenate([np.arange(*starts[j]) for j in (0, 2, 4, 1, 3, 5)])

    def by_row(idx):
        cell = torch.full((6000,), -1, dtype=torch.long)
        code = torch.zeros((6000, idx.codes.shape[2]), dtype=torch.uint8)
        live = idx.ids >= 0
        ids = idx.ids[live].long()
        if idx is index:
            ids = torch.from_numpy(rows)[ids]
        cell[ids] = live.nonzero()[:, 0]
        code[ids] = idx.codes[live]
        return cell, code

    for a, b in zip(by_row(index), by_row(ref)):
        assert torch.equal(a, b)


def test_plan_and_telemetry_of_a_sharded_build(corpus):
    x = corpus[0]
    iplan = plan_index(SPEC, x.shape, mesh=_mesh(2))
    assert iplan.mesh is not None and iplan.device == torch.device("cpu")
    with pytest.raises(TypeError, match="Mesh"):
        plan_index(SPEC, x.shape, mesh=object())
    log = RecordingLogger()
    build_index(ArraySource(x), SPEC, 5, mesh=_mesh(2), logger=log)
    assert log.named("index_encode")[0]["n_shards"] == 2
    shards = {e["shard"] for e in log.named("index_encode_rate")}
    assert shards == {0, 1}
    assert log.named("index_built")[0]["n_shards"] == 2
