"""The port's chunked data sources (``repro_torch.data.source``) against
the JAX package's: byte-identical synthetic chunks, shard and IterSource
traversal, and the prefetch pipeline's residency bound."""
import numpy as np
import pytest
import torch

from repro.data.source import IterSource as JaxIterSource
from repro.data.source import SyntheticSource as JaxSyntheticSource
from repro_torch.data import (ArraySource, DataSource, IterSource,
                              SyntheticSource, as_source, prefetch_to_device)


@pytest.mark.parametrize("chunk_points", [1000, 4096, 30_000])
def test_synthetic_chunks_are_byte_identical_to_jax(chunk_points):
    ours = SyntheticSource(23_456, dim=5, n_clusters=17, seed=7)
    ref = JaxSyntheticSource(23_456, dim=5, n_clusters=17, seed=7)
    assert ours.centers.tobytes() == ref.centers.tobytes()
    got = list(ours.chunks(chunk_points))
    want = list(ref.chunks(chunk_points))
    assert len(got) == len(want) == -(-23_456 // chunk_points)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes()


def test_synthetic_shards_are_the_parent_chunks():
    src = SyntheticSource(10_000, dim=3, seed=2)
    ref = JaxSyntheticSource(10_000, dim=3, seed=2)
    full = list(src.chunks(1024))
    shards = [list(src.shard(i, 3).chunks(1024)) for i in range(3)]
    for i, chunks in enumerate(shards):
        assert len(chunks) == len(full[i::3])
        for a, b, c in zip(chunks, full[i::3],
                           ref.shard(i, 3).chunks(1024)):
            assert a.tobytes() == b.tobytes() == np.asarray(c).tobytes()
    assert src.shard(0, 1) is src and src.shard(1, 3).dim == 3


def test_array_source_shards_partition_the_rows():
    x = np.arange(103 * 2, dtype=np.float32).reshape(103, 2)
    src = ArraySource(x)
    parts = [src.shard(i, 4) for i in range(4)]
    assert sum(p.n_points for p in parts) == 103
    np.testing.assert_array_equal(
        np.concatenate([c for p in parts for c in p.chunks(10)]), x)
    t = torch.from_numpy(x)
    assert as_source(t).shape == (103, 2)
    assert torch.equal(torch.cat(list(as_source(t).chunks(50))), t)
    with pytest.raises(ValueError, match="n_points, dim"):
        ArraySource(x[0])
    with pytest.raises(TypeError, match="DataSource"):
        as_source([1, 2, 3])
    with pytest.raises(ValueError, match="out of range"):
        src.shard(4, 4)


def test_iter_source_rebatches_like_jax():
    rng = np.random.default_rng(0)
    pieces = [rng.normal(size=(n, 4)).astype(np.float32)
              for n in (7, 300, 1, 64, 128, 5)]
    ours = IterSource(lambda: iter(pieces))
    ref = JaxIterSource(lambda: iter(pieces))
    got = list(ours.chunks(100))
    want = list(ref.chunks(100))
    assert [c.shape for c in got] == [c.shape for c in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert ours.dim == 4
    # restartable, from a container too
    assert len(list(IterSource(pieces).chunks(100))) == len(got)
    # the strided shard keeps every n-th re-batched chunk
    np.testing.assert_array_equal(
        np.concatenate(list(ours.shard(1, 2).chunks(100))),
        np.concatenate(got[1::2]))
    # a natively split store
    split = IterSource(lambda: iter(pieces),
                       shard_factory=lambda i, n: (lambda: iter(pieces[i::n])))
    np.testing.assert_array_equal(
        np.concatenate(list(split.shard(0, 2).chunks(1000))),
        np.concatenate(pieces[0::2]))


def test_iter_source_rejects_bad_input():
    with pytest.raises(ValueError, match="single-use"):
        IterSource(x for x in [np.zeros((2, 2))])
    with pytest.raises(ValueError, match="piece dim"):
        list(IterSource([np.zeros((2, 2)), np.zeros((2, 3))]).chunks(10))
    with pytest.raises(ValueError, match=r"\(m, dim\)"):
        list(IterSource([np.zeros(3)]).chunks(10))
    with pytest.raises(ValueError, match="shard_factory"):
        IterSource([np.zeros((2, 2))], shard_factory=3)
    with pytest.raises(NotImplementedError):
        DataSource().chunks(10)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetch_keeps_at_most_depth_chunks_alive(depth):
    """When the consumer holds chunk i, the stream has produced at most
    chunks 0 .. i + depth - 1, so at most ``depth`` are alive."""
    produced = []

    def stream():
        for i in range(7):
            produced.append(i)
            yield np.full((3, 2), i, np.float32)

    seen = []
    for i, chunk in enumerate(prefetch_to_device(stream(), depth,
                                                 device="cpu")):
        assert isinstance(chunk, torch.Tensor) and chunk.device.type == "cpu"
        assert int(chunk[0, 0]) == i
        assert len(produced) <= i + depth
        seen.append(i)
    assert seen == list(range(7))


def test_prefetch_passes_resident_tensors_and_validates():
    t = torch.ones(4, 2)
    assert next(prefetch_to_device([t], 2, device="cpu")) is t
    with pytest.raises(ValueError, match="depth"):
        next(prefetch_to_device([t], 0, device="cpu"))


def test_prefetch_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(prefetch_to_device([np.zeros((2, 2), np.float32)]))
