"""Chunked data sources: the out-of-core input type of the PyTorch port.

The port's counterpart of :mod:`repro.data.source`.  A
:class:`DataSource` hands out a dataset as a restartable stream of host
chunks, so the dataset never has to exist in one place:

  ``ArraySource``     wraps an in-memory (n, d) numpy array or tensor (the
                      one-chunk, or few-chunk, special case).
  ``IterSource``      wraps ANY host iterator factory (memmap slices, file
                      shards, a database cursor) and re-batches its pieces
                      into fixed ``chunk_points`` rows (one ragged tail at
                      most).
  ``SyntheticSource`` generates paper-style Gaussian blobs chunk by chunk,
                      deterministically per (seed, chunk index), with the
                      JAX package's numpy draws, so both packages see the
                      same bytes.

Sources may be traversed several times (``chunks()`` restarts), which is
why :class:`IterSource` takes a zero-argument *factory*, not a bare
generator.  ``source.shard(i, n)`` returns the ``i``-th of ``n`` disjoint
restartable sub-sources whose union at a fixed ``chunk_points`` is the
parent's point set.

:func:`prefetch_to_device` is the host-to-device pipeline: each chunk is
copied from pinned host memory on a side stream, ``depth`` chunks in
flight, and the consumer's stream waits on the chunk's copy event.
"""
from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device


class DataSource:
    """Protocol for chunked point sets (the out-of-core input type).

    Concrete sources expose

      * ``dim``       — point dimensionality, or ``None`` when not known
                        before iteration;
      * ``n_points``  — total row count, or ``None`` when unknown;
      * ``chunks(chunk_points)`` — a fresh iterator of ``(m, dim)`` host
        arrays with ``m <= chunk_points`` (only the final chunk may be
        ragged).  Must be restartable.
      * ``shard(i, n)`` — the ``i``-th of ``n`` disjoint sub-sources whose
        union at any fixed ``chunk_points`` is the parent's point set.
    """

    dim: Optional[int] = None
    n_points: Optional[int] = None

    def chunks(self, chunk_points: int) -> Iterator[np.ndarray]:
        raise NotImplementedError

    def shard(self, index: int, count: int) -> "DataSource":
        """The ``index``-th of ``count`` disjoint, restartable sub-sources.
        The default strides over the re-batched chunk stream (shard ``i``
        keeps chunks ``i, i+count, ...``); subclasses override with
        cheaper splits."""
        _check_shard(index, count)
        if count == 1:
            return self
        return _StridedShard(self, index, count)

    @property
    def shape(self) -> Optional[tuple]:
        """(n_points, dim) when both are known, else ``None``."""
        if self.n_points is None or self.dim is None:
            return None
        return (self.n_points, self.dim)


def _check_shard(index: int, count: int) -> None:
    if count < 1:
        raise ValueError(f"shard: count must be >= 1, got {count}")
    if not 0 <= index < count:
        raise ValueError(f"shard: index {index} out of range for "
                         f"count {count}")


class _StridedShard(DataSource):
    """Generic ``shard(i, n)``: every ``n``-th chunk of the parent's
    re-batched stream, starting at chunk ``i`` (the parent is still
    traversed in full; skipped chunks are produced and discarded)."""

    def __init__(self, parent: DataSource, index: int, count: int):
        self.parent, self.index, self.count = parent, index, count
        self.n_points = None        # per-shard rows depend on chunk_points

    @property
    def dim(self) -> Optional[int]:   # IterSource infers dim lazily
        return self.parent.dim

    def chunks(self, chunk_points: int) -> Iterator[np.ndarray]:
        for j, chunk in enumerate(self.parent.chunks(chunk_points)):
            if j % self.count == self.index:
                yield chunk


class ArraySource(DataSource):
    """A resident 2-D numpy array or tensor as a source.  ``chunks`` yields
    row slices (views, no copy)."""

    def __init__(self, array):
        if array.ndim != 2:
            raise ValueError(
                f"ArraySource: need a (n_points, dim) array, got shape "
                f"{tuple(array.shape)}")
        self.array = array
        self.n_points, self.dim = (int(array.shape[0]), int(array.shape[1]))

    def chunks(self, chunk_points: int) -> Iterator:
        for start in range(0, self.n_points, chunk_points):
            yield self.array[start:start + chunk_points]

    def shard(self, index: int, count: int) -> "ArraySource":
        """Balanced contiguous row-range split: shard ``i`` holds rows
        ``[i·n/count, (i+1)·n/count)`` (a view, no copy)."""
        _check_shard(index, count)
        if count == 1:
            return self
        lo = (index * self.n_points) // count
        hi = ((index + 1) * self.n_points) // count
        return ArraySource(self.array[lo:hi])


class IterSource(DataSource):
    """Any host iterator as a source, re-batched to fixed-size chunks.

    Parameters
    ----------
    factory:   zero-argument callable returning a fresh iterator/iterable of
               ``(m_i, dim)`` arrays (possibly ragged ``m_i``).  A
               re-iterable container (list, tuple) is also accepted.  A
               bare generator object is rejected: it is single-use.
    dim:       point dimensionality, when known up front (otherwise
               inferred on first traversal).
    n_points:  total rows, when known.
    shard_factory: optional ``(index, count) -> factory`` hook for storage
               that is natively split; ``shard(i, n)`` then wraps
               ``shard_factory(i, n)`` in a fresh IterSource.
    """

    def __init__(self, factory: Callable[[], Iterable] | Iterable, *,
                 dim: Optional[int] = None, n_points: Optional[int] = None,
                 shard_factory: Optional[Callable] = None):
        if callable(factory):
            self._factory = factory
        elif iter(factory) is factory:
            raise ValueError(
                "IterSource: got a single-use iterator (e.g. a bare "
                "generator object) — a source is traversed several times. "
                "Pass a zero-argument factory instead: "
                "IterSource(lambda: my_generator(...))")
        else:
            seq = factory
            self._factory = lambda: iter(seq)
        if shard_factory is not None and not callable(shard_factory):
            raise ValueError(
                "IterSource: shard_factory must be a callable "
                "(index, count) -> iterator factory")
        self._shard_factory = shard_factory
        self.dim = dim
        self.n_points = n_points

    def shard(self, index: int, count: int) -> DataSource:
        """With a ``shard_factory``, a fresh IterSource over
        ``shard_factory(i, count)``; without one, the strided split."""
        _check_shard(index, count)
        if count == 1:
            return self
        if self._shard_factory is not None:
            return IterSource(self._shard_factory(index, count),
                              dim=self.dim)
        return _StridedShard(self, index, count)

    def chunks(self, chunk_points: int) -> Iterator[np.ndarray]:
        buf: list[np.ndarray] = []
        have = 0
        for piece in self._factory():
            piece = np.asarray(piece)
            if piece.ndim != 2:
                raise ValueError(
                    f"IterSource: every piece must be (m, dim), got shape "
                    f"{tuple(piece.shape)}")
            if self.dim is None:
                self.dim = int(piece.shape[1])
            elif piece.shape[1] != self.dim:
                raise ValueError(
                    f"IterSource: piece dim {piece.shape[1]} != source dim "
                    f"{self.dim}")
            while piece.shape[0]:
                take = min(chunk_points - have, piece.shape[0])
                buf.append(piece[:take])
                have += take
                piece = piece[take:]
                if have == chunk_points:
                    yield (buf[0] if len(buf) == 1
                           else np.concatenate(buf, axis=0))
                    buf, have = [], 0
        if have:
            yield buf[0] if len(buf) == 1 else np.concatenate(buf, axis=0)


class SyntheticSource(DataSource):
    """Paper-style Gaussian blobs, generated chunk by chunk.

    Cluster centers are drawn once from ``seed``; chunk ``i``'s points are
    drawn from ``(seed, i)``, with the same numpy calls as the JAX
    package's ``SyntheticSource``, so the two produce identical bytes.  No
    more than one chunk is ever resident on the host.
    """

    def __init__(self, n_points: int, dim: int = 2,
                 n_clusters: Optional[int] = None, seed: int = 0,
                 spread: float = 0.04):
        self.n_points = int(n_points)
        self.dim = int(dim)
        self.n_clusters = n_clusters or max(2, n_points // 500)
        self.seed = seed
        self.spread = spread
        rng = np.random.default_rng(seed)
        self.centers = rng.uniform(
            0.0, 10.0, (self.n_clusters, dim)).astype(np.float32)

    def _chunk(self, i: int, chunk_points: int) -> np.ndarray:
        """Chunk ``i`` of the ``chunk_points`` traversal, deterministic per
        (seed, i)."""
        start = i * chunk_points
        m = min(chunk_points, self.n_points - start)
        rng = np.random.default_rng((self.seed, 1 + i))
        ids = rng.integers(0, self.n_clusters, m)
        return (self.centers[ids]
                + rng.normal(0.0, self.spread * 10.0, (m, self.dim))
                ).astype(np.float32)

    def chunks(self, chunk_points: int) -> Iterator[np.ndarray]:
        for i in range(-(-self.n_points // chunk_points)):
            yield self._chunk(i, chunk_points)

    def shard(self, index: int, count: int) -> DataSource:
        """Chunk-index partition: shard ``i`` generates exactly the chunks
        ``i, i+count, ...`` of the parent traversal (skipped chunks are
        never synthesized)."""
        _check_shard(index, count)
        if count == 1:
            return self
        return _SyntheticShard(self, index, count)


class _SyntheticShard(DataSource):
    """Every ``count``-th chunk of a :class:`SyntheticSource`, generated
    directly by chunk index; chunk ``j``'s bytes equal the parent's."""

    def __init__(self, parent: SyntheticSource, index: int, count: int):
        self.parent = parent
        self.index = index
        self.count = count
        self.n_points = None

    @property
    def dim(self) -> int:
        return self.parent.dim

    def chunks(self, chunk_points: int) -> Iterator[np.ndarray]:
        n_chunks = -(-self.parent.n_points // chunk_points)
        for j in range(self.index, n_chunks, self.count):
            yield self.parent._chunk(j, chunk_points)


def as_source(x) -> DataSource:
    """Coerce to a :class:`DataSource`: sources pass through, 2-D arrays
    (numpy or torch) wrap into :class:`ArraySource`."""
    if isinstance(x, DataSource):
        return x
    if hasattr(x, "ndim") and hasattr(x, "shape"):
        return ArraySource(x)
    raise TypeError(
        f"as_source: expected a DataSource or a (n, d) array, got "
        f"{type(x).__name__} (wrap host iterators in IterSource)")


def prefetch_to_device(chunks: Iterable, depth: int = 2, *,
                       device: "torch.device | str | None" = None
                       ) -> Iterator[torch.Tensor]:
    """Host-to-device pipeline over a chunk stream, ``depth`` chunks in
    flight, on ``device`` (``None``: the CUDA device).

    On a CUDA device each host chunk is copied into pinned memory and from
    there, asynchronously, on a side stream; an event recorded after the
    copy is waited on by the consumer's current stream before the chunk is
    handed out, so the consumer never reads a half-copied chunk, and the
    pinned buffer stays referenced until its chunk has been consumed (the
    caching host allocator also holds it until the copy's event).  Chunks
    already on ``device`` pass through.  The buffer is refilled after the
    consumer resumes, not before the yield, so during the consumer's work
    exactly ``depth`` chunks are alive: the one handed out plus ``depth - 1``
    buffered.  ``depth=1`` is sequential transfer.  On the CPU the chunks
    become tensors with the same buffering."""
    if depth < 1:
        raise ValueError(f"prefetch_to_device: depth must be >= 1, "
                         f"got {depth}")
    dev = resolve_device(device)
    side = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None

    def put(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        if t.device.type != "cpu" or side is None:   # on a device already
            return t.to(dev), None, None
        pinned = t.pin_memory()
        with torch.cuda.stream(side):
            out = pinned.to(dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        return out, done, pinned

    def hand_out(entry):
        out, done, _pinned = entry
        if done is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(done)
            out.record_stream(consumer)    # allocated on the side stream
        return out

    it = iter(chunks)
    buf: collections.deque = collections.deque()
    for x in it:
        buf.append(put(x))
        if len(buf) == depth:
            break
    while buf:
        yield hand_out(buf[0])
        buf.popleft()
        nxt = next(it, None)
        if nxt is not None:
            buf.append(put(nxt))
