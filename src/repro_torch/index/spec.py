"""Declarative IVF/PQ index specification — the port's counterpart of
:mod:`repro.index.spec`, with the same JSON form and ``stable_hash``.

An IVF index is the paper's pipeline run for a different consumer: the
coarse quantizer is a :class:`~repro_torch.core.spec.ClusterSpec` job, the
inverted lists are its assignment, and the per-subspace PQ codebooks are
the local k-means stage re-applied once per subspace.

    spec = IndexSpec.make(nlist=256, n_subspaces=16, bits=8, nprobe=8)
    index, stats = build_index(source, spec)
    dists, ids = index.search(queries, k=10)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

from repro_torch.core.spec import ClusterSpec, StopSpec

_PQ_BITS = (4, 8)


@dataclasses.dataclass(frozen=True)
class PQSpec:
    """Product-quantization layout: ``d`` dims split into ``n_subspaces``
    blocks of ``d / n_subspaces`` dims, each encoded against its own
    ``2**bits``-entry codebook trained on coarse residuals.

    ``iters`` is the Lloyd budget of each codebook fit (a deprecated alias
    for ``stop``, which wins when set); ``bits`` is 4 or 8 (codes are
    stored as uint8 either way)."""
    n_subspaces: int = 16
    bits: int = 8
    iters: int = 10
    stop: Optional[StopSpec] = None

    def __post_init__(self):
        if self.n_subspaces < 1:
            raise ValueError(
                f"PQSpec: n_subspaces must be >= 1, got {self.n_subspaces}")
        if self.bits not in _PQ_BITS:
            raise ValueError(
                f"PQSpec: bits must be one of {_PQ_BITS}, got {self.bits}")
        if self.iters < 1:
            raise ValueError(f"PQSpec: iters must be >= 1, got {self.iters}")

    @property
    def effective_stop(self) -> StopSpec:
        """``stop`` when set, else ``StopSpec(max_iters=iters)``."""
        return (self.stop if self.stop is not None
                else StopSpec(max_iters=self.iters))

    @property
    def n_codes(self) -> int:
        """Codebook entries per subspace (``2**bits``)."""
        return 1 << self.bits


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """The full IVF/PQ job: a coarse-quantizer ``ClusterSpec`` (its
    ``merge.k`` is the cell count ``nlist``), the PQ layout, the default
    probe width, and the training-sample budget (the build trains on the
    *first* ``train_points`` rows of the source, a chunking-invariant
    prefix)."""
    coarse: ClusterSpec
    pq: PQSpec = PQSpec()
    nprobe: int = 8
    train_points: int = 65536

    def __post_init__(self):
        if self.nprobe < 1:
            raise ValueError(
                f"IndexSpec: nprobe must be >= 1, got {self.nprobe}")
        if self.train_points < 1:
            raise ValueError(
                f"IndexSpec: train_points must be >= 1, got "
                f"{self.train_points}")

    @property
    def nlist(self) -> int:
        """Inverted-list (cell) count — the coarse quantizer's ``k``."""
        return self.coarse.merge.k

    @classmethod
    def make(cls, nlist: int, *, n_subspaces: int = 16, bits: int = 8,
             pq_iters: int = 10, nprobe: int = 8,
             train_points: int = 65536, init: str = "kmeans++",
             merge_init: Optional[str] = None,
             **coarse_kwargs) -> "IndexSpec":
        """Build an index spec from flat kwargs; ``nlist`` and the extra
        ``coarse_kwargs`` go to :meth:`ClusterSpec.make`.  The coarse merge
        defaults to kmeans|| seeding (``merge_init=`` overrides)."""
        coarse = ClusterSpec.make(nlist, init=init,
                                  merge_init=merge_init or "kmeans||",
                                  **coarse_kwargs)
        return cls(coarse=coarse,
                   pq=PQSpec(n_subspaces=n_subspaces, bits=bits,
                             iters=pq_iters),
                   nprobe=nprobe, train_points=train_points)

    def to_dict(self) -> dict:
        pq = dataclasses.asdict(self.pq)
        if pq.get("stop") is None:
            pq.pop("stop", None)     # omitted when unset: hashes unchanged
        return {
            "coarse": self.coarse.to_dict(),
            "pq": pq,
            "nprobe": self.nprobe,
            "train_points": self.train_points,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "IndexSpec":
        d = dict(d)
        coarse = ClusterSpec.from_dict(d.pop("coarse"))
        pq = dict(d.pop("pq", {}))
        known = {f.name for f in dataclasses.fields(PQSpec)}
        unknown = set(pq) - known
        if unknown:
            raise ValueError(
                f"IndexSpec.from_dict: unknown pq keys {sorted(unknown)}; "
                f"known: {sorted(known)}")
        if pq.get("stop") is not None and not isinstance(pq["stop"], StopSpec):
            stop = dict(pq["stop"])
            stop_known = {f.name for f in dataclasses.fields(StopSpec)}
            stop_unknown = set(stop) - stop_known
            if stop_unknown:
                raise ValueError(
                    f"IndexSpec.from_dict: unknown pq.stop keys "
                    f"{sorted(stop_unknown)}; known: {sorted(stop_known)}")
            pq["stop"] = StopSpec(**stop)
        kwargs = {}
        for name in ("nprobe", "train_points"):
            if name in d:
                kwargs[name] = d.pop(name)
        if d:
            raise ValueError(
                f"IndexSpec.from_dict: unknown top-level keys {sorted(d)}")
        return cls(coarse=coarse, pq=PQSpec(**pq), **kwargs)

    def stable_hash(self) -> str:
        """Content hash of the algorithmic sections: the coarse execution
        section is excluded, ``nprobe`` is included (it changes what a
        query computes)."""
        import hashlib
        import json as _json
        d = self.to_dict()
        d["coarse"].pop("execution", None)
        blob = _json.dumps(d, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:12]

    def replace(self, **kwargs) -> "IndexSpec":
        """Top-level fields replace directly; PQ fields reach into ``pq``;
        anything else goes to ``coarse.replace``."""
        top = {f.name for f in dataclasses.fields(IndexSpec)}
        pq_fields = {f.name for f in dataclasses.fields(PQSpec)}
        updates: dict[str, Any] = {}
        coarse_kwargs: dict[str, Any] = {}
        for name, value in kwargs.items():
            if name in top:
                updates[name] = value
            elif name in pq_fields:
                pq = updates.get("pq", self.pq)
                updates["pq"] = dataclasses.replace(pq, **{name: value})
            else:
                coarse_kwargs[name] = value
        if coarse_kwargs:
            base = updates.get("coarse", self.coarse)
            updates["coarse"] = base.replace(**coarse_kwargs)
        return dataclasses.replace(self, **updates)
