"""The paper's own workloads as declarative specs: the synthetic 500k-point /
1000-cluster clustering job (500 points per cluster, 2-D), compression sweep
c in {5, 10, 15, 20}, 64 subclusters — the same table as the JAX package's
``repro.configs.paper_clustering``.

``workload_spec(name)`` returns the :class:`~repro_torch.core.spec.ClusterSpec`
for a named workload (plus data sizing via ``PAPER_WORKLOADS``), so every
benchmark / example constructs the same spec instead of re-spelling kwargs.
"""
from repro_torch.core.spec import (ClusterSpec, ExecutionSpec, LocalSpec,
                                   MergeSpec, PartitionSpec, StopSpec)

PAPER_WORKLOADS = {
    "iris": dict(n=150, dim=4, k=3, n_sub=6, compression=6),
    "seeds": dict(n=210, dim=7, k=3, n_sub=6, compression=6),
    "synthetic_100k": dict(n=100_000, dim=2, k=200, n_sub=64, compression=5),
    "synthetic_250k": dict(n=250_000, dim=2, k=500, n_sub=64, compression=5),
    "synthetic_500k": dict(n=500_000, dim=2, k=1000, n_sub=64, compression=5),
}
COMPRESSION_SWEEP = (5, 10, 15, 20)


def workload_spec(name: str, *, scheme: str = "equal",
                  compression: int | None = None,
                  local_iters: int = 10, global_iters: int = 25,
                  tol: float = 0.0, minibatch: int = 0,
                  backend=None, mode: str = "auto") -> ClusterSpec:
    """ClusterSpec for a named paper workload (see ``PAPER_WORKLOADS``).

    ``tol > 0`` attaches a convergence-driven :class:`StopSpec` to both
    stages (``local_iters``/``global_iters`` become ceilings rather than
    exact trip counts); ``minibatch > 0`` makes the merge stage a
    mini-batch update over that many sampled pool rows per iteration.
    The defaults (``tol=0, minibatch=0``) reproduce the fixed-budget
    paper runs bit-for-bit.
    """
    try:
        w = PAPER_WORKLOADS[name]
    except KeyError:
        raise ValueError(f"unknown paper workload {name!r}; known: "
                         f"{sorted(PAPER_WORKLOADS)}") from None
    local_stop = StopSpec(max_iters=local_iters, tol=tol) if tol > 0 else None
    merge_stop = (StopSpec(max_iters=global_iters, tol=tol,
                           minibatch=minibatch)
                  if tol > 0 or minibatch > 0 else None)
    return ClusterSpec(
        partition=PartitionSpec(scheme=scheme, n_sub=w["n_sub"]),
        local=LocalSpec(compression=compression or w["compression"],
                        iters=local_iters, stop=local_stop),
        merge=MergeSpec(k=w["k"], iters=global_iters, stop=merge_stop),
        execution=ExecutionSpec(backend=backend if backend is not None
                                else "auto", mode=mode),
    )
