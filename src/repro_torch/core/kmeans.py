"""Weighted Lloyd's k-means in PyTorch, batched.

The port's counterpart of :mod:`repro.core.kmeans`.  The work-horse the
paper runs (a) inside every subcluster and (b) on the gathered local
centers.  Where the JAX package ``vmap``s one k-means over partitions or
restarts, the port runs one batched k-means: every tensor carries a leading
batch axis B (partitions, or restarts, or both flattened), and one kernel
launch per Lloyd iteration serves the whole batch.

  * points carry *weights* (0 = padded/masked point), so capacity-padded
    partitions cluster correctly;
  * the Lloyd machinery is a :class:`~repro_torch.core.backend.LloydBackend`
    (``torch``, ``cuda``, ``cuda_fused``, ``cuda_tuned`` or ``auto``);
  * empty clusters keep their previous center (standard Lloyd fix-up);
  * ``StopSpec.minibatch > 0`` switches the loop to mini-batch Lloyd
    (weight-proportional row draws per lane, a cumulative-count learning
    rate), the reference's ``_lloyd_minibatch``;
  * the final pass is one more Lloyd-kernel pass at the final centers: its
    ``idx``, ``sse`` and ``counts`` are the result's, so the counts are
    reduced in the kernel's fixed order (no float atomics) and a repeated
    fit is bit-identical.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .backend import BackendSpec, LloydBackend, Prepared, get_backend
from .device import make_generator, resolve_device
from .spec import StopSpec


class KMeansResult(NamedTuple):
    centers: torch.Tensor      # ([B,] k, d) final centroids
    assignment: torch.Tensor   # ([B,] m) int32 cluster id per point
    sse: torch.Tensor          # ([B]) weighted sum of squared distances
    counts: torch.Tensor       # ([B,] k) weighted member count per cluster
    n_iter: torch.Tensor       # ([B]) Lloyd iterations executed


def pairwise_sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """([B,] m, d) x ([B,] k, d) -> ([B,] m, k) squared euclidean
    distances, by the expansion ||x||^2 + ||c||^2 - 2 x.c, clamped at 0."""
    x2 = (x * x).sum(-1, keepdim=True)
    c2 = (c * c).sum(-1)
    xc = x @ c.transpose(-1, -2)
    return (x2 + c2[..., None, :] - 2.0 * xc).clamp_min(0.0)


def _centers_from_stats(sums: torch.Tensor, counts: torch.Tensor,
                        old_centers: torch.Tensor) -> torch.Tensor:
    """Divide raw backend statistics, keeping old centers for empty
    clusters (standard Lloyd fix-up) and the carry dtype stable."""
    new = (sums / counts.clamp_min(1e-12)[..., None]).to(old_centers.dtype)
    return torch.where((counts <= 0.0)[..., None], old_centers, new)


# ---------------------------------------------------------------------------
# Initialisation schemes: (x (B, m, d), weights (B, m), k, generator)
# -> (B, k, d) centers
# ---------------------------------------------------------------------------

def _rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Per-lane row gather: (B, m, d), (B, n) -> (B, n, d)."""
    return torch.gather(x, 1, ids[..., None].expand(-1, -1, x.shape[-1]))


def _categorical(p: torch.Tensor, gen: torch.Generator,
                 n: int = 1) -> torch.Tensor:
    """``n`` draws per lane (with replacement) from unnormalised
    probabilities (B, m); a lane with no mass draws uniformly."""
    p = p.float()
    p = torch.where(p.sum(-1, keepdim=True) > 0, p, torch.ones_like(p))
    return torch.multinomial(p, n, replacement=True, generator=gen)


def _gumbel(shape, gen: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _log_weights(w: torch.Tensor) -> torch.Tensor:
    w = w.float()
    return torch.where(w > 0, torch.log(w.clamp_min(1e-30)), -torch.inf)


def random_init(x: torch.Tensor, weights: torch.Tensor, k: int,
                gen: torch.Generator) -> torch.Tensor:
    """Sample k distinct points per lane with probability proportional to
    weight: Gumbel top-k gives weighted sampling *without replacement*, so
    centers cannot collide.  If fewer than k points have positive weight
    the remainder are with-replacement draws among the valid points."""
    logits = _log_weights(weights)
    scores = logits + _gumbel(logits.shape, gen, x.device)
    top_scores, ids = scores.topk(k, dim=-1)
    fallback = _categorical(weights.clamp_min(0), gen, k)
    ids = torch.where(torch.isfinite(top_scores), ids, fallback)
    return _rows(x, ids)


def _linspace01(k: int, dtype, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, k)`` bit for bit: ``i * f32(1 / (k - 1))`` (XLA
    turns the division by a constant into this product), then 1."""
    if k == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    step = torch.ones((), device=device) / (k - 1)
    head = torch.arange(k - 1, dtype=torch.float32, device=device) * step
    return torch.cat([head, torch.ones(1, device=device)]).to(dtype)


def landmark_init(x: torch.Tensor, weights: torch.Tensor, k: int,
                  gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """The paper's Algorithm-2 landmark construction used as a k-means
    init: k evenly spaced points on the segment [per-attribute min,
    per-attribute max] of each lane's valid points.  Draws nothing."""
    del gen
    big = torch.finfo(x.dtype).max
    valid = (weights > 0)[..., None]
    lo = torch.where(valid, x, big).amin(1)
    hi = torch.where(valid, x, -big).amax(1)
    t = _linspace01(k, x.dtype, x.device)[:, None]
    return lo[:, None, :] + t * (hi - lo)[:, None, :]


def kmeans_pp_init(x: torch.Tensor, weights: torch.Tensor, k: int,
                   gen: torch.Generator) -> torch.Tensor:
    """k-means++ (D^2 weighting), incremental min-distance bookkeeping;
    k sequential draws, each batched over the lanes."""
    b, _, d = x.shape
    lanes = torch.arange(b, device=x.device)
    valid = (weights > 0).to(torch.float32)
    first = _categorical(valid, gen)[:, 0]
    centers = torch.zeros((b, k, d), dtype=x.dtype, device=x.device)
    c = x[lanes, first]
    centers[:, 0] = c
    min_d = ((x - c[:, None, :]) ** 2).sum(-1)
    for i in range(1, k):
        p = min_d * weights
        # all-zero guard (every point on a chosen center): uniform over valid
        p = torch.where((p > 0).any(-1, keepdim=True), p, valid.to(p.dtype))
        c = x[lanes, _categorical(p, gen)[:, 0]]
        centers[:, i] = c
        min_d = torch.minimum(min_d, ((x - c[:, None, :]) ** 2).sum(-1))
    return centers


def kmeans_parallel_init(x: torch.Tensor, weights: torch.Tensor, k: int,
                         gen: torch.Generator, *, rounds: int = 3,
                         oversample: int | None = None) -> torch.Tensor:
    """k-means|| (Bahmani et al., Scalable K-Means++): ``rounds`` rounds
    each draw ``oversample`` (default 2k) candidates jointly with
    probability proportional to ``weight * min_dist^2`` (Gumbel top-k,
    without replacement); the candidates are weighted by the point mass
    they attract and reduced to k centers by weighted k-means++."""
    b, m, d = x.shape
    l = min(oversample or 2 * k, m)
    valid = (weights > 0).to(torch.float32)
    first = _categorical(valid, gen)[:, 0]
    lanes = torch.arange(b, device=x.device)
    min_d = ((x - x[lanes, first][:, None, :]) ** 2).sum(-1)
    cand = [x[lanes, first][:, None, :]]
    cand_valid = [torch.ones((b, 1), dtype=torch.bool, device=x.device)]
    for _ in range(rounds):
        logits = _log_weights(min_d * weights)
        scores = logits + _gumbel(logits.shape, gen, x.device)
        top_scores, ids = scores.topk(l, dim=-1)
        ok = torch.isfinite(top_scores)              # fewer than l useful?
        picked = _rows(x, ids)
        cand.append(torch.where(ok[..., None], picked, 0.0))
        cand_valid.append(ok)
        d_new = pairwise_sqdist(x, picked)
        d_new = torch.where(ok[:, None, :], d_new, torch.inf)
        min_d = torch.minimum(min_d, d_new.amin(-1))
    cand = torch.cat(cand, 1)
    cand_valid = torch.cat(cand_valid, 1)
    n_cand = cand.shape[1]
    d2 = pairwise_sqdist(x, cand)
    d2 = torch.where(cand_valid[:, None, :], d2, torch.inf)
    nearest = d2.argmin(-1)
    flat = (nearest + n_cand * lanes[:, None]).reshape(-1)
    cand_w = torch.zeros(b * n_cand, device=x.device).index_add_(
        0, flat, weights.float().reshape(-1)).view(b, n_cand)
    cand_w = torch.where(cand_valid, cand_w.clamp_min(1e-12), 0.0)
    return kmeans_pp_init(cand, cand_w.to(x.dtype), k, gen)


InitFn = Callable[[torch.Tensor, torch.Tensor, int, torch.Generator],
                  torch.Tensor]

_INITS: dict[str, InitFn] = {
    "random": random_init,
    "landmark": landmark_init,
    "kmeans++": kmeans_pp_init,
    "kmeans||": kmeans_parallel_init,
}


def register_init(name: str, fn: InitFn) -> None:
    """Register ``fn(x (B, m, d), weights (B, m), k, generator) ->
    (B, k, d) centers`` as an init scheme."""
    _INITS[name] = fn


def get_init(name: str) -> InitFn:
    try:
        return _INITS[name]
    except KeyError:
        raise ValueError(
            f"unknown init scheme {name!r}; known: {sorted(_INITS)}"
        ) from None


def available_inits() -> tuple[str, ...]:
    return tuple(sorted(_INITS))


def _jittered_array_init(init: torch.Tensor, x: torch.Tensor,
                         gen: torch.Generator, r: torch.Tensor
                         ) -> torch.Tensor:
    """Restart r of an explicit array init, one (k, d) set per lane
    (``init`` is (B, k, d)): r=0 keeps the given centers verbatim; r>0
    perturbs them with noise scaled to the per-dimension (population)
    spread of the lane's *data*."""
    sigma = (0.05 * x.std(dim=1, correction=0, keepdim=True).to(init.dtype)
             + 1e-6)                                         # (B, 1, d)
    noise = torch.randn(tuple(init.shape), generator=gen, device=x.device,
                        dtype=init.dtype)
    keep = (r == 0)[:, None, None]
    return torch.where(keep, init, init + sigma * noise)


def update_centers(x: torch.Tensor, weights: torch.Tensor, idx: torch.Tensor,
                   k: int, old_centers: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted centroid update of a batch: (B, m, d) points, (B, m)
    weights, (B, m) cluster ids in [0, k), (B, k, d) previous centers ->
    (the weighted means (B, k, d), keeping the previous center of an empty
    cluster; the weighted counts (B, k)).  The sums are the centroid
    kernel's (``kernels/centroid.py``) for CUDA tensors, reduced in a fixed
    order, so a repeated update is bit-identical."""
    from repro_torch.kernels.centroid import centroid_update
    sums, counts = centroid_update(x, idx.to(torch.int32), weights, k)
    new = (sums / counts.clamp_min(1e-12)[..., None]).to(old_centers.dtype)
    return torch.where((counts <= 0.0)[..., None], old_centers, new), counts


# ---------------------------------------------------------------------------
# Lloyd's algorithm
# ---------------------------------------------------------------------------

def _stop_update(stop: StopSpec, *, sse: torch.Tensor,
                 prev_sse: torch.Tensor, new_centers: torch.Tensor,
                 old_centers: torch.Tensor, i: torch.Tensor,
                 streak: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-lane convergence bookkeeping for one Lloyd iteration under a
    ``tol>0`` policy: the updated consecutive-hit ``streak`` and ``done``.
    ``sse`` is the step's SSE at ``old_centers``; ``prev_sse`` the same one
    iteration ago (+inf at first, which therefore never converges)."""
    if stop.metric == "rel_sse":
        impr = (prev_sse - sse) / prev_sse.clamp_min(1e-30)
        hit = torch.isfinite(prev_sse) & (impr <= stop.tol)
    else:                                            # "center_shift"
        shift2 = ((new_centers.float() - old_centers.float()) ** 2
                  ).sum(-1).amax(-1)
        hit = shift2.sqrt() <= stop.tol
    streak = torch.where(hit, streak + 1, torch.zeros_like(streak))
    done = (streak >= stop.patience) & (i + 1 >= stop.min_iters)
    return streak, done


LloydFn = Callable[[torch.Tensor, torch.Tensor],
                   tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _full_batch_step(be: LloydBackend, prep: Prepared) -> LloydFn:
    """One full-batch Lloyd iteration as ``(centers, carry) -> (new centers,
    carry, SSE at the old centers)``; the carry is unused."""
    def step(centers, carry):
        st = be.step(prep, centers)
        return _centers_from_stats(st.sums, st.counts, centers), carry, st.sse
    return step


def _lloyd_converged(step: LloydFn, centers0: torch.Tensor,
                     carry0: torch.Tensor, stop: StopSpec
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd under a ``tol>0`` policy, masked per lane: a lane whose own
    loop condition (``i < max_iters`` and not done) fails keeps its carry
    (``torch.where``) while the others step, and the batch exits once
    every lane is done.  ``step`` is one iteration (full batch, or a
    mini-batch whose per-lane carry is the cumulative counts).  Returns
    ``(centers, n_iter)`` with the true per-lane count.  One host sync per
    iteration decides the exit."""
    b = centers0.shape[0]
    dev = centers0.device
    i = torch.zeros(b, dtype=torch.int32, device=dev)
    prev_sse = torch.full((b,), torch.inf, device=dev)
    streak = torch.zeros(b, dtype=torch.int32, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    centers, carry = centers0, carry0
    while True:
        active = (i < stop.max_iters) & ~done
        if not bool(active.any()):
            return centers, i
        new, carry_n, sse = step(centers, carry)
        sse = sse.float()
        streak_n, done_n = _stop_update(
            stop, sse=sse, prev_sse=prev_sse, new_centers=new,
            old_centers=centers, i=i, streak=streak)
        centers = torch.where(active[:, None, None], new, centers)
        carry = torch.where(active[:, None], carry_n, carry)
        prev_sse = torch.where(active, sse, prev_sse)
        streak = torch.where(active, streak_n, streak)
        done = torch.where(active, done_n, done)
        i = i + active.to(torch.int32)


# ---------------------------------------------------------------------------
# Mini-batch Lloyd (StopSpec.minibatch > 0)
# ---------------------------------------------------------------------------

def minibatch_ids(cdf: torch.Tensor, n: int,
                  gen: torch.Generator) -> torch.Tensor:
    """``n`` row ids per lane, drawn with replacement with probability
    proportional to weight, from ``cdf`` (B, m), the running sums of each
    lane's weights (:func:`_weight_cdf`).  A row of weight 0 is never
    drawn: the first running sum above a uniform draw in [0, total) belongs
    to a row of positive weight.  A lane without mass draws row 0."""
    total = cdf[:, -1:].contiguous()
    u = torch.rand((cdf.shape[0], n), generator=gen, device=cdf.device,
                   dtype=cdf.dtype) * total
    last = torch.searchsorted(cdf, total)       # the last row with weight
    return torch.minimum(torch.searchsorted(cdf, u, right=True), last)


def _weight_cdf(weights: torch.Tensor) -> torch.Tensor:
    """Running sums (f64) of each lane's weights, negatives counted as 0."""
    return weights.double().clamp_min(0.0).cumsum(-1)


def minibatch_update(be: LloydBackend, x: torch.Tensor,
                     sample_w: torch.Tensor, centers: torch.Tensor,
                     cum_counts: torch.Tensor, ids: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One mini-batch step (Sculley) on the rows ``ids`` (B, n) of ``x``
    (B, m, d), each of sample weight ``sample_w`` (B, n): one backend step
    on the block, then every center moves toward its batch mean with the
    learning rate ``counts / cum_counts`` in f32, cast back to the centers'
    dtype.  A center the batch did not reach keeps its place.  Returns
    ``(centers, cum_counts, the block's SSE at the old centers)``."""
    st = be.step(be.prepare(_rows(x, ids), sample_w), centers)
    cum_counts = cum_counts + st.counts
    mean = st.sums / st.counts.clamp_min(1e-12)[..., None]
    lr = (st.counts / cum_counts.clamp_min(1e-12))[..., None]
    stepped = ((1.0 - lr) * centers.float() + lr * mean).to(centers.dtype)
    new = torch.where((st.counts <= 0.0)[..., None], centers, stepped)
    return new, cum_counts, st.sse


def _minibatch_step(be: LloydBackend, x: torch.Tensor,
                    weights: torch.Tensor, n: int,
                    gen: torch.Generator) -> LloydFn:
    """A mini-batch iteration as a :data:`LloydFn` whose carry is the
    per-lane cumulative counts: each lane draws its own ``min(n, m)`` rows
    (:func:`minibatch_ids`) at unit sample weight (mass enters through the
    draw).  A lane without mass gets sample weight 0, so no step moves its
    centers."""
    n = min(int(n), x.shape[1])
    cdf = _weight_cdf(weights)
    sample_w = (cdf[:, -1:] > 0).to(x.dtype).expand(-1, n).contiguous()

    def step(centers, cum_counts):
        return minibatch_update(be, x, sample_w, centers, cum_counts,
                                minibatch_ids(cdf, n, gen))
    return step


def kmeans_batched(x: torch.Tensor, k: int, *, weights: torch.Tensor,
                   generator: torch.Generator,
                   init: "str | torch.Tensor" = "kmeans++",
                   backend: BackendSpec = None, restarts: int = 1,
                   stop: StopSpec) -> KMeansResult:
    """k-means on a batch of B independent point sets — the local stage's
    partitions, or one pool — each with ``restarts`` runs; the lowest-SSE
    run of each set wins.  ``x`` (B, m, d) and ``weights`` (B, m) live on
    the device the work runs on.  Returns a :class:`KMeansResult` with the
    leading batch axis.  ``init`` is a registered name, one (k, d) array
    shared by the B sets, or a (B, k, d) array with one per set (restart 0
    keeps it verbatim, later restarts jitter it).  ``stop.minibatch > 0``
    runs mini-batch Lloyd, each lane drawing its own rows every iteration
    (:func:`_minibatch_step`); the final pass still runs over all points."""
    b, m, d = x.shape
    be = get_backend(backend, device=x.device)
    r = max(1, int(restarts))
    weights = weights.to(x.dtype)
    if r > 1:       # restarts become batch lanes; one point set is shared
        if b == 1:
            xr, wr = x.expand(r, m, d), weights.expand(r, m)
        else:
            xr = x.repeat_interleave(r, 0)
            wr = weights.repeat_interleave(r, 0)
    else:
        xr, wr = x, weights
    if isinstance(init, str):
        centers = get_init(init)(xr, wr, k, generator)
    else:
        centers = torch.as_tensor(init, dtype=x.dtype, device=x.device)
        if centers.dim() == 2:          # one (k, d) set shared by the lanes
            centers = centers.expand(b, k, d)
        if tuple(centers.shape) != (b, k, d):
            raise ValueError(f"kmeans: an array init must be (k, d) or "
                             f"(B, k, d) = {(b, k, d)}, got "
                             f"{tuple(centers.shape)}")
        if r > 1:
            lane_r = torch.arange(b * r, device=x.device) % r
            centers = _jittered_array_init(
                centers.repeat_interleave(r, 0), xr, generator, lane_r)
    prep = be.prepare(xr, wr)

    if stop.minibatch > 0:
        step = _minibatch_step(be, xr, wr, stop.minibatch, generator)
    else:
        step = _full_batch_step(be, prep)
    carry = torch.zeros((b * r, k), device=x.device)
    if stop.tol > 0:
        centers, n_iter = _lloyd_converged(step, centers, carry, stop)
    else:           # fixed trip count: no data-dependent exit, no host sync
        for _ in range(stop.max_iters):
            centers, carry, _ = step(centers, carry)
        n_iter = torch.full((b * r,), stop.max_iters, dtype=torch.int32,
                            device=x.device)
    final = be.step(prep, centers)
    idx, sse, counts = final.idx, final.sse, final.counts

    if r > 1:       # keep the lowest-SSE restart of each point set
        best = sse.view(b, r).argmin(1)
        pick = torch.arange(b, device=x.device) * r + best
        centers, idx, sse = centers[pick], idx[pick], sse[pick]
        counts, n_iter = counts[pick], n_iter[pick]
    return KMeansResult(centers, idx, sse, counts.to(weights.dtype), n_iter)


def kmeans(
    x,
    k: int,
    *,
    weights=None,
    iters: Optional[int] = None,
    seed: "int | torch.Generator" = 0,
    init: "str | torch.Tensor" = "kmeans++",
    backend: BackendSpec = None,
    restarts: int = 1,
    stop: Optional[StopSpec] = None,
    device: "torch.device | str | None" = None,
) -> KMeansResult:
    """Weighted Lloyd's k-means of one (m, d) point set under a
    :class:`~repro_torch.core.spec.StopSpec` iteration contract, on
    ``device`` (``None``: the CUDA device; a missing one raises).

    ``stop`` is the canonical way to bound the loop; ``iters`` survives as
    an alias for ``StopSpec(max_iters=iters)`` (passing both raises).
    ``tol=0`` runs exactly ``max_iters`` iterations; ``tol > 0`` exits
    once the convergence metric stays at or below ``tol`` for ``patience``
    iterations.  ``seed`` (an int or a ``torch.Generator``) takes the
    place of the JAX package's ``key``.  With ``restarts > 1`` the
    lowest-SSE of several runs wins; an explicit array ``init`` takes part
    (restart 0 uses it verbatim, later restarts jitter it)."""
    if stop is None:
        stop = StopSpec(max_iters=25 if iters is None else iters)
    elif iters is not None:
        raise TypeError("kmeans: pass either stop= or the iters= alias, "
                        "not both")
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    w = (torch.ones(x.shape[0], dtype=x.dtype, device=dev) if weights is None
         else torch.as_tensor(weights, device=dev))
    res = kmeans_batched(x[None], k, weights=w[None],
                         generator=make_generator(seed, dev), init=init,
                         backend=backend, restarts=restarts, stop=stop)
    return KMeansResult(*(t[0] for t in res))


def kmeans_lloyd_step(
    x, centers, weights, backend: BackendSpec = None, *,
    device: "torch.device | str | None" = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One exposed Lloyd iteration: ``(new_centers, counts)`` of the
    ([B,] m, d) points ``x`` with ([B,] m) ``weights`` against the
    ([B,] k, d) ``centers``, through ``backend.prepare`` and
    ``backend.step`` on ``device`` (``None``: the CUDA device).  The
    backend resolves as everywhere (``get_backend``): on the card
    ``cuda_tuned``, the fused Lloyd kernel (``cuda_fused`` at the derived
    plan), on the CPU the plain version; empty clusters keep their
    centers."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    c = torch.as_tensor(centers, device=dev)
    w = torch.as_tensor(weights, device=dev)
    lane = x.dim() == 2
    if lane:
        x, c, w = x[None], c[None], w[None]
    be = get_backend(backend, device=dev)
    st = be.step(be.prepare(x, w), c)
    new = _centers_from_stats(st.sums, st.counts, c)
    return (new[0], st.counts[0]) if lane else (new, st.counts)
