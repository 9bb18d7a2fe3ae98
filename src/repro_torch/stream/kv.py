"""Incremental clustered-KV cache refresh — the streaming merge applied to
decode attention (the counterpart of :mod:`repro.stream.kv`).

The clustered decode cache (:mod:`repro_torch.models.attention`) holds
``n_centroids`` weighted key/value centroids beside an exact recent window.
A refresh folds the window into the centroids: one warm-started weighted
k-means over

    [old centroids (weight = member counts)  ‖  window keys (weight = 1)]

with ``init`` = the old centroids — the paper's merge stage run online.
Value centroids follow as assignment-weighted means, counts accumulate,
and the window is marked empty.  Every (layer, batch, kv head) lane of a
stacked cache is one lane of ONE batched k-means, so each Lloyd iteration
of a refresh is one launch of the Lloyd kernel (``kernels/csrc/lloyd.cu``)
for the whole cache.
"""
from __future__ import annotations

import warnings

import torch

from repro_torch.core.backend import BackendSpec, get_backend
from repro_torch.core.device import derive_seed, make_generator, seed_of
from repro_torch.core.kmeans import kmeans_batched, update_centers
from repro_torch.core.pipeline import reduce_pool
from repro_torch.core.spec import ClusterSpec, StopSpec
from repro_torch.models.attention import window_valid_mask


def refresh_clustered_cache(kc: torch.Tensor, vc: torch.Tensor,
                            counts: torch.Tensor, wk: torch.Tensor,
                            wv: torch.Tensor, w_valid: torch.Tensor, *,
                            iters: "int | None" = None,
                            stop: "StopSpec | None" = None,
                            seed: "int | torch.Generator" = 0,
                            backend: BackendSpec = None,
                            spec: "ClusterSpec | None" = None,
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Fold window keys/values into the centroid set.

    kc, vc:  (..., n, dh) key / value centroids
    counts:  (..., n) member counts (0 = empty centroid slot)
    wk, wv:  (..., W, dh) window ring contents
    w_valid: (..., W) 1.0 for live window slots, 0.0 otherwise

    Returns updated (kc, vc, counts); total mass is conserved
    (sum(counts') = sum(counts) + sum(w_valid)).  Empty centroid slots have
    zero weight, so they act as free capacity.

    The Lloyd budget comes from ``stop`` (a :class:`StopSpec`), or the
    ``iters=`` alias, or ``spec.merge.effective_stop`` when a spec is
    given; unspecified, it defaults to ``StopSpec(max_iters=4)``.  With
    ``spec.levels`` each lane's pool is first reduced through the
    hierarchical reduce tree (``reduce_pool``, lane by lane, each level
    from its own stream of ``seed``).  ``seed`` takes the place of the JAX
    package's ``key``: the warm start draws nothing."""
    if iters is not None and stop is not None:
        raise TypeError("refresh_clustered_cache: pass either stop= or the "
                        "iters= alias, not both")
    levels = ()
    if spec is not None:
        stop = spec.merge.effective_stop
        iters = None
        backend = backend if backend is not None else spec.execution.backend
        levels = spec.levels
        if any(lvl.scheme == "unequal" for lvl in levels):
            warnings.warn(
                "refresh_clustered_cache: unequal-scheme reduce levels can "
                "clamp overflow pool entries out of the merge input — "
                "prefer equal-scheme levels (or raise capacity_factor)",
                stacklevel=2)
    if stop is None:
        stop = StopSpec(max_iters=4 if iters is None else iters)
    dev = kc.device
    be = get_backend(backend, device=dev)
    n, dh = kc.shape[-2:]
    w_len = wk.shape[-2]
    batch = kc.shape[:-2]

    kc_f = kc.reshape(-1, n, dh).float()
    vc_f = vc.reshape(-1, n, dh).float()
    cnt_f = counts.reshape(-1, n).float()
    val_f = w_valid.float().expand(batch + (w_len,)).reshape(-1, w_len)
    pts = torch.cat([kc_f, wk.reshape(-1, w_len, dh).float()], 1)
    vals = torch.cat([vc_f, wv.reshape(-1, w_len, dh).float()], 1)
    w = torch.cat([cnt_f, val_f], 1)

    base = seed_of(seed)
    if levels:
        pools, pool_ws = [], []
        for lane in range(pts.shape[0]):
            pool, pool_w = pts[lane], w[lane]
            for i, lvl in enumerate(levels):
                gen = make_generator(derive_seed(base, lane, 1 + i), dev)
                pool, pool_w, _ = reduce_pool(pool, pool_w, lvl, gen, be)
            pools.append(pool)
            pool_ws.append(pool_w)
        pool, pool_w = torch.stack(pools), torch.stack(pool_ws)
    else:
        pool, pool_w = pts, w
    res = kmeans_batched(pool, n, weights=pool_w,
                         generator=make_generator(derive_seed(base, 0), dev),
                         init=kc_f, backend=be, stop=stop)
    if levels:
        # the merge ran on the reduced pools; re-assign the ORIGINAL
        # points so values/counts aggregate the true mass
        idx, _ = be.assign(be.prepare(pts, w), res.centers)
    else:
        idx = res.assignment
    new_vc, new_cnt = update_centers(vals, w, idx, n, vc_f)
    return (res.centers.reshape(kc.shape).to(kc.dtype),
            new_vc.reshape(vc.shape).to(vc.dtype),
            new_cnt.reshape(counts.shape).to(counts.dtype))


def refresh_layer_cache(cache: dict, pos: int, *,
                        iters: "int | None" = None,
                        stop: "StopSpec | None" = None,
                        seed: "int | torch.Generator" = 0,
                        backend: BackendSpec = None,
                        spec: "ClusterSpec | None" = None) -> dict:
    """Refresh a stacked clustered cache dict as built by
    ``init_clustered_cache``: kc/vc (L, B, kv, n, dh), counts (L, B, kv, n),
    wk/wv (L, B, kv, W, dh), slot_pos (L, W).  ``pos`` is the *position of
    the most recently decoded token* (i.e. count - 1), matching the ``pos``
    the decode step wrote into the ring.  Returns a new cache dict with the
    window absorbed and ``slot_pos`` reset (the window tensors are shared
    with ``cache``)."""
    from repro_torch.models.attention import window_valid_mask

    window = cache["wk"].shape[3]
    valid = window_valid_mask(cache["slot_pos"], pos, window)     # (L, W)
    v4 = valid[:, None, None, :].float().expand(
        cache["counts"].shape[:3] + (window,))
    kc, vc, counts = refresh_clustered_cache(
        cache["kc"], cache["vc"], cache["counts"], cache["wk"], cache["wv"],
        v4, iters=iters, stop=stop, seed=seed, backend=backend, spec=spec)
    return dict(cache, kc=kc, vc=vc, counts=counts,
                slot_pos=torch.full_like(cache["slot_pos"], -1))
