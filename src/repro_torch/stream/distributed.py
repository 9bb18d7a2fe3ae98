"""The streaming engine over a mesh (each chunk split along the data
axis): the port's counterpart of :mod:`repro.stream.distributed`.

The decomposition is :mod:`repro_torch.core.distributed`'s: each shard
summarises its own share of the chunk on its own device (the local stage,
on its shard's feature scale), the weighted local centers are gathered in
mesh order, and the small coreset fold and warm-started merge run once, on
the state's device.  There is one ``StreamState``; what a shard sends per
update is its ``n_sub * k_local`` centers, whatever the chunk's size.
"""
from __future__ import annotations

import torch

from repro_torch.core.device import derive_seed, make_generator
from repro_torch.core.distributed import (mesh_concat, on_device,
                                          shard_rows, shard_seed)
from repro_torch.core.spec import ClusterSpec

from .engine import (_LOCAL, _MERGE, _NEXT, StreamingClusterer, StreamState,
                     fold_and_merge, summarize_chunk)


def make_sharded_update(clusterer: StreamingClusterer | ClusterSpec, mesh,
                        *, axis: str | None = None):
    """Build ``fn(state, chunk) -> state`` where the (C, d) ``chunk``'s
    rows split into equal contiguous blocks in mesh order along ``axis``
    (C must divide) and the state is the one replicated state.
    ``cfg.n_sub`` counts partitions *per shard*; shard 0 draws its local
    stage from the update's local stream, as ``update`` does (so a
    one-entry mesh gives ``update`` bit for bit), shard ``s > 0`` from its
    :func:`~repro_torch.core.distributed.shard_seed`.  A
    :class:`~repro_torch.core.spec.ClusterSpec` is accepted in place of a
    clusterer (``axis`` then defaults to its ``execution.mesh_axis``, and
    the state lives on the first mesh device)."""
    from repro_torch.launch.mesh import check_mesh
    check_mesh(mesh)
    if isinstance(clusterer, ClusterSpec):
        axis = axis or clusterer.execution.mesh_axis
        clusterer = StreamingClusterer(clusterer,
                                       device=mesh.devices.flat[0])
    devices = mesh.axis_devices(axis or "data")
    cfg, backend = clusterer.cfg, clusterer.backend

    def update(state: StreamState, chunk) -> StreamState:
        chunk = torch.as_tensor(chunk)
        seed = state.key
        seed_local = derive_seed(seed, _LOCAL)
        centers, weights = [], []
        for s, (rows, dev) in enumerate(zip(
                shard_rows(chunk, len(devices), "sharded update"),
                devices)):
            with on_device(dev):
                lc, lw = summarize_chunk(
                    rows.to(dev), cfg,
                    make_generator(shard_seed(seed_local, s), dev), backend)
            centers.append(lc)
            weights.append(lw)
        home = state.centers.device
        new = fold_and_merge(state, mesh_concat(centers, home),
                             mesh_concat(weights, home),
                             int(chunk.shape[0]), cfg,
                             derive_seed(seed, _MERGE), backend)
        return new._replace(key=derive_seed(seed, _NEXT))

    return update
