"""Shape- and card-keyed launch-parameter autotuner for the port's kernels.

The port's counterpart of ``repro/kernels/autotune.py``.  The SIMT routes
of the Lloyd and assignment kernels, the centroid update's warp path and
the ADC scan take launch parameters that ``tiles.py`` derives by formula
from the shape and the card (:class:`TileConfig`; 0 on an axis means that
formula):

  ========  ==============================  ==============================
  kernel    tuned axes                      values they move
  ========  ==============================  ==============================
  lloyd     ``center_tile``, ``blocks``     ``blocks``: the last bits of
                                            ``sums`` and ``sse``
  assign    ``center_tile``, ``points``,    none
            ``blocks``
  centroid  ``blocks``                      the last bits of ``sums``
  scan      ``blocks``                      none
  ========  ==============================  ==============================

The tensor-core routes (their tiles are compiled in), the route choice
(which changes the algorithm, so labels move at near-ties) and the cluster
attention are not tuned.  No path looks the centroid update up
(``cuda_tuned``'s step is fused; ``cuda`` runs the derived plan), so it is
swept only on request and has no table row.

  * :func:`lookup` resolves a config for a shape without ever sweeping (a
    host-side dict read, a few microseconds).  Four layers, first hit
    wins:

      1. the in-process LRU (this process's sweeps and earlier lookups),
      2. a persistent JSON file named by ``REPRO_TORCH_TUNE_CACHE`` (a
         corrupt or missing file falls through silently),
      3. the committed table (:mod:`.tune_table`), per card and shape
         bucket,
      4. the default, the derived plan (:data:`DEFAULT`, all 0).

  * :func:`tune` sweeps one ``(kernel, shape, dtype)`` on a card: the
    candidates are deduped through the clamps of ``tiles.py``
    (:func:`effective_config`), each is checked against the plain version
    (``kernels/ref.py``, labels allowed to move only at near-ties) and
    against the derived plan's output bit for bit on the axes that move no
    value, the survivors are timed (CUDA events behind a spin kernel, on
    input copies larger than the L2, median of ``iters``), and the winner
    is cached.  The derived plan always joins the sweep first, so it wins
    ties and the winner is never slower than it on the card that swept.

Keys are ``kernel|bucket|dtype|device_kind|backend``: B, M, K and L round
up to powers of two, d to ``tiles.register_dim(d)`` (the compiled register
width; 0 past 128); ``device_kind`` is the CUDA device's name and
``backend`` is ``"cuda"`` (``"cpu"`` for both on the CPU).  The reference's
cache entries are TPU VMEM tiles and mean nothing here, so the port reads
its own file.

    python -m repro_torch.kernels.autotune --sweep [--smoke] [--kernel K]
        [--iters N] [--out rows.json]     # on a card: sweep SWEEP_SHAPES
    python -m repro_torch.kernels.autotune --check-defaults   # anywhere
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import itertools
import json
import os
import pathlib
import re
import sys
import tempfile
import time
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from . import tiles

ENV_VAR = "REPRO_TORCH_TUNE_CACHE"
CACHE_SCHEMA = 1
KERNELS = ("lloyd", "assign", "centroid", "scan")
# the launch parameters each kernel takes, and those that regroup a float
# sum (a change of them may move the last bits of the outputs below)
AXES = {"lloyd": ("center_tile", "blocks"),
        "assign": ("center_tile", "points", "blocks"),
        "centroid": ("blocks",), "scan": ("blocks",)}
BIT_AXES = {"lloyd": ("blocks",), "centroid": ("blocks",)}
# outputs a BIT_AXES change may move: lloyd's sums and sse, centroid's sums
FLOAT_SUMS = {"lloyd": (0, 2), "centroid": (0,)}

L2_BYTES = 50 * 2 ** 20      # the H100's L2 cache
SPIN_CYCLES = 200_000_000    # ~0.1 s at the H100's clock: time to queue calls
_MEM_MAX = 256               # in-process LRU bound


class TileConfig(NamedTuple):
    """One launch point.  0 on an axis means the formula of ``tiles.py``;
    axes a kernel does not take stay 0, so configs compare and serialise
    uniformly."""
    center_tile: int = 0
    blocks: int = 0
    points: int = 0

    def to_dict(self) -> dict:
        return {f: int(v) for f, v in zip(self._fields, self) if v}

    @classmethod
    def from_dict(cls, d: dict) -> "TileConfig":
        if not isinstance(d, dict):
            raise ValueError(f"TileConfig entry must be a dict, got {d!r}")
        unknown = set(d) - set(cls._fields)
        if unknown:
            raise ValueError(f"TileConfig entry has unknown fields {unknown}")
        vals = {}
        for f in cls._fields:
            v = d.get(f, 0)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise ValueError(f"TileConfig.{f} must be a non-negative "
                                 f"int, got {v!r}")
            vals[f] = v
        return cls(**vals)


DEFAULT = TileConfig()    # the derived plan: every axis by its formula

_POW2 = tuple(2 ** i for i in range(11))          # 1 .. 1024
CANDIDATES: dict = {
    "lloyd": tuple(TileConfig(center_tile=t, blocks=g)
                   for t in (0, 128, 512) for g in (0, *_POW2)),
    "assign": tuple(TileConfig(center_tile=t, points=p, blocks=g)
                    for t in (0, 256) for p in (0, 1, 4)
                    for g in (0, 2, 8, 32, 128, 512)),
    "centroid": tuple(TileConfig(blocks=g) for g in (0, *_POW2)),
    "scan": tuple(TileConfig(blocks=g) for g in (0, *_POW2)),
}


class Shape(NamedTuple):
    """One sweep point: a path's launch, ``shared`` where one point set is
    broadcast over the batch (the merge's restarts)."""
    name: str
    dims: dict
    shared: bool = False


def _pts(name, b, m, k, d, shared=False):
    return Shape(name, dict(b=b, m=m, k=k, d=d), shared)


# the shapes at which the ported paths look a config up (PERF.md section 6,
# kernel table rows 1-4): the fused Lloyd steps and the assignments of
# cuda_tuned, and the ADC scan.  The assignment's index routing takes the
# tensor-core route, where every candidate is the derived plan.  No path
# looks up the centroid kernel (cuda_tuned's step is fused; the unfused
# cuda backend runs the derived plan), so the campaign does not sweep it;
# tune("centroid", ...) still sweeps one shape on request.
SWEEP_SHAPES: dict = {
    "lloyd": (
        _pts("local", 64, 7813, 1562, 2),
        _pts("merge", 4, 99_968, 1000, 2, True),
        _pts("pq_200k", 64, 32_768, 256, 1),
        _pts("pq_5m", 32, 65_536, 256, 1),
        _pts("oocore_fold", 16, 16_384, 256, 8),
        _pts("oocore_merge", 4, 78_112, 64, 8, True),
        _pts("minibatch_step", 4, 16_384, 1000, 2),
        _pts("stream_merge", 1, 1024, 64, 8),
        _pts("shard_map_local", 16, 7813, 1562, 2),
        _pts("distributed_merge_round", 1, 24_992, 1000, 2),
        _pts("chunked_dist_fold", 8, 131_072, 256, 8),
        _pts("chunked_dist_fold_last", 8, 89_616, 175, 8),
        _pts("chunked_dist_level", 8, 1536, 192, 8),
        _pts("chunked_dist_merge_round", 1, 1536, 256, 8),
        _pts("stream_sharded_summary", 4, 16_384, 256, 8),
        _pts("index_200k_coarse_merge", 4, 6554, 256, 64, True)),
    "assign": (
        _pts("predict", 1, 500_000, 1000, 2),
        _pts("oocore_predict", 1, 262_144, 64, 8),
        _pts("index_200k_routing", 1, 65_536, 256, 64)),
    "scan": (
        Shape("index_200k", dict(b=128, l=1586, msub=64, c=256)),
        Shape("index_5m", dict(b=128, l=19_792, msub=32, c=256))),
}


# ---------------------------------------------------------------------------
# Keys: shape buckets and the cache key
# ---------------------------------------------------------------------------

def bucket_pow2(n: int) -> int:
    """Round up to the next power of two (>= 1)."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


_DIMS = {"lloyd": ("b", "m", "d", "k"), "assign": ("b", "m", "d", "k"),
         "centroid": ("b", "m", "d", "k"), "scan": ("b", "l", "msub", "c")}
BUCKET_RE = {"lloyd": re.compile(r"B\d+_M\d+_d\d+_K\d+$"),
             "scan": re.compile(r"B\d+_L\d+_m\d+_C\d+$")}
BUCKET_RE["assign"] = BUCKET_RE["centroid"] = BUCKET_RE["lloyd"]


def _check_dims(kernel: str, dims: dict) -> dict:
    if kernel not in KERNELS:
        raise ValueError(f"unknown tunable kernel {kernel!r}; "
                         f"known: {KERNELS}")
    want = _DIMS[kernel]
    missing = [d for d in want if d not in dims]
    extra = sorted(set(dims) - set(want))
    if missing or extra:
        raise ValueError(f"{kernel}: needs dims {want}, missing {missing}, "
                         f"unexpected {extra}")
    out = {d: int(dims[d]) for d in want}
    bad = [d for d, v in out.items() if v < 1]
    if bad:
        raise ValueError(f"{kernel}: dims must be >= 1, got "
                         f"{ {d: out[d] for d in bad} }")
    return out


def shape_bucket(kernel: str, **dims) -> str:
    """Bucketed shape string: B, M, K and L round up to powers of two, d to
    its register width (``tiles.register_dim``), the PQ geometry (m, C)
    exactly."""
    dims = _check_dims(kernel, dims)
    b = bucket_pow2(dims["b"])
    if kernel == "scan":
        return (f"B{b}_L{bucket_pow2(dims['l'])}_m{dims['msub']}"
                f"_C{dims['c']}")
    return (f"B{b}_M{bucket_pow2(dims['m'])}_d{tiles.register_dim(dims['d'])}"
            f"_K{bucket_pow2(dims['k'])}")


_KINDS: dict = {}


def device_info(device=None) -> tuple[str, str]:
    """``(device_kind, backend)`` of ``device`` (``None``: the current CUDA
    device) — the hardware half of the cache key.  A CUDA device's name is
    read once per device index, so a lookup makes no CUDA call."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        return dev.type, dev.type
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    kind = _KINDS.get(i)
    if kind is None:
        kind = _KINDS[i] = torch.cuda.get_device_name(i)
    return kind, "cuda"


def _dtype_name(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def cache_key(kernel: str, *, dtype=torch.float32, device=None,
              device_kind: Optional[str] = None,
              backend: Optional[str] = None, **dims) -> str:
    """``kernel|bucket|dtype|device_kind|backend`` — the one key every
    cache layer shares."""
    bucket = shape_bucket(kernel, **dims)
    if device_kind is None or backend is None:
        dk, bk = device_info(device)
        device_kind = dk if device_kind is None else device_kind
        backend = bk if backend is None else backend
    return f"{kernel}|{bucket}|{_dtype_name(dtype)}|{device_kind}|{backend}"


# ---------------------------------------------------------------------------
# Cache layers
# ---------------------------------------------------------------------------

_MEM: "collections.OrderedDict[str, TileConfig]" = collections.OrderedDict()
_DISK: dict = {}    # str(path) -> {key: TileConfig}


def _mem_get(key: str) -> Optional[TileConfig]:
    cfg = _MEM.get(key)
    if cfg is not None:
        _MEM.move_to_end(key)
    return cfg


def _mem_put(key: str, cfg: TileConfig) -> None:
    _MEM[key] = cfg
    _MEM.move_to_end(key)
    while len(_MEM) > _MEM_MAX:
        _MEM.popitem(last=False)


def cache_path(path: "str | os.PathLike | bool | None" = None
               ) -> Optional[pathlib.Path]:
    """The persistent cache location: an explicit ``path`` wins, else the
    ``REPRO_TORCH_TUNE_CACHE`` env var; ``False`` skips the disk layer
    whatever the env var says, and a result of ``None`` means no disk
    layer."""
    if path is False:
        return None
    p = path if path is not None else os.environ.get(ENV_VAR)
    return pathlib.Path(p) if p else None


def _disk_entries(p: pathlib.Path, *, reload: bool = False) -> dict:
    """Parsed entries of one persistent cache file.  Corrupt, partial or
    missing files yield ``{}`` (bad entries are skipped, good ones kept): a
    bad cache can only cost a sweep, never an error."""
    key = str(p)
    if not reload and key in _DISK:
        return _DISK[key]
    entries: dict = {}
    try:
        doc = json.loads(p.read_text())
        if isinstance(doc, dict):
            for k, v in (doc.get("entries") or {}).items():
                try:
                    entries[str(k)] = TileConfig.from_dict(v)
                except ValueError:
                    continue
    except (OSError, json.JSONDecodeError, ValueError, TypeError,
            AttributeError):
        entries = {}
    _DISK[key] = entries
    return entries


def save_entry(key: str, cfg: TileConfig,
               path: "str | os.PathLike | None" = None) -> bool:
    """Merge one winner into the persistent cache (write a temporary file,
    then replace).  Returns False when no cache path is configured or the
    write fails."""
    p = cache_path(path)
    if p is None:
        return False
    entries = dict(_disk_entries(p, reload=True))
    entries[key] = cfg
    doc = {"schema": CACHE_SCHEMA,
           "entries": {k: c.to_dict() for k, c in sorted(entries.items())}}
    try:
        p.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(p.parent), prefix=p.name + ".",
                                   suffix=".tmp")
    except OSError:
        return False
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
        os.replace(tmp, p)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False
    _DISK[str(p)] = entries
    return True


def clear_caches() -> None:
    """Drop the in-process LRU and the parsed-file memo (tests; also the
    hook for 'the env var changed mid-process')."""
    _MEM.clear()
    _DISK.clear()


def lookup(kernel: str, *, dtype=torch.float32, device=None,
           device_kind: Optional[str] = None,
           backend: Optional[str] = None,
           path: "str | os.PathLike | bool | None" = None,
           with_source: bool = False, **dims):
    """Resolve a :class:`TileConfig` for a shape on ``device`` (``None``:
    the current CUDA device) — never sweeps.  ``path`` names the
    persistent file (``None``: the env var's; ``False``: none, so the
    table answers a cold key).  ``with_source=True`` returns
    ``(config, source)``, source one of ``"memory" | "disk" | "table" |
    "default"``."""
    key = cache_key(kernel, dtype=dtype, device=device,
                    device_kind=device_kind, backend=backend, **dims)
    cfg = _mem_get(key)
    if cfg is not None:
        return (cfg, "memory") if with_source else cfg
    p = cache_path(path)
    if p is not None:
        cfg = _disk_entries(p).get(key)
        if cfg is not None:
            _mem_put(key, cfg)
            return (cfg, "disk") if with_source else cfg
    from . import tune_table
    dk = key.split("|")[3]
    cfg = tune_table.load_default(kernel, dk, shape_bucket(kernel, **dims))
    source = "table"
    if cfg is None:
        cfg, source = DEFAULT, "default"
    _mem_put(key, cfg)
    return (cfg, source) if with_source else cfg


def prewarm(kernel: str, *, dtype=torch.float32, device=None,
            **dims) -> TileConfig:
    """Pull a shape's config through the layers into the in-process LRU;
    ``api.plan`` calls it for the job's shape."""
    return lookup(kernel, dtype=dtype, device=device, **dims)


# ---------------------------------------------------------------------------
# The launch a config gives: the clamps of tiles.py
# ---------------------------------------------------------------------------

def _reckoned_occupancy(kernel: str, dims: dict, dtype):
    """Blocks per SM by ``tiles.blocks_per_sm``'s shared-memory and thread
    reckoning (registers aside) — the occupancy off the card."""
    if kernel == "lloyd":
        k, d = dims["k"], dims["d"]
        return lambda t: tiles.blocks_per_sm(
            tiles.lloyd_simt_smem_bytes(k, d, t))
    if kernel == "assign":
        stride = tiles.center_stride(dims["d"])
        return lambda t, wide: tiles.blocks_per_sm(4 * t * stride)
    if kernel == "scan":
        return lambda: tiles.blocks_per_sm(
            tiles.scan_smem_bytes(dims["msub"], dims["c"], dtype))
    return None


def _device_occupancy(kernel: str, dims: dict, dtype, device):
    """The runtime's blocks per SM, as the kernel's wrapper asks for them
    (contiguous codes, as a tensor allocation aligns them)."""
    from . import assign, lloyd, scan
    if kernel == "lloyd":
        return lambda t: lloyd.simt_occupancy(dims["k"], dims["d"], t)[0]
    if kernel == "assign":
        return lambda t, wide: assign.occupancy(dims["k"], dims["d"], wide,
                                                t)
    if kernel == "scan":
        m = dims["msub"]
        vec = tiles.code_vector_bytes(m, 0, dims["l"] * m)
        return lambda: scan.occupancy(m, dims["c"], dtype == torch.bfloat16,
                                      vec)
    return None


def effective_config(kernel: str, cfg: TileConfig, *, sm_count: int,
                     occupancy=None, dtype=torch.float32,
                     **dims) -> TileConfig:
    """The launch the kernel actually makes for ``cfg`` on a card of
    ``sm_count`` SMs, every axis resolved and clamped by ``tiles.py`` —
    the dedupe identity of a candidate.  ``occupancy`` is the runtime's
    blocks per SM (see ``_device_occupancy``); ``None`` reckons it from
    shared memory and threads.  A shape on a route that takes no config
    (the tensor-core routes, the centroid update's sort path) gives
    :data:`DEFAULT`."""
    dims = _check_dims(kernel, dims)
    occ = occupancy or _reckoned_occupancy(kernel, dims, dtype)
    if kernel == "scan":
        p = tiles.scan_plan(dims["b"], dims["l"], occ(), sm_count, cfg.blocks)
        return TileConfig(blocks=p.blocks)
    b, m, k, d = dims["b"], dims["m"], dims["k"], dims["d"]
    if kernel == "lloyd":
        if tiles.lloyd_route(k, d) == "tc":
            return DEFAULT
        p = tiles.lloyd_plan(b, m, k, d, sm_count, occ, cfg.center_tile,
                             cfg.blocks)
        return TileConfig(center_tile=p.center_tile, blocks=p.blocks)
    if kernel == "assign":
        if tiles.assign_route(k, d) == "tc":
            return DEFAULT
        p = tiles.assign_plan(b, m, k, d, sm_count, occ, cfg.center_tile,
                              cfg.points, cfg.blocks)
        return TileConfig(center_tile=p.center_tile, blocks=p.blocks,
                          points=p.points)
    if tiles.centroid_sorts(k, d):
        return DEFAULT
    return TileConfig(blocks=tiles.centroid_blocks(b, m, k, d, sm_count,
                                                   cfg.blocks))


def relative_config(eff: TileConfig, derived: TileConfig) -> TileConfig:
    """``eff`` with every axis the derived plan's ``derived`` shares set to
    0 (its formula): the form the caches store, so the other shapes of a
    bucket keep the formula wherever the winner did."""
    return TileConfig(*(0 if e == f else e for e, f in zip(eff, derived)))


# ---------------------------------------------------------------------------
# Checks against the plain version and against the derived plan
# ---------------------------------------------------------------------------

def dot_rounding_bound(x, c) -> float:
    """Worst-case f32 rounding error of the expanded-form distance
    |x|^2 + |c|^2 - 2 x.c at width d: the three length-d sums each err by
    at most about d eps times the sum of their terms' magnitudes (Higham's
    bound), so (d + 2) eps (|x|^2 + |c|^2 + 2 |x| |c|) at the largest
    norms."""
    x2 = float((x.float() ** 2).sum(-1).amax())
    c2 = float((c.float() ** 2).sum(-1).amax())
    eps = torch.finfo(torch.float32).eps
    return (x.shape[-1] + 2) * eps * (x2 + c2 + 2 * (x2 * c2) ** 0.5)


def assignment_mismatch(x, c, idx, dist, ridx, rdist, cancel=None
                        ) -> tuple[Optional[str], int]:
    """``(reason or None, labels that differ)`` of an assignment against
    the plain one: distances at rtol 1e-4 plus the expanded form's
    cancellation error ``cancel`` (by default a few ulps of |x|^2 +
    |c|^2); a label may differ only where the plain distances to the two
    candidates differ by less than 1e-5 relative plus ``cancel`` (a
    near-tie under reordered arithmetic)."""
    xf, cf = x.float(), c.float()
    if cancel is None:
        scale = float((xf * xf).sum(-1).amax() + (cf * cf).sum(-1).amax())
        cancel = 4 * torch.finfo(torch.float32).eps * scale
    derr = float(((dist - rdist).abs() - 1e-4 * rdist.abs()).amax())
    if derr > cancel:
        return f"dist off by {derr}", 0
    diff = (idx != ridx).nonzero(as_tuple=True)
    n_diff = int(diff[0].numel())
    if n_diff:
        xs = xf[diff]
        dk = ((xs - cf[diff[0], idx[diff].long()]) ** 2).sum(-1)
        dr = ((xs - cf[diff[0], ridx[diff].long()]) ** 2).sum(-1)
        gap = float(((dk - dr).abs() - 1e-5 * dr.abs()).amax())
        if gap > cancel:
            return (f"{n_diff} labels differ, not at near-ties (gap {gap})",
                    n_diff)
    return None, n_diff


def _cancel(x, c, route: str):
    return dot_rounding_bound(x, c) if route == "tc" else None


def _verify_lloyd(x, w, c, got, want) -> Optional[str]:
    from .ref import centroid_update_ref
    sums, counts, sse, idx, dist = got
    ridx, rdist = want[3], want[4]
    k = c.shape[1]
    bad, _ = assignment_mismatch(x, c, idx, dist, ridx, rdist,
                                 _cancel(x, c, tiles.lloyd_route(k,
                                                                 x.shape[2])))
    if bad:
        return bad
    csums, ccounts = centroid_update_ref(x, idx, w, k)
    if not torch.equal(counts, ccounts):
        return "counts differ from the plain sums of its labels"
    serr = float(((sums - csums).abs() - 1e-4 * csums.abs()).amax())
    if serr > 1e-4 * float(csums.abs().amax()):
        return f"sums off by {serr}"
    wf = w.float()
    csse = torch.where(wf != 0, rdist * wf, 0.0).sum(-1)
    if not torch.allclose(sse, csse, rtol=1e-4, atol=0.0):
        return "sse off"
    return None


def _verify_assign(x, c, got, want) -> Optional[str]:
    route = tiles.assign_route(c.shape[1], x.shape[2])
    return assignment_mismatch(x, c, *got, *want, _cancel(x, c, route))[0]


def _verify_centroid(got, want) -> Optional[str]:
    """Counts exactly (integer weights), sums within 1e-3 of the plain
    version in f64."""
    if not torch.equal(got[1].double(), want[1]):
        return "counts differ"
    err = float((got[0].double() - want[0]).abs().amax())
    return f"sums off by {err}" if err > 1e-3 else None


def _verify_scan(got, want) -> Optional[str]:
    rel = float(((got[0] - want[0]).abs()
                 / want[0].abs().clamp_min(1e-30)).amax())
    return f"relative error {rel}" if rel > 1e-5 else None


def _changed(kernel: str, eff: TileConfig, derived: TileConfig) -> tuple:
    return tuple(a for a in AXES[kernel]
                 if getattr(eff, a) != getattr(derived, a))


def moved_bits(kernel: str, got: tuple, derived_out: tuple,
               changed: tuple) -> tuple[tuple, Optional[str]]:
    """``(axes that moved bits, reason or None)`` of a candidate's outputs
    against the derived plan's: bit for bit, but for the float sums of a
    kernel whose ``BIT_AXES`` the candidate changed (which then moved
    bits)."""
    differ = [i for i, (g, d) in enumerate(zip(got, derived_out))
              if not torch.equal(g, d)]
    if not differ:
        return (), None
    bit_axes = tuple(a for a in changed if a in BIT_AXES.get(kernel, ()))
    if bit_axes and set(differ) <= set(FLOAT_SUMS[kernel]):
        return bit_axes, None
    return (), (f"outputs {differ} differ from the derived plan's bit for "
                f"bit (changed axes {list(changed)})")


# ---------------------------------------------------------------------------
# Sweep cases and timing
# ---------------------------------------------------------------------------

class Case(NamedTuple):
    """One sweep target.  ``run(config)`` runs the kernel at a config on the
    case's inputs; ``ref()`` the plain version; ``verify(got, want)`` a
    rejection note or ``None``; ``timed(config)`` a no-argument call that
    cycles through input copies (over twice the L2 on a card)."""
    run: Callable[[TileConfig], tuple]
    ref: Callable[[], tuple]
    verify: Callable[[tuple, tuple], Optional[str]]
    timed: Callable[[TileConfig], Callable[[], object]]


def input_copies(inputs: tuple) -> list:
    """``inputs`` and enough fresh copies that one call's inputs leave the
    L2 before the next call reads them again (the copies together hold over
    twice the L2; one set off the card).  A batch broadcast stays one."""
    if inputs[0].device.type != "cuda":
        return [inputs]

    def n_read(t):
        return t[:1].numel() if t.dim() and t.stride(0) == 0 else t.numel()

    def copy(t):
        if t.dim() and t.shape[0] > 1 and t.stride(0) == 0:
            return t[:1].clone().expand_as(t)
        return t.clone()
    size = sum(n_read(t) * t.element_size() for t in inputs)
    return [inputs] + [tuple(copy(t) for t in inputs)
                       for _ in range(-(-2 * L2_BYTES // size))]


def cycling(fn, sets: list) -> Callable[[], object]:
    """A no-argument call of ``fn`` on the next input set of ``sets`` in
    turn."""
    turn = itertools.count()
    return lambda: fn(*sets[next(turn) % len(sets)])


def lloyd_inputs(b, m, k, d, dtype=torch.float32, seed=0, device="cuda",
                 shared=False):
    """``(x, w, c)`` of a (B, M, K, d) call: points in the unit box (the
    scaled space the pipeline clusters in), centers drawn from the points
    plus 1e-3 noise, 0/1 weights with a masked tail; ``shared`` broadcasts
    one point set over the batch (the merge's restarts)."""
    g = torch.Generator(device=device).manual_seed(seed)
    nb = 1 if shared else b
    x = torch.rand((nb, m, d), generator=g, device=device)
    pick = torch.randint(0, m, (b, k), generator=g, device=device)
    c = x.expand(b, -1, -1).gather(1, pick[..., None].expand(-1, -1, d))
    c = c + 1e-3 * torch.randn(c.shape, generator=g, device=device)
    w = torch.ones((nb, m), device=device)
    w[-1, m - min(32, m // 4):] = 0.0
    if shared:
        x, w = x.expand(b, -1, -1), w.expand(b, -1)
    return x.to(dtype), w.to(dtype), c.contiguous().to(dtype)


def _case_lloyd(dims, dtype, seed, device, shared) -> Case:
    from . import lloyd, ref
    x, w, c = lloyd_inputs(dims["b"], dims["m"], dims["k"], dims["d"], dtype,
                      seed, device, shared)
    sets = input_copies((x, w, c))
    return Case(lambda cfg: lloyd.lloyd_step(x, w, c, cfg),
                lambda: ref.lloyd_step_ref(x, w, c),
                lambda got, want: _verify_lloyd(x, w, c, got, want),
                lambda cfg: cycling(
                    lambda *t: lloyd.lloyd_step(*t, cfg), sets))


def _case_assign(dims, dtype, seed, device, shared) -> Case:
    from . import assign, ref
    x, _, c = lloyd_inputs(dims["b"], dims["m"], dims["k"], dims["d"], dtype,
                      seed, device, shared)
    sets = input_copies((x, c))
    return Case(lambda cfg: assign.assign_argmin(x, c, cfg),
                lambda: ref.assign_argmin_ref(x, c),
                lambda got, want: _verify_assign(x, c, got, want),
                lambda cfg: cycling(
                    lambda *t: assign.assign_argmin(*t, cfg), sets))


def _case_centroid(dims, dtype, seed, device, shared) -> Case:
    """The centroid update on the plain assignment's ids (the ``cuda``
    backend's second pass)."""
    from . import centroid, ref
    k = dims["k"]
    x, w, c = lloyd_inputs(dims["b"], dims["m"], k, dims["d"], dtype, seed,
                      device, shared)
    idx, _ = ref.assign_argmin_ref(x, c)
    sets = input_copies((x, idx, w))
    return Case(lambda cfg: centroid.centroid_update(x, idx, w, k, cfg),
                lambda: ref.centroid_update_ref(x.double(), idx, w.double(),
                                                k),
                _verify_centroid,
                lambda cfg: cycling(
                    lambda *t: centroid.centroid_update(*t, k, cfg), sets))


def _case_scan(dims, dtype, seed, device, shared) -> Case:
    from . import ref, scan
    b, l, m, c = dims["b"], dims["l"], dims["msub"], dims["c"]
    g = torch.Generator(device=device).manual_seed(seed)
    luts = torch.rand((b, m, c), generator=g, device=device).to(dtype)
    codes = torch.randint(0, c, (b, l, m), generator=g, device=device,
                          dtype=torch.uint8)
    sets = input_copies((luts, codes))
    return Case(lambda cfg: (scan.adc_scan_cuda(luts, codes, cfg),),
                lambda: (ref.adc_scan_ref(luts, codes),),
                _verify_scan,
                lambda cfg: cycling(
                    lambda *t: scan.adc_scan_cuda(*t, cfg), sets))


# module-level so tests can replace a kernel's sweep case
CASES: dict = {"lloyd": _case_lloyd, "assign": _case_assign,
               "centroid": _case_centroid, "scan": _case_scan}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def median_seconds(run_once: Callable[[], object], device, *,
                   warmup: int = 1, iters: int = 20) -> float:
    """Median seconds per call of ``run_once``.  On a card: CUDA events
    around each of ``iters`` back-to-back calls, queued behind a spin
    kernel so the card never waits on the host between them; off the card,
    the host clock."""
    from repro_torch.telemetry.logger import MedianWindow
    for _ in range(max(warmup, 1)):
        run_once()
    _sync(device)
    iters = max(iters, 1)
    win = MedianWindow(iters)
    if torch.device(device).type != "cuda":
        for _ in range(iters):
            t0 = time.perf_counter()
            run_once()
            win.push(time.perf_counter() - t0)
        return float(win.median)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    with torch.cuda.device(device):
        torch.cuda._sleep(SPIN_CYCLES)
        for start, end in events:
            start.record()
            run_once()
            end.record()
    torch.cuda.synchronize(device)
    for start, end in events:
        win.push(start.elapsed_time(end) / 1e3)
    return float(win.median)


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

class Candidate(NamedTuple):
    config: TileConfig        # effective (every axis resolved) form
    requested: tuple          # the grid entries that resolved to it
    time_s: Optional[float]   # None when rejected before timing
    ok: bool
    note: str                 # "" | rejection reason
    moved: tuple              # axes whose change moved bits (BIT_AXES)


class TuneResult(NamedTuple):
    kernel: str
    key: str
    config: TileConfig          # the winner as the caches store it
    effective: TileConfig       # the winner's launch at this shape
    best_time_s: float
    default_time_s: float       # the derived plan
    speedup_vs_default: float
    spread: float               # |t1 - t2| / min of two derived-plan times
    table_config: Optional[TileConfig]   # the committed row, if one
    table_time_s: Optional[float]
    candidates: tuple           # tuple[Candidate, ...], sweep order


def tune(kernel: str, *, dtype=torch.float32, device=None,
         candidates: Optional[Sequence[TileConfig]] = None,
         seed: int = 0, warmup: int = 1, iters: int = 20,
         shared: bool = False, sm_count: Optional[int] = None,
         time_fn: Optional[Callable[[Callable[[], object]], float]] = None,
         save: bool = True, path: "str | os.PathLike | None" = None,
         **dims) -> TuneResult:
    """Sweep launch configs for one ``(kernel, shape, dtype)`` on ``device``
    (``None``: the current CUDA device) and cache the winner.

    The derived plan runs first: a launch failure there raises, and its
    outputs are the bit-for-bit baseline.  The committed table's config for
    the shape joins next, then ``candidates`` (default
    ``CANDIDATES[kernel]``), each deduped through :func:`effective_config`.
    A candidate is rejected (recorded, never timed) when its launch fails,
    when it disagrees with the plain version, or when an output moves
    against the derived plan's but for the float sums of a ``BIT_AXES``
    change.  ``time_fn(fn)`` replaces the timer (tests); the derived plan
    is timed again last, for ``spread``.  Ties break on sweep order, so the
    derived plan wins them.  Off the card pass ``sm_count`` (the clamps
    then reckon the occupancy)."""
    from . import tune_table
    dims = _check_dims(kernel, dims)
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    kind, backend = device_info(dev)
    key = cache_key(kernel, dtype=dtype, device_kind=kind, backend=backend,
                    **dims)
    occ = None
    if dev.type == "cuda":
        sm_count = sm_count or torch.cuda.get_device_properties(
            dev).multi_processor_count
        occ = _device_occupancy(kernel, dims, dtype, dev)
    elif sm_count is None:
        raise ValueError(f"tune({kernel}): pass sm_count= off the card")

    def eff_of(cfg):
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            return effective_config(kernel, cfg, sm_count=sm_count,
                                    occupancy=occ, dtype=dtype, **dims)

    def timer(eff):
        fn = case.timed(eff)
        if time_fn is not None:
            return float(time_fn(fn))
        return median_seconds(fn, dev, warmup=warmup, iters=iters)

    case = CASES[kernel](dims, dtype, seed, dev, shared)
    want = case.ref()
    derived = eff_of(DEFAULT)
    table = tune_table.load_default(kernel, kind, shape_bucket(kernel,
                                                               **dims))
    grid = [DEFAULT, *([table] if table is not None else []),
            *(candidates if candidates is not None else CANDIDATES[kernel])]
    requests: dict = {}
    for req in grid:
        reqs = requests.setdefault(eff_of(req), [])
        if req not in reqs:
            reqs.append(req)
    swept: list = []
    derived_out = None
    for eff, reqs in requests.items():
        try:
            got = tuple(case.run(eff))
            _sync(dev)
        except (RuntimeError, ValueError) as e:
            if derived_out is None:
                raise           # the derived plan failing is an error
            swept.append(Candidate(eff, tuple(reqs), None, False,
                                   f"raised {type(e).__name__}: {e}", ()))
            continue
        bad = case.verify(got, want)
        moved = ()
        if derived_out is None:
            derived_out = got
        elif bad is None:
            moved, bad = moved_bits(kernel, got, derived_out,
                                    _changed(kernel, eff, derived))
        if bad is not None:
            swept.append(Candidate(eff, tuple(reqs), None, False, bad, ()))
            continue
        swept.append(Candidate(eff, tuple(reqs), timer(eff), True, "",
                               moved))

    timed = [c for c in swept if c.ok]
    if not timed:
        reasons = "; ".join(f"{tuple(c.config)}: {c.note}" for c in swept)
        raise RuntimeError(f"tune({kernel}): every candidate was rejected "
                           f"— {reasons}")
    if not swept[0].ok:
        raise RuntimeError(f"tune({kernel}): the derived plan was rejected "
                           f"— {swept[0].note}")
    best = min(timed, key=lambda c: (c.time_s, swept.index(c)))
    t1, t2 = swept[0].time_s, timer(derived)
    table_eff = eff_of(table) if table is not None else None
    table_c = next((c for c in swept if c.config == table_eff), None)
    stored = relative_config(best.config, derived)
    result = TuneResult(
        kernel=kernel, key=key, config=stored, effective=best.config,
        best_time_s=best.time_s, default_time_s=t1,
        speedup_vs_default=t1 / best.time_s if best.time_s > 0 else 1.0,
        spread=abs(t1 - t2) / min(t1, t2) if min(t1, t2) > 0 else 0.0,
        table_config=table,
        table_time_s=table_c.time_s if table_c is not None else None,
        candidates=tuple(swept))
    _mem_put(key, stored)
    if save:
        save_entry(key, stored, path=path)
    return result


# ---------------------------------------------------------------------------
# The sweep campaign: SWEEP_SHAPES on a card, and the rows it suggests
# ---------------------------------------------------------------------------

def sweep_shape(kernel: str, shape: Shape, *, iters: int = 20,
                warmup: int = 1, seed: int = 0, save: bool = False,
                candidates=None, **kw) -> dict:
    """Tune one sweep point (on the current card unless ``kw`` gives
    ``device=``/``sm_count=``); one JSON-able record: the derived plan's,
    the table config's and the best candidate's ms, each candidate's
    verdict and the axes that moved bits."""
    t0 = time.perf_counter()
    res = tune(kernel, iters=iters, warmup=warmup, seed=seed,
               shared=shape.shared, save=save, candidates=candidates,
               **kw, **shape.dims)
    return dict(
        kernel=kernel, shape=shape.name, dims=shape.dims,
        shared=shape.shared, bucket=shape_bucket(kernel, **shape.dims),
        key=res.key, derived_ms=res.default_time_s * 1e3,
        table_config=None if res.table_config is None
        else res.table_config.to_dict(),
        table_ms=None if res.table_time_s is None
        else res.table_time_s * 1e3,
        best_ms=res.best_time_s * 1e3, best=res.config.to_dict(),
        best_launch=res.effective._asdict(),
        speedup=res.speedup_vs_default, spread=res.spread,
        gain_beyond_spread=res.speedup_vs_default - 1.0 > res.spread,
        moved_bits=sorted({a for c in res.candidates for a in c.moved}),
        candidates=[dict(launch=c.config._asdict(),
                         requested=[r.to_dict() for r in c.requested],
                         ms=None if c.time_s is None else c.time_s * 1e3,
                         ok=c.ok, note=c.note, moved=list(c.moved))
                    for c in res.candidates],
        seconds=time.perf_counter() - t0)


def suggest_rows(records: Sequence[dict]) -> dict:
    """``{kernel: {bucket: fields}}``: per bucket, the grid entry whose
    worst time over the bucket's swept shapes, as a share of the derived
    plan's, is least, where its speedup over the derived plan exceeds 1 +
    the spread at every one of them; a bucket where the derived plan wins
    at some shape keeps the derived plan (no row)."""
    by_bucket: dict = {}
    for r in records:
        by_bucket.setdefault((r["kernel"], r["bucket"]), []).append(r)
    rows: dict = {}
    for (kernel, bucket), recs in sorted(by_bucket.items()):
        shares: dict = {}
        for r in recs:
            for c in r["candidates"]:
                if not c["ok"]:
                    continue
                for req in c["requested"]:
                    shares.setdefault(json.dumps(req, sort_keys=True),
                                      []).append(
                        (c["ms"] / r["derived_ms"], r["spread"]))
        best = None
        for req, vals in shares.items():
            if len(vals) < len(recs) or req == "{}":
                continue
            if all(s * (1.0 + sp) < 1.0 for s, sp in vals):
                worst = max(s for s, _ in vals)
                if best is None or worst < best[0]:
                    best = (worst, req)
        if best is not None:
            rows.setdefault(kernel, {})[bucket] = json.loads(best[1])
    return rows


def check_defaults(verbose: bool = True) -> int:
    """The committed table parses, its ``"*"`` rows are the derived plan,
    every row resolves from the table layer on a card it names, and a
    cold lookup off the card resolves to the derived plan.  Returns the
    entry count; raises ``ValueError``/``AssertionError`` otherwise."""
    from . import tune_table
    n = tune_table.validate_table()
    for kernel, rows in tune_table.TABLE.items():
        for pattern, buckets in rows.items():
            kind = "cpu" if pattern == "*" else pattern
            for bucket, fields in buckets.items():
                got = tune_table.load_default(kernel, kind, bucket)
                if got != TileConfig.from_dict(fields):
                    raise AssertionError(f"{kernel}/{pattern}/{bucket}: "
                                         f"resolves to {got}")
    probes = {k: s[0].dims for k, s in SWEEP_SHAPES.items()}
    saved = dict(_MEM)
    _MEM.clear()
    try:
        for kernel, dims in probes.items():
            cfg, source = lookup(kernel, device="cpu", path=False,
                                 with_source=True, **dims)
            if (cfg, source) != (DEFAULT, "table"):
                raise AssertionError(f"{kernel}: a cold lookup off the card "
                                     f"gave {cfg} from {source}")
    finally:
        _MEM.clear()
        _MEM.update(saved)
    if verbose:
        print(f"# tune_table OK ({n} entries)")
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Sweep the port's kernel launch parameters on a card, "
        "or check the committed table.")
    ap.add_argument("--sweep", action="store_true",
                    help="sweep SWEEP_SHAPES on the current CUDA device")
    ap.add_argument("--smoke", action="store_true",
                    help="the first shape of each kernel, 3 iterations")
    ap.add_argument("--kernel", choices=tuple(SWEEP_SHAPES), action="append",
                    help="only this kernel (repeatable)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=None,
                    help="write every record and the suggested rows here")
    ap.add_argument("--check-defaults", action="store_true")
    args = ap.parse_args(argv)
    if not (args.sweep or args.check_defaults):
        ap.error("give --sweep or --check-defaults")
    if args.check_defaults:
        check_defaults()
    if not args.sweep:
        return 0
    if not torch.cuda.is_available():
        print("autotune --sweep: no CUDA device", file=sys.stderr)
        return 1
    records = []
    for kernel in args.kernel or SWEEP_SHAPES:
        shapes = SWEEP_SHAPES[kernel][:1] if args.smoke else \
            SWEEP_SHAPES[kernel]
        for shape in shapes:
            r = sweep_shape(kernel, shape, iters=3 if args.smoke
                            else args.iters)
            records.append(r)
            print(json.dumps({k: v for k, v in r.items()
                              if k != "candidates"}), flush=True)
    rows = suggest_rows(records)
    print(json.dumps({"suggested_rows": rows}), flush=True)
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(
            device=device_info()[0], records=records, suggested_rows=rows),
            indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
