"""Roofline accounting for the port, on the NVIDIA H100's roofs: the
counterpart of :mod:`repro.roofline.analysis`.

Three terms (seconds, per step, per chip):

  compute    = FLOPs / BF16 peak
  memory     = bytes / HBM rate
  collective = per-chip link bytes / NVLink rate     (ring cost model)

The reference reads its FLOPs, bytes and collectives from XLA's compiled
programs (``cost_of_compiled``, ``f32_upconvert_bytes``); those two have no
counterpart here, since the port has no compiler to ask.  The dry run
(:mod:`repro_torch.launch.dryrun`) counts FLOPs and bytes on ``meta`` and
the collectives from the sharded step's gathers, and assembles the step by
the same A/B differencing of :class:`PartCost`.

Collective bytes by :func:`ring_bytes`, where ``nbytes`` is the result's
bytes (as an HLO result type gives them) and ``n`` the group's size:

  all-gather          nbytes x (n-1)/n      (the result is gathered)
  reduce-scatter      nbytes x (n-1)        (the result is a shard)
  all-reduce          2 x nbytes x (n-1)/n
  all-to-all          nbytes x (n-1)/n
  collective-permute  nbytes

The roofs (:data:`DEVICE_ROOFS`) are those of the NVIDIA H100 SXM5 80GB at
700 W, from its data sheet, dense (no sparsity): FP32 67 TFLOP/s on the
CUDA cores, TF32 495 and BF16 989 TFLOP/s on the tensor cores, HBM3 3.35
TB/s, NVLink 450 GB/s in each direction.  The link rate holds only between
the cards of one 8-GPU NVLink domain; between hosts a mesh goes over the
network, which this module does not model.

The kernel models (:func:`kernel_cost`, :func:`kernel_bound_ms`,
:func:`predicted_vs_measured`) count the work of the function a kernel
computes, whatever implements it:

  * a (point, center) pair of the Lloyd step and the assignment: 2d + 3
    FP32 operations (d multiply-adds for the cross term, the norm add, the
    subtract of 2 x.c, the clamp); on the tensor-core route instead the
    TF32 passes of the cross term that this run's points need (2 K d
    operations a point and pass: three passes in a block of ``TC_ROWS``
    points that holds a value not exact in TF32, two in the others,
    ``lo_rows`` counting the points of the first kind) and the epilogue's
    3 FP32 operations a pair on the CUDA cores, the two units at once;
  * a point of the centroid update: 2d + 1 (its weighted sum and count);
  * a code of the ADC scan: one add;
  * a (query head, centroid) of the cluster attention: 4 dh + 4 (2 dh for
    the logit, 2 dh for the value sum, about 4 for the bias, the max and
    the exponential);
  * bytes: every input read once (a point set broadcast over the lanes,
    ``x_lanes`` = 1, once), every output written once.

The reference's models also count two things that are its TPU schedule,
not the work: the one-hot accumulation matmul of the Lloyd step and the
centroid update (2 m k d + 2 m k; the scan's one-hot matvec, 2 b l m C),
and the (K, d) centers streamed again for every ``block_m`` tile of points
(the scan's tables for every ``block_l`` tile).  The port's kernels do
neither, and neither is counted here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import tiles

# NVIDIA H100 SXM5 80GB at 700 W (data sheet, dense)
FP32_PEAK = 67e12            # FLOP/s, CUDA cores
TF32_PEAK = 495e12           # FLOP/s, tensor cores
BF16_PEAK = 989e12           # FLOP/s, tensor cores
HBM_BYTES_PER_S = 3.35e12    # B/s, HBM3
NVLINK_BYTES_PER_S = 450e9   # B/s each direction, one 8-GPU NVLink domain
ISSUE_PER_SM_CLOCK = 128     # thread-instructions an SM issues a clock (4 x 32)

H100_ROOF = {"peak_flops": BF16_PEAK, "tf32_flops": TF32_PEAK,
             "fp32_flops": FP32_PEAK, "hbm_bw": HBM_BYTES_PER_S,
             "link_bw": NVLINK_BYTES_PER_S}

# per-card roofs by device-kind substring (first match wins, "*" last)
DEVICE_ROOFS = {"H100": H100_ROOF, "*": H100_ROOF}

RING_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute")


def device_roof(device_kind: Optional[str] = None) -> dict:
    """Roof constants for a device kind (substring match, ``"*"``
    fallback)."""
    if device_kind:
        needle = device_kind.lower()
        for pat, roof in DEVICE_ROOFS.items():
            if pat != "*" and pat.lower() in needle:
                return roof
    return DEVICE_ROOFS["*"]


def ring_bytes(op: str, nbytes: float, n: int) -> float:
    """Per-chip link bytes of one collective ``op`` over a group of ``n``
    whose result is ``nbytes`` (the ring model of the module docstring)."""
    if op not in RING_OPS:
        raise ValueError(f"ring_bytes: unknown collective {op!r}")
    if n <= 1:
        return 0.0
    if op == "all-gather":
        return float(nbytes / n * (n - 1))
    if op == "reduce-scatter":
        return float(nbytes * (n - 1))
    if op == "all-reduce":
        return 2.0 * nbytes * (n - 1) / n
    if op == "all-to-all":
        return float(nbytes * (n - 1) / n)
    return float(nbytes)


@dataclasses.dataclass
class PartCost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: float = 0.0
    coll_by_op: dict = dataclasses.field(default_factory=dict)

    def __sub__(self, o):
        return PartCost(self.flops - o.flops, self.bytes - o.bytes,
                        self.coll - o.coll,
                        {k: self.coll_by_op.get(k, 0) - o.coll_by_op.get(k, 0)
                         for k in set(self.coll_by_op) | set(o.coll_by_op)
                         if k != "counts"})

    def scaled(self, k: float):
        return PartCost(self.flops * k, self.bytes * k, self.coll * k,
                        {kk: v * k for kk, v in self.coll_by_op.items()
                         if kk != "counts"})

    def __add__(self, o):
        return PartCost(self.flops + o.flops, self.bytes + o.bytes,
                        self.coll + o.coll,
                        {k: self.coll_by_op.get(k, 0) + o.coll_by_op.get(k, 0)
                         for k in set(self.coll_by_op) | set(o.coll_by_op)
                         if k != "counts"})


def roofline_terms(total: PartCost, chips: int = 1,
                   roof: Optional[dict] = None) -> dict:
    """The three terms of ``total``, whose FLOPs and bytes are the whole
    step's over ``chips`` cards (each does its share) and whose ``coll``
    is one chip's link bytes: compute over the BF16 peak, bytes over HBM,
    link bytes over NVLink."""
    roof = roof or DEVICE_ROOFS["*"]
    return {
        "compute_s": total.flops / chips / roof["peak_flops"],
        "memory_s": total.bytes / chips / roof["hbm_bw"],
        "collective_s": total.coll / roof["link_bw"],
    }


def dominant_term(terms: dict) -> str:
    return max(("compute_s", "memory_s", "collective_s"),
               key=lambda k: terms[k])


def model_flops(cfg, shape, kind: str) -> float:
    """Analytic MODEL_FLOPS: 6 N D for training, 2 N S B for prefill, 2 N B
    for a decode step (one token a sequence), with N the active
    parameters."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if kind == "train":
        return 6.0 * n_active * tokens
    if kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch


# ---------------------------------------------------------------------------
# the kernels' work and bounds
# ---------------------------------------------------------------------------

def _pair_ops(b: int, m: int, k: int, d: int, route: str,
              lo_rows: int) -> tuple[int, int]:
    """(FP32, TF32) operations of a distance scan over b x m points and k
    centers on ``route``."""
    if route == "simt":
        return b * m * k * (2 * d + 3), 0
    if route == "tc":
        return 3 * b * m * k, 2 * k * d * (2 * b * m + lo_rows)
    raise ValueError(f"unknown route {route!r}")


def _work(kernel: str, route: str, dtype_bytes: int,
          dims: dict) -> tuple[int, int, int]:
    """(FP32 operations, TF32 operations, bytes) of one launch."""
    if kernel in ("lloyd", "assign"):
        b, m, k, d = dims.get("b", 1), dims["m"], dims["k"], dims["d"]
        fp32, tf32 = _pair_ops(b, m, k, d, route, dims.get("lo_rows", b * m))
        nbytes = dtype_bytes * (dims.get("x_lanes", b) * m * d
                                + b * k * d) + 8 * b * m  # idx + dist
        if kernel == "lloyd":   # weights; sums, counts and sse
            nbytes += (dtype_bytes * dims.get("w_lanes", b) * m
                       + 4 * b * (k * (d + 1) + 1))
        return fp32, tf32, nbytes
    if kernel == "centroid":
        b, m, k, d = dims.get("b", 1), dims["m"], dims["k"], dims["d"]
        nbytes = (dtype_bytes * (dims.get("x_lanes", b) * m * d
                                 + dims.get("w_lanes", b) * m)
                  + 4 * b * m + 4 * b * k * (d + 1))
        return b * m * (2 * d + 1), 0, nbytes
    if kernel == "scan":
        b, l, msub, c = dims.get("b", 1), dims["l"], dims["msub"], dims["c"]
        nbytes = (dims.get("code_bytes", 1) * b * l * msub
                  + dtype_bytes * b * msub * c + 4 * b * l)
        return b * l * msub, 0, nbytes
    if kernel == "cluster_attn":
        b, h, hkv = dims.get("b", 1), dims["h"], dims["hkv"]
        nc, dh = dims["nc"], dims["dh"]
        nbytes = (dtype_bytes * (b * h * dh + 2 * b * hkv * nc * dh)
                  + 4 * b * hkv * nc + 4 * b * h * (dh + 2))
        return b * h * nc * (4 * dh + 4), 0, nbytes
    raise ValueError(f"kernel_cost: unknown kernel {kernel!r}")


def _seconds(fp32: float, tf32: float, nbytes: float,
             roof: dict) -> tuple[float, float]:
    """(compute s, memory s): the tensor cores and the CUDA cores at once,
    each over its own peak."""
    return (max(tf32 / roof["tf32_flops"], fp32 / roof["fp32_flops"]),
            nbytes / roof["hbm_bw"])


def _ms_by(compute_s: float, memory_s: float) -> tuple[float, str]:
    t_ops, t_bytes = compute_s * 1e3, memory_s * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_cost(kernel: str, *, dtype_bytes: int = 4, route: str = "simt",
                **dims) -> PartCost:
    """Operations and bytes of one launch of ``kernel`` (``lloyd``,
    ``assign``, ``centroid``, ``scan`` or ``cluster_attn``) at ``dims``: ``b, m, k, d`` (and ``x_lanes``,
    ``w_lanes``, ``lo_rows``) for ``lloyd``, ``assign`` and ``centroid``;
    ``b, l, msub, c`` (and ``code_bytes``) for ``scan``; ``b, h, hkv, nc,
    dh`` for ``cluster_attn``.  ``flops`` sums the FP32 and TF32
    operations; ``dtype_bytes`` is the element size of the points, tables
    or queries and keys."""
    fp32, tf32, nbytes = _work(kernel, route, dtype_bytes, dims)
    return PartCost(float(fp32 + tf32), float(nbytes), 0.0)


def kernel_bound_ms(kernel: str, *, route: str = "simt",
                    dtype_bytes: int = 4, roof: Optional[dict] = None,
                    **dims) -> tuple[float, str]:
    """Least time of one launch of ``kernel`` at ``dims`` in ms, and what
    bounds it (``"operations"`` or ``"bytes"``)."""
    fp32, tf32, nbytes = _work(kernel, route, dtype_bytes, dims)
    return _ms_by(*_seconds(fp32, tf32, nbytes, roof or H100_ROOF))


def predicted_vs_measured(kernel: str, measured_s: float, *,
                          device_kind: Optional[str] = None,
                          route: str = "simt", dtype_bytes: int = 4,
                          **dims) -> dict:
    """One launch's roofline report: the predicted time (the larger of the
    compute and memory terms on this device's roofs, which is
    :func:`kernel_bound_ms`), the dominant term, and measured/predicted
    efficiency."""
    fp32, tf32, nbytes = _work(kernel, route, dtype_bytes, dims)
    compute_s, memory_s = _seconds(fp32, tf32, nbytes,
                                   device_roof(device_kind))
    predicted_s = max(compute_s, memory_s)
    return {
        "flops": float(fp32 + tf32),
        "bytes": float(nbytes),
        "compute_s": compute_s,
        "memory_s": memory_s,
        "predicted_s": predicted_s,
        "dominant": "compute" if compute_s >= memory_s else "memory",
        "measured_s": float(measured_s),
        "efficiency": (predicted_s / measured_s
                       if measured_s > 0 else 0.0),
    }


def tc_lo_blocks(x):
    """(B, ceil(M / TC_ROWS)) bool: the tensor-core route's blocks of
    points that hold a value not exact in TF32 (its mantissa rounded to 10
    bits, ties away from zero, as the kernel rounds), which take three
    TF32 passes; the others take two."""
    b, m, _ = x.shape
    bits = x.float().contiguous().view(torch.int32)
    lo = (((bits + 0x1000) & -0x2000) != bits).any(-1).to(torch.int8)
    lo = torch.nn.functional.pad(lo, (0, -m % tiles.TC_ROWS))
    return lo.view(b, -1, tiles.TC_ROWS).any(-1)


def tc_lo_rows(x) -> int:
    """The points of the (B, M, d) ``x`` that lie in the blocks of
    :func:`tc_lo_blocks` (three TF32 passes)."""
    m = x.shape[1]
    rows = torch.full((-(-m // tiles.TC_ROWS),), tiles.TC_ROWS)
    rows[-1] = m - (rows.numel() - 1) * tiles.TC_ROWS
    return int((tc_lo_blocks(x).long().cpu() * rows).sum())


def kernel_dims(kernel: str, *inputs, route: str = "simt") -> dict:
    """The ``dims`` (``dtype_bytes`` included) of :func:`kernel_cost` for
    one launch of ``kernel`` on its wrapper's inputs: ``lloyd`` (x, w, c),
    ``assign`` (x, c), ``centroid`` (x, ids, w, k), ``scan`` (luts,
    codes), ``cluster_attn`` (q, kc, vc, counts).  A point set or weights
    broadcast over the lanes (stride 0) are read once; on the tensor-core
    route ``lo_rows`` is counted from the points."""
    def lanes(t):
        return 1 if t.stride(0) == 0 else t.shape[0]

    if kernel in ("lloyd", "assign", "centroid"):
        x = inputs[0]
        b, m, d = x.shape
        k = (inputs[2].shape[1] if kernel == "lloyd" else
             inputs[1].shape[1] if kernel == "assign" else int(inputs[3]))
        dims = dict(b=b, m=m, k=k, d=d, x_lanes=lanes(x),
                    dtype_bytes=x.element_size())
        if kernel != "assign":
            dims["w_lanes"] = lanes(inputs[1 if kernel == "lloyd" else 2])
        if route == "tc":
            dims["lo_rows"] = tc_lo_rows(x)
        return dims
    if kernel == "scan":
        luts, codes = inputs
        b, l, msub = codes.shape
        return dict(b=b, l=l, msub=msub, c=luts.shape[2],
                    dtype_bytes=luts.element_size(),
                    code_bytes=codes.element_size())
    if kernel == "cluster_attn":
        q, kc = inputs[:2]
        b, h, dh = q.shape
        return dict(b=b, h=h, hkv=kc.shape[1], nc=kc.shape[2], dh=dh,
                    dtype_bytes=q.element_size())
    raise ValueError(f"kernel_dims: unknown kernel {kernel!r}")


def pair_bound_ms(b: int, m: int, k: int, d: int, in_bytes: int,
                  out_bytes: int) -> tuple[float, str]:
    """Least time for a distance scan over b x m points and k centers on
    the CUDA cores moving ``in_bytes + out_bytes``: the larger of its FP32
    work over the FP32 peak and its bytes over the HBM rate.  Work per
    (point, center) pair: 2d for the cross term (d multiply-adds), then
    the norm add, the subtract of 2 x.c and the clamp (+3) — 7 at d=2."""
    return _ms_by(*_seconds(_pair_ops(b, m, k, d, "simt", 0)[0], 0,
                            in_bytes + out_bytes, H100_ROOF))


def issue_floor_ms(b: int, m: int, k: int, d: int, sm_count: int,
                   clock_hz: float) -> float:
    """Least time for the exact per-pair expression of a one-pass
    assignment at the SMs' issue rate (``ISSUE_PER_SM_CLOCK``
    thread-instructions per clock at their top clock): d multiply-adds for
    the cross term, then the norm add, the fused subtract of 2 x.c, the
    clamp, the compare and two selects, d + 6 instructions a pair (nvcc
    compiles argmin_tile's form to d + 7: it doubles 2 x.c and
    subtracts).  Unlike :func:`pair_bound_ms` it charges an add, a compare
    or a select a whole issue slot."""
    return b * m * k * (d + 6) / (sm_count * ISSUE_PER_SM_CLOCK
                                  * clock_hz) * 1e3
