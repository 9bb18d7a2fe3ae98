"""On-card smoke test of the PyTorch port (``repro_torch``): builds the
hand-written CUDA kernels from this checkout, holds each against its plain
PyTorch version at its paths' shapes, and drives the port's paths, each
with the kernels' launch counts set to 0 just before it and read just
after:

  * the clustering main path (``SampledKMeans(spec).fit(x)`` then
    ``predict(x)``, backend ``auto``: ``cuda_tuned``) at the paper's
    500k-point / k=1000 workload, and the same fit through the unfused
    ``cuda`` backend, through ``cuda_fused`` (which ``cuda_tuned`` equals
    bit for bit at the derived plan), through ``mode="chunked"`` in one
    chunk (bit for bit the same fit) and with a mini-batch merge;
  * the out-of-core executor (``mode="chunked"``) over
    ``examples/cluster_oocore.py``'s 5,000,000 x 8 ``IterSource`` (and a
    run whose bounded accumulator flushes), the streaming engine
    (``mode="stream"`` on the same source; ``examples/stream_drift.py``'s
    drifting stream through ``StreamingClusterer`` and ``partial_fit``);
  * the IVF/PQ index (``build_index`` then ``search``) at
    ``benchmarks/specs/index_200k.json`` and ``index_5m.json``, with
    recall@10 against the exact search;
  * the multi-device executors over a mesh of the visible cards (with one
    card, W entries of ``cuda:0``): ``paper_500k`` in ``mode="shard_map"``
    over 4 shards (both merge paths, and the ``cuda`` backend) and its
    exact landmark check against the plain version on a CPU mesh;
    ``benchmarks/specs/chunked_dist_50m.json`` (50,000,000 x 8,
    ``mode="chunked_dist"``) over 8 shards; ``oocore_5m`` on one shard
    (``fit_chunked`` bit for bit); ``index_5m`` built over 4 shards (the
    unsharded index bit for bit); ``stream_5m`` through
    ``make_sharded_update`` over 4 shards; each kernel at every shape
    these paths launched it at against its plain version;
  * the launch-parameter tuner (``kernels/autotune.py``): a sweep of the
    kernels the paths look up at ``autotune.SWEEP_SHAPES`` (derived plan, table
    row and best candidate, each checked against the plain version and
    the derived plan), its lookup layers and their host cost, and every
    committed row of the card at every shape the paths recorded in its
    bucket;
  * clustered-KV decode serving: ``ServeEngine`` over llama3-8b at full
    width with 8 of its 32 layers (random bf16 weights from a seed) with
    the ``long_500k`` cache
    (8192 centroids + a 1024-token window per layer and kv head), two
    512-token requests with a window refresh every 256 tokens; the
    attention quality of ``compress_kv_cache`` + the cluster-attention
    kernel on ``benchmarks/bench_cluster_attn.py``'s keys; and one request
    through the launcher (``python -m repro_torch.launch.serve``);
  * the other attention decoders: gemma3-12b at full width and depth (8
    superblocks) served the same way (in each superblock 5 sliding-window
    layers on 1024-slot rings, its global layer on the clustered cache;
    the refresh on 64 tensor-core lanes at d = 256), its forward over 4096
    tokens, and its forward's logits against
    its decode's through a ring wrap; dbrx-132b at full width with 4 of its 40 layers (one request,
    and a forward with its capacity drops counted); internvl2-2b's forward
    and loss over 256 patches; and the kernels at the shapes only these
    models launch;
  * the recurrent families at full width: zamba2-2.7b at full depth
    served the same way (one 256-token request; its shared attention on
    the clustered cache at dh = 80, the refresh on 192 tensor-core lanes)
    and xlstm-1.3b with 1 of its 6 superblocks on its O(1) recurrent state
    (one 256-token request), each one's forward over 2048 tokens, and its
    forward's logits against its decode's (gated on an f32 copy), on a
    sound run and on a planted fault;
  * training: llama3-8b at full width with 2 of its 32 layers (bf16 from
    seed 0, AdamW with f32 master weights, 8 x 512 tokens in 2
    micro-batches with remat) through ``Trainer.run`` for 2 steps into a
    checkpoint, a second ``Trainer`` restoring it bit for bit, one step
    from each state agreeing bit for bit, the embedding moved by weight
    decay alone, one step with the gradient compressor (the Lloyd kernel
    at d = 1 on each leaf's sample); then ``python -m
    repro_torch.launch.train`` and ``launch.serve --ckpt-dir`` on its
    checkpoint (reduced), in process; the one-device step on a state of
    whole tensors at the same configuration; the sharded trainer at the
    same configuration on a 2 x 2 mesh (``cuda:0`` four times: each
    position's blocks of the parameters, accumulator and optimizer state,
    each equal to ``shard_bytes``; attention, the FFN and the head
    computed over "model", each position gathering only its blocks)
    against the one-device step at rounding level, and its compressed
    step (the hook once, on the gradient gathered whole); dbrx-132b at
    full width with 1 of its 40 layers (Adafactor, bf16 gradients): one
    MoE layer with its experts over two "model" positions against the
    layer whole, bit for bit, and the sharded trainer on the 2 x 2 mesh
    with the experts (8 a position), attention and the head over "model"
    against the one-device step (its drops equal, each position's
    gathers its experts and heads);
  * the encoder-decoder: whisper-base at full width and depth (bf16 from a
    seed) through its forward over 8 x 4096 tokens and 1500 frames, its
    forward's logits against its decode's on an f32 copy (sound, and with
    cross caches of other frames, which must fail), ``ServeEngine`` on
    decode_32k's full 32,768-slot cache at batch 8 and the launcher, and
    ``make_train_step`` on 8 x 4096 tokens with its checkpoint read back
    bit for bit;
  * the data pipeline: ``ClusterBalancedSampler`` over 1,048,576 documents
    of 129 tokens (sketches on the card, 1024 clusters, a chi-square test
    of its draws, a landmark fit's labels against the plain version's,
    one ``Trainer`` step fed by it), and the paper's Table 1 on the Iris
    and Seeds surrogates through ``sampled_kmeans``;
  * the roofline: every kernel's bound comes from
    ``repro_torch.roofline.analysis`` (the H100's roofs and the kernels'
    work), and its ``predicted_vs_measured`` is reported on each shape the
    kernels were timed at; one ``kmeans_lloyd_step`` at paper_500k's
    local shape against the plain version; ``calibrate()`` and the
    paper_500k fit's ``summarize_events`` totals.

    python3 chip_smoke.py          # needs one CUDA device (sm_90a) and nvcc
    python3 chip_smoke.py --stream-sweep 6   # only the stream's seed sweep
    python3 chip_smoke.py --attn-times [SRC] # only the cluster attention,
                                             # built from SRC (a src tree)

Every phase prints one JSON line; any failed check raises (non-zero exit).
Before the last line it prints the card's name and power limit (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them) and one ``{"kernels": [...]}`` line; the last line is
``{"ok": true, "device": {...}}``.  It imports nothing of JAX and nothing of
the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SPECS = ROOT / "benchmarks" / "specs"
SPEC_FILE = SPECS / "paper_500k.json"

T_START = time.perf_counter()
SPIN_CYCLES = 200_000_000  # ~0.1 s at the H100's clock: time to queue calls


def emit(phase: str, **fields) -> None:
    """One JSON line for ``phase``; ``t`` is the script's seconds so far
    (a phase's own seconds are the difference to the line before)."""
    print(json.dumps({"phase": phase, **fields,
                      "t": time.perf_counter() - T_START}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def call_ms(fn, *, iters: int = 20) -> float:
    """Time per call of ``fn()`` in ms, host work included: CUDA events
    around ``iters`` back-to-back calls after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


_COPIES: list = []   # the last inputs handed to rotating, and their copies


def rotating(fn, *inputs):
    """A no-argument call of ``fn`` that cycles through copies of
    ``inputs``, enough that one call's inputs have left the L2 cache by the
    time it is made again (``autotune.input_copies``, the tuner's timing
    inputs).  Each call then reads its inputs from HBM, as the byte bound
    assumes.  The copies of the last inputs are kept, so the timings of one
    shape (kernel, plain version, routes, table row) share them."""
    from repro_torch.kernels.autotune import cycling, input_copies
    if not (_COPIES and len(_COPIES[0]) == len(inputs)
            and all(a is b for a, b in zip(_COPIES[0], inputs))):
        _COPIES[:] = [inputs, input_copies(inputs)]
    return cycling(fn, _COPIES[1])


def device_ms(fn, *, iters: int = 20) -> float:
    """Device time per call of ``fn()`` in ms: CUDA events around ``iters``
    back-to-back calls, queued behind a spin kernel (``torch.cuda._sleep``)
    that keeps the card busy while the host queues them, so the card never
    waits on the host between calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def one_launch_ms(fn) -> float:
    """Device time of one call of ``fn()`` in ms (a compiled kernel's
    launch: no warm-up call), by CUDA events behind a spin kernel."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


# ---------------------------------------------------------------------------
# kernel parity against the plain versions
# ---------------------------------------------------------------------------

def _case(b, m, k, d, *, dtype=torch.float32, share_x=False, seed=0):
    """Points in the unit box (the scaled space the pipeline clusters in),
    centers drawn from the points, 0/1 weights with a masked tail
    (capacity padding): the tuner's sweep inputs (``autotune.lloyd_inputs``)
    on the card."""
    from repro_torch.kernels.autotune import lloyd_inputs
    return lloyd_inputs(b, m, k, d, dtype, seed, "cuda", share_x)


def dot_rounding_bound(x, c) -> float:
    """Worst-case f32 rounding error of the expanded-form distance at width
    d (``autotune.dot_rounding_bound``, which the tuner's checks share).
    At the paper's d = 2 the default bound of :func:`_check_assignment` is
    tighter; at d = 128 this one applies."""
    from repro_torch.kernels.autotune import dot_rounding_bound as bound
    return bound(x, c)


def _check_assignment(name, x, c, idx, dist, ridx, rdist, cancel=None):
    """The tuner's near-tie rule (``autotune.assignment_mismatch``):
    distances at rtol 1e-4 (plus the expanded form's cancellation error
    ``cancel``, by default a few ulps of |x|^2 + |c|^2); a label may differ
    from the plain one only where the plain distances to the two
    candidates differ by less than 1e-5 relative plus ``cancel`` (a
    near-tie under reordered arithmetic).  Returns the labels that
    differ."""
    from repro_torch.kernels.autotune import assignment_mismatch
    bad, n_diff = assignment_mismatch(x, c, idx, dist, ridx, rdist, cancel)
    check(bad is None, f"{name}: {bad}")
    return n_diff


def lloyd_parity(name, x, w, c, cancel=None, config=None):
    """The Lloyd kernel (at ``config``, ``None``: the derived plan) against
    its plain version: labels by the near-tie rule (on the tensor-core
    route by default within :func:`dot_rounding_bound`, as
    :func:`assign_parity`'s), counts exactly, sums and SSE at 1e-4, a
    repeated launch bit-identical."""
    from repro_torch.kernels import lloyd, ref, tiles
    if cancel is None and tiles.lloyd_route(c.shape[1], x.shape[2]) == "tc":
        cancel = dot_rounding_bound(x, c)
    sums, counts, sse, idx, dist = lloyd.lloyd_step(x, w, c, config)
    rsums, rcounts, rsse, ridx, rdist = ref.lloyd_step_ref(x, w, c)
    n_diff = _check_assignment(name, x, c, idx, dist, ridx, rdist, cancel)
    # the statistics against the plain accumulation of the kernel's own
    # labels: counts exactly (integer weights), sums at rtol/atol 1e-4 of
    # their scale
    csums, ccounts = ref.centroid_update_ref(x, idx, w, c.shape[1])
    check(torch.equal(counts, ccounts), f"{name}: counts differ")
    check(torch.equal(counts, rcounts) or n_diff > 0,
          f"{name}: counts differ from the plain step's")
    serr = float(((sums - csums).abs() - 1e-4 * csums.abs()).amax())
    check(serr <= 1e-4 * float(csums.abs().amax()), f"{name}: sums off")
    wf = w.float()
    csse = torch.where(wf != 0, rdist * wf, 0.0).sum(-1)
    check(torch.allclose(sse, csse, rtol=1e-4, atol=0.0), f"{name}: sse off")
    check(torch.allclose(sse, rsse, rtol=1e-4, atol=0.0),
          f"{name}: sse off vs plain step")
    again = lloyd.lloyd_step(x, w, c, config)
    check(all(torch.equal(a, b) for a, b in
              zip(again, (sums, counts, sse, idx, dist))),
          f"{name}: a repeated step is not bit-identical")
    return dict(case=name, shape=list(x.shape) + [c.shape[1]],
                route=tiles.lloyd_route(c.shape[1], x.shape[2]),
                dtype=str(x.dtype), labels_at_near_ties=n_diff,
                max_sum_err=float((sums - csums).abs().amax()),
                max_sse_rel_err=float(torch.where(
                    rsse > 0, (sse - rsse).abs() / rsse, 0.0).amax()))


def assign_parity(name, x, c, config=None):
    """The assignment kernel (at ``config``, ``None``: the derived plan)
    against its plain version on the route its shape takes: on the
    tensor-core route (three TF32 passes) labels may move at near-ties
    within :func:`dot_rounding_bound`, as the Lloyd kernel's there; a
    repeated launch bit-identical."""
    from repro_torch.kernels import assign, ref, tiles
    route = tiles.assign_route(c.shape[1], x.shape[2])
    idx, dist = assign.assign_argmin(x, c, config)
    ridx, rdist = ref.assign_argmin_ref(x, c)
    n_diff = _check_assignment(name, x, c, idx, dist, ridx, rdist,
                               dot_rounding_bound(x, c) if route == "tc"
                               else None)
    again = assign.assign_argmin(x, c, config)
    check(torch.equal(again[0], idx) and torch.equal(again[1], dist),
          f"{name}: a repeated launch is not bit-identical")
    return dict(case=name, shape=list(x.shape) + [c.shape[1]], route=route,
                dtype=str(x.dtype), labels_at_near_ties=n_diff,
                max_dist_err=float((dist - rdist).abs().amax()))


def assign_lloyd_identity(name, x, c):
    """The assignment kernel against the Lloyd kernel's SIMT route on the
    same inputs: ``idx`` and ``dist`` bit-identical, since both run the
    plain version's expression, in the same order, with the same
    contractions."""
    from repro_torch.kernels import assign, lloyd
    idx, dist = assign.assign_argmin(x, c)
    w = torch.ones(x.shape[:2], device=x.device)
    *_, lidx, ldist = lloyd.route_step(x, w, c, "simt")
    n_idx = int((idx != lidx).sum())
    n_dist = int((dist != ldist).sum())
    check(n_idx == 0 and n_dist == 0, f"{name}: the assignment kernel and "
          f"the Lloyd SIMT route differ in {n_idx} labels, {n_dist} distances")
    return dict(case=name, shape=list(x.shape) + [c.shape[1]],
                bit_identical=True)


def backend_step_trace(name, x, w, c):
    """Where the ``cuda`` and ``cuda_fused`` backends part on one Lloyd step
    from the same centers: the Lloyd kernel (its SIMT route, fused) against
    the assignment kernel, the centroid kernel on its labels and the SSE as
    the ``cuda`` backend sums it (``core/backend.py``)."""
    from repro_torch.kernels import assign, centroid, lloyd
    sums, counts, sse, idx, dist = lloyd.lloyd_step(x, w, c)
    uidx, udist = assign.assign_argmin(x, c)
    usums, ucounts = centroid.centroid_update(x, uidx, w, c.shape[1])
    wf = w.float()
    usse = torch.where(wf != 0, udist * wf, 0.0).sum(-1)
    return dict(case=name, shape=list(x.shape) + [c.shape[1]],
                idx_identical=torch.equal(idx, uidx),
                dist_identical=torch.equal(dist, udist),
                counts_identical=torch.equal(counts, ucounts),
                sums_differing=int((sums != usums).sum()),
                max_sum_rel_diff=float(((sums - usums).abs()
                                        / usums.abs().clamp_min(1e-30))
                                       .amax()),
                sse_identical=torch.equal(sse, usse),
                max_sse_rel_diff=float(((sse - usse).abs()
                                        / usse.abs()).amax()))


def centroid_parity(name, x, w, c):
    """The centroid kernel on the ids the assignment kernel gives (see
    :func:`centroid_ids_parity`)."""
    from repro_torch.kernels import assign
    idx, _ = assign.assign_argmin(x, c)
    return centroid_ids_parity(name, x, idx, w, c.shape[1])


def centroid_ids_parity(name, x, idx, w, k, *, rel=0.0):
    """The centroid kernel against its plain version on the given ids:
    counts exactly (integer weights), sums within 1e-3 absolute plus
    ``rel`` times the largest |sum|, a repeated launch bit-identical.  The
    plain version runs in f64: in f32 its CUDA ``index_add_`` adds in an
    order that changes from run to run, and its own rounding took up half
    the tolerance.  ``rel`` is for clusters of many points, whose f32 sum
    errs by up to (n - 1) u times the sum of its terms (Higham's bound;
    u = 2^-24)."""
    from repro_torch.kernels import centroid, ref
    sums, counts = centroid.centroid_update(x, idx, w, k)
    rsums, rcounts = ref.centroid_update_ref(x.double(), idx, w.double(), k)
    check(torch.equal(counts.double(), rcounts), f"{name}: counts differ")
    err = float((sums.double() - rsums).abs().amax())
    tol = 1e-3 + rel * float(rsums.abs().amax())
    check(err <= tol, f"{name}: sums off by {err} (tolerance {tol})")
    again = centroid.centroid_update(x, idx, w, k)
    check(torch.equal(again[0], sums) and torch.equal(again[1], counts),
          f"{name}: a repeated launch is not bit-identical")
    return dict(case=name, shape=list(x.shape) + [k], dtype=str(x.dtype),
                max_abs_err=err, tolerance=tol)


def centroid_worst_cases() -> list:
    """The centroid update's hardest inputs for its sort and warp paths:
    every point in one cluster, K > M with most clusters empty, ids outside
    [0, K) and zero weights, d = 128 above the shared-memory accumulator
    (the sort path) and d = 2 within it (the warp path)."""
    g = torch.Generator("cuda").manual_seed(20)
    u = 2.0 ** -24
    cases = []
    for name, (b, m, k, d) in (("sort", (2, 3000, 4096, 128)),
                               ("warps", (3, 5000, 64, 2))):
        x = torch.rand((b, m, d), generator=g, device="cuda")
        ones = torch.ones((b, m), device="cuda")
        one = torch.full((b, m), k // 3, device="cuda", dtype=torch.int32)
        cases.append(centroid_ids_parity(f"centroid_{name}_one_cluster", x,
                                         one, ones, k, rel=(m - 1) * u))
        # sort: K = 8192 > M, 70% of the clusters empty; warps: ids to 2K,
        # half of them past K
        kw = 8192 if name == "sort" else k
        wide = torch.randint(0, 2 * kw if name == "warps" else kw, (b, m),
                             generator=g, device="cuda", dtype=torch.int32)
        cases.append(centroid_ids_parity(f"centroid_{name}_sparse", x, wide,
                                         ones, kw))
        masked = torch.randint(-5, k + 5, (b, m), generator=g, device="cuda",
                               dtype=torch.int32)
        w01 = (torch.rand((b, m), generator=g, device="cuda") < 0.7).float()
        cases.append(centroid_ids_parity(f"centroid_{name}_masked", x,
                                         masked, w01, k))
        cases.append(centroid_ids_parity(f"centroid_{name}_masked_bf16",
                                         x.bfloat16(), masked, w01.bfloat16(),
                                         k))
    return cases


def scan_parity(name, luts, codes, config=None):
    """The ADC scan kernel (at ``config``, ``None``: the tuner's lookup)
    against its plain version: within 1e-5 relative (the tables hold
    squared distances, >= 0), a repeated launch bit-identical."""
    from repro_torch.kernels import ref, scan
    scan.check_codes(codes, luts.shape[2])
    out = scan.adc_scan_cuda(luts, codes, config)
    want = ref.adc_scan_ref(luts, codes)
    abs_err = (out - want).abs()
    rel = float((abs_err / want.abs().clamp_min(1e-30)).amax())
    check(rel <= 1e-5, f"{name}: relative error {rel}")
    check(torch.equal(scan.adc_scan_cuda(luts, codes, config), out),
          f"{name}: a repeated launch is not bit-identical")
    return dict(case=name, shape=list(codes.shape) + [luts.shape[2]],
                lut_dtype=str(luts.dtype), code_dtype=str(codes.dtype),
                max_abs_err=float(abs_err.amax()), max_rel_err=rel)


def attn_parity(name, q, kc, vc, counts, scale):
    """The cluster-attention kernel against its plain version: the state
    ``(acc, m, l)`` and the normalised output within 3e-4 (absolute, or
    relative to |acc| and l), a repeated launch bit-identical."""
    from repro_torch.kernels import cluster_attn, ref
    got = cluster_attn.cluster_attn_partial(q, kc, vc, counts, scale)
    want = ref.cluster_attn_decode_ref(q, kc, vc, counts, scale)
    errs = {}
    for what, g_, w_ in zip(("acc", "m", "l"), got, want):
        err = float(((g_ - w_).abs() - 3e-4 * w_.abs()).amax())
        check(err <= 3e-4, f"{name}: {what} off by {err}")
        errs[what] = float((g_ - w_).abs().amax())
    out = got[0] / got[2].clamp_min(1e-30)[..., None]
    rout = want[0] / want[2].clamp_min(1e-30)[..., None]
    errs["out"] = float((out - rout).abs().amax())
    check(errs["out"] <= 3e-4, f"{name}: output off by {errs['out']}")
    again = cluster_attn.cluster_attn_partial(q, kc, vc, counts, scale)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{name}: a repeated launch is not bit-identical")
    return dict(case=name, shape=list(q.shape) + list(kc.shape[1:3]),
                dtype=str(kc.dtype), max_abs_err=errs["out"],
                state_max_abs_err=errs)


def attn_kernels_per_call(inputs, scale) -> list:
    """The device kernels one warm ``cluster_attn_partial`` call launches
    (``torch.profiler``), by name: the splits and their merge are one
    kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import cluster_attn
    cluster_attn.cluster_attn_partial(*inputs, scale)
    torch.cuda.synchronize()
    names = []
    # the profiler has come back with no device record at all for this
    # short window on some machines; only such an empty trace is taken
    # again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            cluster_attn.cluster_attn_partial(*inputs, scale)
            torch.cuda.synchronize()
        names = ["cluster_attn_kernel" if "cluster_attn_kernel" in e.name
                 else e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    return names


def attn_case(b, h, hkv, nc, dh, *, dtype=torch.float32, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, h, dh), generator=g, device="cuda").to(dtype)
    kc = torch.randn((b, hkv, nc, dh), generator=g, device="cuda").to(dtype)
    vc = torch.randn((b, hkv, nc, dh), generator=g, device="cuda").to(dtype)
    cnt = torch.randint(0, 50, (b, hkv, nc), generator=g,
                        device="cuda").float()
    return q, kc, vc, cnt


def _kernel_modules() -> dict:
    """Each kernel's wrapper module, by the kernel's name."""
    from repro_torch.kernels import assign, centroid, cluster_attn, lloyd, scan
    return {"lloyd_step": lloyd, "assign_argmin": assign,
            "centroid_update": centroid, "adc_scan": scan,
            "cluster_attn": cluster_attn}


def reset_launches():
    from repro_torch.kernels import lloyd
    for mod in _kernel_modules().values():
        mod.launches = 0
    lloyd.centroid_launches = 0


def read_launches() -> dict:
    """Each kernel's launches, and (``lloyd_centroid_update``) those of the
    centroid kernel made inside the Lloyd kernel's tensor-core route, which
    ``centroid_update`` does not count."""
    from repro_torch.kernels import lloyd
    return {**{name: mod.launches for name, mod in _kernel_modules().items()},
            "lloyd_centroid_update": lloyd.centroid_launches}


class ShapeRecorder:
    """Within ``with``: records the (B, M, K, d) of every call the paths
    make to one kernel's wrapper, ``lloyd_step(x, w, c)``,
    ``assign_argmin(x, c)`` or ``centroid_update(x, idx, w, k)``
    (``shapes``: shape -> calls; ``shared``: the shapes whose points one
    batch broadcast shares) and, where ``timed``, CUDA events around each
    call, read with :meth:`device_ms`; where ``keep``, a copy of the
    tensor arguments of the first call at each shape (``inputs``)."""

    def __init__(self, kernel: str, timed: bool = False, keep: bool = False):
        self.kernel = kernel
        self.timed = timed
        self.keep = keep
        self.shapes: dict = {}
        self.shared: set = set()
        self.inputs: dict = {}
        self.events: list = []

    def __enter__(self):
        mod = _kernel_modules()[self.kernel]
        self._orig = orig = getattr(mod, self.kernel)
        # the argument that gives K: the centers, or centroid_update's k
        k_at = {"lloyd_step": 1, "assign_argmin": 0, "centroid_update": 2}[
            self.kernel]

        def recording(x, *args, **kw):
            k = args[k_at] if isinstance(args[k_at], int) else \
                args[k_at].shape[1]
            key = (x.shape[0], x.shape[1], k, x.shape[2])
            self.shapes[key] = self.shapes.get(key, 0) + 1
            if x.shape[0] > 1 and x.stride(0) == 0:
                self.shared.add(key)
            if self.keep and key not in self.inputs:
                self.inputs[key] = tuple(
                    a.clone() for a in (x, *args) if torch.is_tensor(a))
            if not self.timed:
                return orig(x, *args, **kw)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = orig(x, *args, **kw)
            ev[1].record()
            self.events.append(ev)
            return out

        setattr(mod, self.kernel, recording)
        return self

    def __exit__(self, *exc):
        setattr(_kernel_modules()[self.kernel], self.kernel, self._orig)

    def device_ms(self, since: int = 0) -> list:
        """Device ms of each timed call from the ``since``-th on."""
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events[since:]]


def index_workload(spec_file: Path):
    """An index spec file's spec, corpus source and queries, as
    benchmarks/bench_index.py builds them (numpy, from the workload's
    seed)."""
    from repro_torch.data import IterSource, SyntheticSource
    from repro_torch.index import IndexSpec
    payload = json.loads(spec_file.read_text())
    ispec = IndexSpec.from_dict(payload["index_spec"])
    w = payload["workload"]
    chunk_points = ispec.coarse.chunk.chunk_points
    synth = SyntheticSource(w["n"], dim=w["dim"], n_clusters=w["n_clusters"],
                            seed=w["seed"])
    src = (IterSource(lambda: synth.chunks(chunk_points), dim=w["dim"],
                      n_points=w["n"])
           if w["source"] == "iter" else synth)
    rng = np.random.default_rng(w["seed"] + 1)
    queries = (synth.centers[rng.integers(0, w["n_clusters"], w["queries"])]
               + rng.normal(0, w["query_noise"], (w["queries"], w["dim"]))
               ).astype(np.float32)
    return ispec, w, src, torch.from_numpy(queries).cuda()


def build_and_sweep(spec_file: Path, nprobes, repeats: int):
    """Build the index of a spec file's workload and search it at each
    nprobe: build seconds, queries/s (each of ``repeats`` after a warm-up,
    and the best) and recall@k against the exact search, with the kernels' launches
    counted over the build and the searches, the (B, M, K, d) of the
    build's Lloyd steps (shape -> calls) and the recorder of its
    assignment calls (:class:`ShapeRecorder`)."""
    from repro_torch.index import build_index, exact_search, recall_at_k
    ispec, w, src, queries = index_workload(spec_file)
    k, q_block = w["k"], w["q_block"]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with ShapeRecorder("lloyd_step") as rec, \
            ShapeRecorder("assign_argmin") as arec:
        index, stats = build_index(src, ispec, w["seed"])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sweep = []
    for nprobe in nprobes:
        index.search(queries, k, nprobe=nprobe, q_block=q_block)
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            d, ids = index.search(queries, k, nprobe=nprobe, q_block=q_block)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        sweep.append(dict(nprobe=nprobe, qps=len(queries) / min(times),
                          qps_repeats=[len(queries) / t for t in times],
                          ids=ids, dists=d))
    launches = read_launches()
    t0 = time.perf_counter()
    _, true_ids = exact_search(src, queries, k,
                               chunk_points=ispec.coarse.chunk.chunk_points)
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    for p in sweep:
        p["recall"] = recall_at_k(p["ids"], true_ids)
        p["true_ids"] = true_ids
    check(index.n_points == w["n"] and stats.n_points == w["n"],
          f"{spec_file.name}: indexed {index.n_points} of {w['n']} rows")
    for p in sweep:
        check(bool(torch.isfinite(p["dists"]).all())
              and bool((p["ids"] >= 0).all()),
              f"{spec_file.name}: missing neighbours at nprobe "
              f"{p['nprobe']}")
    return (ispec, w, queries, index, stats, build_s, exact_s, sweep, launches,
            rec.shapes, arec)


def probed_scan_inputs(index, queries, nprobe):
    """The ADC scan's (B, m, C) tables and (B, cap, m) codes for one query
    block at ``nprobe``, as ``search`` hands them to the kernel."""
    from repro_torch.index.ivf import _probe_cells
    from repro_torch.index.pq import build_luts
    cells = _probe_cells(queries, index.coarse_centers, nprobe)
    luts = build_luts(queries, cells, index.coarse_centers, index.codebooks)
    q, p = cells.shape
    m, c = index.codebooks.shape[:2]
    codes = index.codes[cells.long()].reshape(q * p, index.cap, m)
    return luts.reshape(q * p, m, c), codes


def scan_plan(luts, codes) -> dict:
    """The ADC scan's launch for these inputs: blocks per SM (the runtime's
    occupancy), blocks per entry, the grid and waves; checks that the grid
    is one wave wherever the entries fit the card."""
    from repro_torch.kernels import scan, tiles
    b, l, m = codes.shape
    per_sm = scan.occupancy(m, luts.shape[2], luts.dtype == torch.bfloat16,
                            tiles.code_vector_bytes(m, codes.data_ptr(),
                                                    codes.stride(0)))
    p = scan.plan(luts, codes)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_tiles = -(-l // tiles.THREADS)
    check(1 <= p.blocks <= n_tiles and (
        b * p.blocks <= per_sm * sms if b <= per_sm * sms else p.blocks == 1),
        f"adc_scan plan {p} at (B, L) = {(b, l)}")
    return dict(threads=tiles.THREADS, blocks_per_sm=per_sm,
                blocks_per_entry=p.blocks, grid=[p.blocks, b],
                tiles_per_block=-(-n_tiles // p.blocks), waves=p.waves)


# ---------------------------------------------------------------------------
# the out-of-core executor, the streaming engine and mini-batch Lloyd
# ---------------------------------------------------------------------------

# examples/cluster_oocore.py's default run: 5,000,000 x 8 blobs around 64
# centers, chunks of 262,144 rows, re-exposed through an IterSource in
# misaligned pieces (0.71 of a chunk)
OOCORE_N, OOCORE_DIM, OOCORE_K = 5_000_000, 8, 64
OOCORE_CHUNK = 262_144
OOCORE_PIECE = int(OOCORE_CHUNK * 0.71)          # 186,122 rows
FLUSH_CHUNK = 65_536
MINIBATCH_ROWS = 16_384
# most SSE an out-of-core fit may add to the resident single-mode fit's
# (the reference's 0.15, tests/test_chunked.py).  One-sided: on these 64
# separated blobs the merge's kmeans++ misses some blobs in either fit, and
# on the H100 the chunked fit of seeds 0-3 ended -21%, +8%, -16% and -14%
# against the resident one, so a two-sided bound would reject a better fit
QUALITY_LOSS = 0.15


def oocore_source():
    """The ``IterSource`` that ``examples/cluster_oocore.py`` fits: a
    ``SyntheticSource``'s chunks of 186,122 rows (its points depend on that
    chunking), re-batched by the executor."""
    from repro_torch.data import IterSource, SyntheticSource
    synth = SyntheticSource(OOCORE_N, dim=OOCORE_DIM, n_clusters=OOCORE_K,
                            seed=0)
    return IterSource(lambda: synth.chunks(OOCORE_PIECE), dim=OOCORE_DIM,
                      n_points=OOCORE_N)


def oocore_spec(chunk_points: int = OOCORE_CHUNK, sse: str = "pool",
                levels: tuple = (), mode: str = "chunked"):
    """``examples/cluster_oocore.py``'s spec: 16 equal partitions per chunk,
    compression 64, 6 local iterations; a weighted k=64 merge, 10
    iterations, 4 restarts."""
    from repro_torch.core import (ChunkSpec, ClusterSpec, ExecutionSpec,
                                  LocalSpec, MergeSpec, PartitionSpec)
    return ClusterSpec(
        partition=PartitionSpec(scheme="equal", n_sub=16),
        local=LocalSpec(compression=64, iters=6),
        merge=MergeSpec(k=OOCORE_K, iters=10, weighted=True),
        chunk=ChunkSpec(chunk_points=chunk_points, prefetch=2, sse=sse),
        execution=ExecutionSpec(mode=mode), levels=levels)


def profiled_once(fn):
    """(``fn()``, its profile): one call under ``torch.profiler`` (the
    device's activity only: recording the host's operators as well slowed
    a fold of about 140,000 launches from 2.6 s to over a minute), its
    wall time under the profiler, the kernels' device time and count on
    every card, the copies apart (as the prefetchers' run on their side
    streams), and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    sync_all()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        sync_all()
    wall = time.perf_counter() - t0
    rows = device_rows(prof)
    copies = [r for r in rows if r[0].startswith(("Memcpy", "Memset"))]
    kernels = [r for r in rows if r not in copies]
    top = sorted((r for r in kernels if r[2] > 0), key=lambda r: -r[2])[:8]
    return out, dict(profiled_wall_s=wall,
                     device_busy_s=sum(t for _, _, t in kernels),
                     device_launches=sum(n for _, n, _ in kernels),
                     copy_s=sum(t for _, _, t in copies),
                     top_kernels=[dict(name=k[:80], calls=n, s=t)
                                  for k, n, t in top])


def device_rows(prof) -> list:
    """``(name, count, seconds)`` of each kernel, copy and memset the cards
    ran under the finished ``prof``, summed by name from the profiler's
    raw device records: the device rows of ``prof.key_averages()``,
    without the operator tree it builds first (the slow part of reading a
    profile on the card's host)."""
    from torch.autograd import DeviceType
    acc = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            n, ns = acc.get(e.name(), (0, 0))
            acc[e.name()] = (n + 1, ns + e.duration_ns())
    return [(k, n, ns / 1e9) for k, (n, ns) in acc.items()]


def device_profile(fn) -> dict:
    """Where the time of ``fn()`` goes: the wall time of one unprofiled
    call (every card synchronised at both ends), a second, profiled call
    (:func:`profiled_once`), and the idle share of one card's worth of
    busy time."""
    sync_all()
    t0 = time.perf_counter()
    fn()
    sync_all()
    wall = time.perf_counter() - t0
    _, prof = profiled_once(fn)
    del prof["profiled_wall_s"]
    return dict(wall_s=wall, **prof,
                idle_share=max(0.0, 1.0 - prof["device_busy_s"] / wall))


def sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def fold_profile(source, spec) -> dict:
    """Where the chunked fold's time goes (:func:`device_profile` of one
    :func:`fold_pass`), and the time the host takes to produce the
    source's chunks alone (no device work)."""
    from repro_torch.core.device import derive_seed
    from repro_torch.core.pipeline import fold_pass, scale_pass
    cp = spec.chunk.chunk_points
    t0 = time.perf_counter()
    n_host = sum(c.shape[0] for c in source.chunks(cp))
    source_s = time.perf_counter() - t0
    params = scale_pass(source, cp, prefetch=spec.chunk.prefetch,
                        device="cuda")
    seed_local = derive_seed(0, 0)
    prof = device_profile(lambda: fold_pass(source, spec, params,
                                            seed_local, device="cuda"))
    return dict(rows=n_host, source_only_s=source_s,
                fold_wall_s=prof.pop("wall_s"), **prof)


def oocore_5m() -> dict:
    """The chunked executor at full width (``oocore_5m``), through
    ``SampledKMeans.fit`` on the ``IterSource``, with ``auto``
    (``cuda_tuned``) and with ``cuda``; the flush run (``oocore_5m_flush``); each one's exact
    SSE at most ``QUALITY_LOSS`` above a resident single-mode fit's of the
    same 5M points.  Returns what the kernel table needs."""
    from repro_torch.api import SampledKMeans
    from repro_torch.core import LevelSpec, relative_error, sse_pass
    from repro_torch.kernels import ref
    from repro_torch.telemetry import RecordingLogger
    src = oocore_source()
    spec = oocore_spec()
    n_full, tail = divmod(OOCORE_N, OOCORE_CHUNK)
    check(spec.chunked_pool_schedule(OOCORE_N) == (78_112,),
          f"oocore_5m pool schedule {spec.chunked_pool_schedule(OOCORE_N)}")

    # the resident reference: the same 5M points in one tensor (160 MB),
    # fit in single mode, with and without the flush run's level
    level = (LevelSpec(n_sub=16, compression=4, iters=6),)
    x5 = torch.cat([torch.from_numpy(c) for c in src.chunks(OOCORE_CHUNK)]
                   ).cuda()
    t0 = time.perf_counter()
    single = SampledKMeans(oocore_spec(mode="single")).fit(x5, seed=0)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    single_lv = SampledKMeans(oocore_spec(mode="single", levels=level)
                              ).fit(x5, seed=0)
    single_sse, single_lv_sse = float(single.sse_), float(single_lv.sse_)
    del x5, single, single_lv
    torch.cuda.empty_cache()

    # the executor, auto (cuda_tuned): fit, then predict on the source
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with ShapeRecorder("lloyd_step") as lrec, \
            ShapeRecorder("assign_argmin") as arec:
        est = SampledKMeans(spec).fit(src, seed=0)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        labels = est.predict(src)
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches["lloyd_step"] > 0 and launches["assign_argmin"] > 0,
          f"oocore_5m skipped a kernel: {launches}")
    st = est.chunk_stats_
    check(st.n_chunks == n_full + 1 == 20 and st.n_points == OOCORE_N
          and st.max_chunk_points == OOCORE_CHUNK
          and st.pool_size == 78_112 and st.passes == 2,
          f"oocore_5m ChunkStats {st}")
    check(est.centers_.shape == (OOCORE_K, OOCORE_DIM)
          and bool(torch.isfinite(est.centers_).all()), "oocore_5m centers")
    exact = float(sse_pass(src, est.centers_, OOCORE_CHUNK))
    rel = relative_error(exact, single_sse)
    check(rel <= QUALITY_LOSS, f"oocore_5m SSE {exact} vs resident single "
          f"{single_sse}: {rel}")
    check(labels.shape == (OOCORE_N,) and int(labels.min()) >= 0
          and int(labels.max()) < OOCORE_K, "oocore_5m labels")
    first = torch.from_numpy(next(src.chunks(OOCORE_CHUNK))).cuda()
    ridx, _ = ref.assign_argmin_ref(first[None], est.centers_[None])
    agree = float((labels[:OOCORE_CHUNK] == ridx[0]).float().mean())
    check(agree > 0.999, f"oocore_5m predict vs plain: {agree}")

    # where the time goes: the stage timers of a logged fit (bit for bit
    # the unlogged one), and the fold's profile
    log = RecordingLogger()
    logged = SampledKMeans(spec, logger=log).fit(src, seed=0)
    check(torch.equal(logged.centers_, est.centers_)
          and torch.equal(logged.sse_, est.sse_),
          "oocore_5m: a logged fit differs from the unlogged one")
    timers = {e["name"]: e["dur"] for e in log.events
              if e["kind"] == "timer"}
    summary = log.named("fit_chunked")[0]
    profile_ = fold_profile(src, spec)

    # the same fit through the unfused cuda backend
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with ShapeRecorder("assign_argmin") as crec:
        est_cuda = SampledKMeans(spec.replace(backend="cuda")).fit(src,
                                                                   seed=0)
        torch.cuda.synchronize()
    cuda_s = time.perf_counter() - t0
    cuda_launches = read_launches()
    check(cuda_launches["centroid_update"] > 0
          and cuda_launches["assign_argmin"] > 0
          and cuda_launches["lloyd_step"] == 0,
          f"oocore_5m (cuda) skipped a kernel: {cuda_launches}")
    cuda_exact = float(sse_pass(src, est_cuda.centers_, OOCORE_CHUNK))
    cuda_rel = relative_error(cuda_exact, single_sse)
    check(cuda_rel <= QUALITY_LOSS, f"oocore_5m (cuda) SSE {cuda_exact} vs "
          f"{single_sse}: {cuda_rel}")
    emit("oocore_5m", n=OOCORE_N, dim=OOCORE_DIM, k=OOCORE_K,
         chunk_points=OOCORE_CHUNK, piece_rows=OOCORE_PIECE,
         chunk_stats=st._asdict(), fit_s=fit_s,
         points_per_s=OOCORE_N / fit_s, launches=launches,
         lloyd_shapes={str(k_): v for k_, v in lrec.shapes.items()},
         exact_sse=exact, pool_sse=float(est.sse_),
         resident_single_sse=single_sse, resident_single_fit_s=single_s,
         relative_error=rel, predict_agreement=agree, stage_s=timers,
         logged_points_per_s=summary["points_per_sec"],
         peak_rss_mb=summary["peak_rss_mb"], fold_profile=profile_,
         cuda=dict(fit_s=cuda_s, points_per_s=OOCORE_N / cuda_s,
                   launches=cuda_launches, exact_sse=cuda_exact,
                   relative_error=cuda_rel))
    del labels, est_cuda, logged

    # the flush run: chunks of 65,536 and one equal reduce level; the
    # accumulator folds every 8 pending chunk pools
    fspec = oocore_spec(FLUSH_CHUNK, sse="exact", levels=level)
    sched = fspec.chunked_pool_schedule(OOCORE_N)
    check(sched == (7104, 1776), f"oocore_5m_flush schedule {sched}")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with ShapeRecorder("lloyd_step") as frec:
        flush = SampledKMeans(fspec).fit(src, seed=0)
        torch.cuda.synchronize()
    flush_s = time.perf_counter() - t0
    flush_launches = read_launches()
    fst = flush.chunk_stats_
    check(fst.n_chunks == 77 and fst.pool_size == 1776 and fst.passes == 3
          and fst.peak_pool_rows <= 10_912, f"oocore_5m_flush {fst}")
    flush_rel = relative_error(float(flush.sse_), single_lv_sse)
    check(flush_rel <= QUALITY_LOSS, f"oocore_5m_flush SSE "
          f"{float(flush.sse_)} vs resident single {single_lv_sse}: "
          f"{flush_rel}")
    check(bool(torch.isfinite(flush.centers_).all()), "flush centers")
    emit("oocore_5m_flush", chunk_points=FLUSH_CHUNK,
         chunk_stats=fst._asdict(), pool_schedule=list(sched),
         unflushed_pool_rows=78_112, fit_s=flush_s,
         points_per_s=OOCORE_N / flush_s, launches=flush_launches,
         lloyd_shapes={str(k_): v for k_, v in frec.shapes.items()},
         exact_sse=float(flush.sse_), resident_single_sse=single_lv_sse,
         relative_error=flush_rel)
    return dict(est=est, exact_sse=exact, resident_sse=single_sse,
                launches=launches,
                cuda_launches=cuda_launches, flush_launches=flush_launches,
                assign_rec=arec, cuda_assign_rec=crec, lloyd_rec=lrec,
                flush_lloyd_rec=frec)


def stream_5m(oocore_exact_sse: float) -> dict:
    """The oocore_5m source and spec with ``mode="stream"``: 20 updates
    (buffer 1024, decay 0.97), then one exact ``sse_pass``, held to 1.15x
    the chunked executor's exact SSE (the reference's acceptance bound,
    ``tests/test_stream.py``)."""
    from repro_torch.api import SampledKMeans
    from repro_torch.telemetry import RecordingLogger
    src = oocore_source()
    log = RecordingLogger()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with ShapeRecorder("lloyd_step") as lrec:
        est = SampledKMeans(oocore_spec(mode="stream"), logger=log).fit(
            src, seed=0)
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    state = est.stream_state
    check(int(state.step) == 20 and float(state.n_seen) == OOCORE_N,
          f"stream_5m: {int(state.step)} updates, {float(state.n_seen)} "
          f"points")
    check(launches["lloyd_step"] > 0, f"stream_5m skipped the Lloyd "
          f"kernel: {launches}")
    ratio = float(est.sse_) / oocore_exact_sse
    check(bool(torch.isfinite(est.centers_).all()) and ratio <= 1.15,
          f"stream_5m SSE {float(est.sse_)} vs chunked {oocore_exact_sse}")
    ticks = log.named("stream_tick")
    emit("stream_5m", updates=int(state.step), fit_s=fit_s,
         points_per_s=OOCORE_N / fit_s,
         stream_tick_points_per_s=[t["rate_inst"] for t in ticks],
         stream_tick_median_points_per_s=ticks[-1]["rate"],
         launches=launches,
         launches_per_update={n: v / 20 for n, v in launches.items()},
         lloyd_shapes={str(k_): v for k_, v in lrec.shapes.items()},
         sse=float(est.sse_), chunked_exact_sse=oocore_exact_sse,
         sse_ratio=ratio,
         live_coreset=int((state.coreset_w > 0).sum()))
    return dict(launches=launches, sse=float(est.sse_))


def stream_drift() -> dict:
    """``examples/stream_drift.py``'s run: 30 chunks of 2048 drifting
    points, k = 8, decay 0.9, buffer 1024.  The tracked centers' RMSE to
    the moving truth must end below a frozen batch fit's, and
    ``partial_fit`` chunk by chunk must give ``update``'s centers."""
    from repro_torch.api import SampledKMeans
    from repro_torch.core import ClusterSpec, sampled_kmeans
    from repro_torch.data import drifting_blobs
    from repro_torch.stream import StreamConfig, StreamingClusterer
    k = 8
    chunks, _, traj = drifting_blobs(30, 2048, n_clusters=k, dim=2, seed=0,
                                     drift=0.08)
    spec = ClusterSpec.make(k, n_sub=8, compression=5, local_iters=8,
                            global_iters=8)

    def rmse(found, truth):
        d = np.linalg.norm(found.cpu().numpy()[None] - truth[:, None],
                           axis=-1)
        return float(np.sqrt((d.min(1) ** 2).mean()))

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with ShapeRecorder("assign_argmin") as arec:
        sc = StreamingClusterer(StreamConfig.from_spec(spec, decay=0.9,
                                                       buffer_size=1024))
        state = sc.init(dim=2, seed=0)
        track = []
        for t, ch in enumerate(chunks):
            state = sc.update(state, ch)
            if t % 5 == 4:
                track.append(rmse(state.centers, traj[t]))
        idx, last_sse = sc.query(state, chunks[-1])
        torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    launches = read_launches()
    frozen = sampled_kmeans(chunks[0], k, spec=ClusterSpec.make(k),
                            seed=0).centers
    frozen_track = [rmse(frozen, traj[t]) for t in range(4, 30, 5)]
    check(track[-1] < frozen_track[-1], f"stream_drift: tracked RMSE "
          f"{track[-1]} vs frozen {frozen_track[-1]}")
    check(idx.shape == (2048,) and bool(torch.isfinite(last_sse)),
          "stream_drift query")
    est = SampledKMeans(spec, buffer_size=1024, decay=0.9)
    for ch in chunks:
        est.partial_fit(ch, seed=0)
    check(torch.equal(est.centers_, state.centers),
          "stream_drift: partial_fit differs from StreamingClusterer.update")
    emit("stream_drift", chunks=30, chunk_size=2048, k=k, seconds=stream_s,
         updates_per_s=30 / stream_s, launches=launches,
         stream_rmse_every_5=track, frozen_rmse_every_5=frozen_track,
         partial_fit_equals_update=True)
    return dict(launches=launches, assign_rec=arec)


def minibatch_500k(x, spec, full_sse: float) -> dict:
    """paper_500k with a mini-batch merge (``StopSpec(max_iters=10,
    minibatch=16_384)``): finite centers, SSE at most 2x the full-batch
    fit's (the reference's bound, ``tests/test_stop.py``), two runs with
    one seed bit-identical."""
    from repro_torch.api import SampledKMeans
    from repro_torch.core import StopSpec
    mb = spec.replace(merge=dataclasses.replace(
        spec.merge, stop=StopSpec(max_iters=10, minibatch=MINIBATCH_ROWS)))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with ShapeRecorder("lloyd_step") as lrec:
        a = SampledKMeans(mb).fit(x, seed=0)
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    b = SampledKMeans(mb).fit(x, seed=0)
    check(torch.equal(a.centers_, b.centers_) and torch.equal(a.sse_, b.sse_),
          "minibatch_500k: two fits with one seed differ")
    ratio = float(a.sse_) / full_sse
    check(bool(torch.isfinite(a.centers_).all()) and ratio <= 2.0,
          f"minibatch_500k: SSE {float(a.sse_)} vs full batch {full_sse}")
    shape = (4, MINIBATCH_ROWS, spec.merge.k, 2)
    check(lrec.shapes.get(shape) == 10, f"minibatch_500k: the merge's "
          f"steps ran at {lrec.shapes}")
    emit("minibatch_500k", minibatch=MINIBATCH_ROWS, fit_s=fit_s,
         launches=launches,
         lloyd_shapes={str(k_): v for k_, v in lrec.shapes.items()},
         sse=float(a.sse_), full_batch_sse=full_sse, sse_ratio=ratio,
         bit_identical=True)
    return dict(launches=launches)


def chunked_one_chunk_pin(x, spec, single) -> None:
    """paper_500k through ``mode="chunked"`` with ``chunk_points =
    500_000``: the single fit of the same seed bit for bit, on the card."""
    from repro_torch.api import SampledKMeans
    from repro_torch.core import ChunkSpec
    from repro_torch.data import ArraySource
    pin = SampledKMeans(spec.replace(mode="chunked",
                                     chunk=ChunkSpec(chunk_points=500_000))
                        ).fit(ArraySource(x), seed=0)
    check(pin.chunk_stats_.n_chunks == 1, "one-chunk pin: several chunks")
    for name, a, b in zip(single._fields, pin.result_, single):
        check(torch.equal(a, b), f"one-chunk pin: {name} differs from the "
              f"single fit")
    emit("chunked_one_chunk_pin", spec=SPEC_FILE.name, chunk_points=500_000,
         chunk_stats=pin.chunk_stats_._asdict(), bit_identical=True)


# ---------------------------------------------------------------------------
# the multi-device executors over a mesh of the visible cards
# ---------------------------------------------------------------------------

def phase_mesh(n_shards: int):
    """A 1-D ``"data"`` mesh of ``n_shards`` entries over the visible
    cards in turn: distinct cards where as many are visible, and with one
    card ``n_shards`` entries of ``cuda:0`` (the shards then run one after
    another on it, with the multi-shard results)."""
    from repro_torch.launch.mesh import make_mesh
    n = torch.cuda.device_count()
    return make_mesh((n_shards,), ("data",),
                     [f"cuda:{i % n}" for i in range(n_shards)])


# the sharded landmark fit on the card against its plain version: on the
# H100 the single fit's own exact check (``landmark_exact``) differs by
# 1.6e-6 in SSE and 6.7e-5 of the largest coordinate in its centers, the
# 4-shard fit by 1.7e-6 and 3.1e-5 (the Lloyd kernel sums a cluster's ~25k
# points in block order, the CPU in another); 1e-6 was asked and is below
# what the single fit reaches
LANDMARK_SSE_RTOL = 1e-5
LANDMARK_CENTER_RTOL = 1e-4

# shards of each mesh phase
MESH_SHARDS = {"shard_map_500k": 4, "shard_map_landmark_exact": 4,
               "chunked_dist_50m": 8, "chunked_dist_one_shard_pin": 1,
               "index_5m_sharded": 4, "stream_5m_sharded": 4}


def recorded(*kernels):
    """One :class:`ShapeRecorder` per kernel, entered together."""
    stack = contextlib.ExitStack()
    recs = [stack.enter_context(ShapeRecorder(k)) for k in kernels]
    return stack, recs


def _equal_results(a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(a, b))


def shard_map_500k(x, spec, std_sse: float, single) -> dict:
    """paper_500k over 4 shards of 125,000 points, 16 partitions each (64
    in all, as the single fit): the replicated and the distributed merge
    under ``auto`` (``cuda_tuned``), the replicated one under ``cuda``;
    each fit then
    predict, SSE within the reference's 0.15 of ``standard_kmeans``
    (tests/test_pipeline.py), two fits with one seed bit-identical, the
    kernels' launches and shapes.  On one shard the fit is ``single``'s
    (the single fit of the same seed) bit for bit."""
    from repro_torch.api import SampledKMeans
    from repro_torch.core import relative_error
    mesh = phase_mesh(MESH_SHARDS["shard_map_500k"])
    sharded = spec.replace(n_sub=16)
    runs, out = {}, {}
    for name, s in (("replicated", sharded.replace(merge_path="replicated")),
                    ("distributed",
                     sharded.replace(merge_path="distributed")),
                    ("cuda", sharded.replace(merge_path="replicated",
                                             backend="cuda"))):
        sync_all()
        reset_launches()
        t0 = time.perf_counter()
        stack, recs = recorded("lloyd_step", "assign_argmin",
                               "centroid_update")
        with stack:
            est = SampledKMeans(s, mesh=mesh).fit(x, seed=0)
            sync_all()
            fit_s = time.perf_counter() - t0
            labels = est.predict(x)
            sync_all()
        launches = read_launches()
        if name == "cuda":
            check(launches["centroid_update"] > 0
                  and launches["assign_argmin"] > 0
                  and launches["lloyd_step"] == 0,
                  f"shard_map_500k ({name}) skipped a kernel: {launches}")
        else:
            check(launches["lloyd_step"] > 0
                  and launches["assign_argmin"] > 0,
                  f"shard_map_500k ({name}) skipped a kernel: {launches}")
        again = SampledKMeans(s, mesh=mesh).fit(x, seed=0)
        check(_equal_results(est.result_, again.result_),
              f"shard_map_500k ({name}): two fits with one seed differ")
        sse = float(est.sse_)
        rel = relative_error(sse, std_sse)
        check(est.centers_.shape == (1000, 2)
              and bool(torch.isfinite(est.centers_).all())
              and rel < 0.15, f"shard_map_500k ({name}): SSE {sse} vs "
              f"standard {std_sse}: {rel}")
        check(labels.shape == (500_000,) and int(labels.min()) >= 0
              and int(labels.max()) < 1000, f"shard_map_500k ({name}) labels")
        check(est.result_.local_centers.shape[0] == 4 * 16 * 1562,
              f"shard_map_500k ({name}) pool "
              f"{est.result_.local_centers.shape}")
        runs[name] = dict(fit_s=fit_s, fit_points_per_s=500_000 / fit_s,
                          launches=launches, sse=sse,
                          relative_error=rel, bit_identical=True,
                          pool=int(est.result_.local_centers.shape[0]),
                          lloyd_shapes={str(k): v for k, v in
                                        recs[0].shapes.items()})
        out[name] = dict(launches=launches, recs=recs)
    one = SampledKMeans(spec, mesh=phase_mesh(1)).fit(x, seed=0).result_
    for name in ("centers", "local_centers", "sse"):
        check(torch.equal(getattr(one, name), getattr(single, name)),
              f"shard_map_500k on one shard: {name} differs from the single "
              f"fit's")
    prof = device_profile(lambda: SampledKMeans(
        sharded.replace(merge_path="distributed"), mesh=mesh).fit(x, seed=0))
    emit("shard_map_500k", spec=SPEC_FILE.name, shards=mesh.size,
         n_sub_per_shard=16, mesh=[str(d) for d in mesh.devices.flat],
         standard_sse=std_sse, runs=runs, one_shard_equals_single=True,
         distributed_profile=prof)
    return out


def shard_map_landmark_exact(x, coarse) -> dict:
    """The single mode's exact-check recipe over 4 shards (ROADMAP §3):
    the 500,000 points with coarse landmark stages (compression 2000,
    k = 20, tol = 0), 16 partitions a shard, both merge paths, the card's
    kernels against the port's plain version on a mesh of 4 CPU entries:
    the weights equal, the SSE within ``LANDMARK_SSE_RTOL`` and the
    centers within ``LANDMARK_CENTER_RTOL`` of the largest center
    coordinate."""
    from repro_torch.core import make_distributed_sampled_kmeans
    from repro_torch.launch.mesh import make_mesh
    mesh = phase_mesh(MESH_SHARDS["shard_map_landmark_exact"])
    cpu = make_mesh((mesh.size,), ("data",), ["cpu"] * mesh.size)
    x_cpu = x.cpu()
    out, launches, recs = {}, {}, {}
    for merge in ("replicated", "distributed"):
        s = coarse.replace(n_sub=16, merge_path=merge)
        reset_launches()
        stack, recs[merge] = recorded("lloyd_step", "assign_argmin")
        with stack:
            got = make_distributed_sampled_kmeans(mesh, spec=s)(x, 0)
            sync_all()
        launches[merge] = read_launches()
        check(launches[merge]["lloyd_step"] > 0,
              f"shard_map_landmark_exact ({merge}) skipped the Lloyd kernel")
        want = make_distributed_sampled_kmeans(cpu, spec=s)(x_cpu, 0)
        rel_sse = abs(float(got.sse) - float(want.sse)) / float(want.sse)
        rel_c = float((got.centers.cpu() - want.centers).abs().amax()
                      / want.centers.abs().amax())
        rel_local = float((got.local_centers.cpu()
                           - want.local_centers).abs().amax()
                          / want.local_centers.abs().amax())
        same_w = torch.equal(got.local_weights.cpu(), want.local_weights)
        check(rel_sse <= LANDMARK_SSE_RTOL and rel_c <= LANDMARK_CENTER_RTOL
              and same_w,
              f"shard_map_landmark_exact ({merge}): SSE {rel_sse}, centers "
              f"{rel_c} relative, weights equal {same_w}")
        out[merge] = dict(sse_kernels=float(got.sse),
                          sse_plain=float(want.sse), rel_sse=rel_sse,
                          rel_centers=rel_c, rel_local_centers=rel_local,
                          weights_equal=same_w, launches=launches[merge])
    emit("shard_map_landmark_exact", shards=mesh.size, n_sub_per_shard=16,
         compression=2000, k=20, plain_mesh="cpu x 4", **out)
    return dict(launches=launches, recs=recs)


CHUNKED_DIST_SPEC = SPECS / "chunked_dist_50m.json"


def chunked_dist_50m() -> dict:
    """``benchmarks/specs/chunked_dist_50m.json`` as written (50,000,000 x
    8 synthetic points, chunks of 1,048,576, 8 partitions at compression
    512, one reduce level, weighted k = 256, the distributed merge, pool
    SSE) over 8 shards under ``auto`` (``cuda_tuned``), with
    ``benchmarks/chunked_dist_smoke.py``'s checks: 8 devices, every point
    folded, per-device chunk counts within 1, a pool of at least k, the
    centers unscaled (inside the generating centers' box +- 1).  Then
    ``fit_chunked`` on ``ref_fraction`` of the points, timed as that
    script times it, the fold's profile on one shard and the whole fit's
    device profile."""
    from repro_torch.api import execute, plan
    from repro_torch.core import ClusterSpec, fit_chunked
    from repro_torch.data import SyntheticSource
    from repro_torch.telemetry import RecordingLogger
    payload = json.loads(CHUNKED_DIST_SPEC.read_text())
    spec = ClusterSpec.from_dict(payload["cluster_spec"])
    wl = payload["workload"]
    n, dim, seed = int(wl["n"]), int(wl["dim"]), int(wl.get("seed", 0))
    n_clusters = int(wl.get("n_clusters", 0)) or None
    frac = float(wl.get("ref_fraction", 1.0))
    src = SyntheticSource(n, dim=dim, n_clusters=n_clusters, seed=seed)
    mesh = phase_mesh(MESH_SHARDS["chunked_dist_50m"])
    pl = plan(spec, src.shape, mesh=mesh, source=src)
    check(pl.mode == "chunked_dist" and pl.backend.name == "cuda_tuned",
          f"chunked_dist_50m plans {pl.mode} on {pl.backend.name}")
    sync_all()
    reset_launches()
    t0 = time.perf_counter()
    stack, recs = recorded("lloyd_step", "assign_argmin")
    with stack:
        res, stats = execute(pl, src, seed, return_stats=True)
        sync_all()
    wall = time.perf_counter() - t0
    launches = read_launches()
    check(launches["lloyd_step"] > 0, f"chunked_dist_50m skipped the Lloyd "
          f"kernel: {launches}")
    check(stats.n_devices == mesh.size and stats.n_points == n,
          f"chunked_dist_50m {stats}")
    balance = max(stats.per_device_chunks) - min(stats.per_device_chunks)
    check(balance <= 1, f"round-robin imbalance {stats.per_device_chunks}")
    check(stats.pool_size >= spec.merge.k, f"chunked_dist_50m pool {stats}")
    lo = torch.from_numpy(src.centers.min(axis=0) - 1.0).cuda()
    hi = torch.from_numpy(src.centers.max(axis=0) + 1.0).cuda()
    check(res.centers.shape == (spec.merge.k, dim)
          and bool(torch.isfinite(res.centers).all())
          and bool((res.centers >= lo - 1e-3).all())
          and bool((res.centers <= hi + 1e-3).all()),
          "chunked_dist_50m: centers not unscaled")
    # where the time goes: the stage timers of a logged fit (the same fit
    # bit for bit), and the fold's profile on one shard's chunks
    log = RecordingLogger()
    logged, _ = execute(plan(spec, src.shape, mesh=mesh, source=src,
                             logger=log), src, seed, return_stats=True)
    check(_equal_results(logged, res),
          "chunked_dist_50m: a logged fit differs from the unlogged one")
    del logged
    timers = {}
    for e in log.events:
        if e["kind"] == "timer":
            timers[e["name"]] = timers.get(e["name"], 0.0) + e["dur"]
    summary = log.named("fit_chunked_dist")[0]
    fold = fold_profile(src.shard(0, mesh.size), spec)

    # benchmarks/chunked_dist_smoke.py's reference: fit_chunked on
    # ref_fraction of the points, one device
    n_ref = max(spec.chunk.chunk_points, int(n * frac))
    ref_src = SyntheticSource(n_ref, dim=dim, n_clusters=n_clusters,
                              seed=seed)
    sync_all()
    t0 = time.perf_counter()
    ref, _ = fit_chunked(ref_src, spec, seed, device="cuda")
    sync_all()
    ref_wall = time.perf_counter() - t0
    check(bool(torch.isfinite(ref.centers).all()),
          "chunked_dist_50m: the reference fit's centers")
    emit("chunked_dist_50m", spec=CHUNKED_DIST_SPEC.name, n=n, dim=dim,
         shards=mesh.size, mesh=[str(d) for d in mesh.devices.flat],
         fit_s=wall, points_per_s=n / wall,
         logged_points_per_s=summary["points_per_sec"],
         stage_s=timers, chunk_stats=stats._asdict(),
         peak_pool_rows_per_device=stats.peak_pool_rows,
         per_device_chunks=list(stats.per_device_chunks),
         launches=launches,
         lloyd_shapes={str(k): v for k, v in recs[0].shapes.items()},
         pool_sse=float(res.sse),
         reference=dict(n=n_ref, fit_s=ref_wall,
                        points_per_s=n_ref / ref_wall,
                        pool_sse=float(ref.sse)),
         fold_scaling=(n / wall) / (n_ref / ref_wall),
         fold_profile_one_shard=fold, peak_rss_mb=summary["peak_rss_mb"])
    return dict(launches=launches, recs=recs)


def chunked_dist_one_shard_pin(chunked) -> dict:
    """``oocore_5m`` on a one-entry mesh: ``fit_chunked``'s fit bit for bit
    on the card (centers, local centers, weights, SSE, n_dropped), as
    tests/test_chunked_dist.py pins it in the JAX package."""
    from repro_torch.core import fit_chunked_dist
    mesh = phase_mesh(MESH_SHARDS["chunked_dist_one_shard_pin"])
    reset_launches()
    res, stats = fit_chunked_dist(oocore_source(), oocore_spec(), mesh, 0)
    launches = read_launches()
    check(launches["lloyd_step"] > 0, "one-shard pin skipped the Lloyd "
          f"kernel: {launches}")
    for name, a, b in zip(res._fields, res, chunked):
        check(torch.equal(a, b), f"one-shard pin: {name} differs from "
              f"fit_chunked's")
    emit("chunked_dist_one_shard_pin", chunk_stats=stats._asdict(),
         launches=launches, bit_identical=True)
    return launches


# the seeds over which the sharded stream's quality is held: on oocore_5m's
# 64 separated blobs one seed's stream misses blobs or not (the merge's
# kmeans++), and over seeds 0-5 the unsharded stream read 0.94-1.28x the
# chunked fit's exact SSE, the 4-shard one 0.72-1.20x (PERF.md §6), so a
# bound of QUALITY_LOSS holds on the mean of several seeds, not on one
STREAM_SEEDS = (0, 1, 2)


def _stream_run(on, n_sub: int, seed: int):
    """``stream_5m``'s 20 updates through ``make_sharded_update`` on the
    mesh ``on`` with ``n_sub`` partitions a shard; the final state."""
    from repro_torch.stream import (StreamConfig, StreamingClusterer,
                                    make_sharded_update)
    cfg = StreamConfig.from_spec(oocore_spec(mode="stream"))
    sc = StreamingClusterer(dataclasses.replace(cfg, n_sub=n_sub),
                            device=on.devices.flat[0])
    update = make_sharded_update(sc, on)
    state = sc.init(dim=OOCORE_DIM, seed=seed)
    for chunk in oocore_source().chunks(OOCORE_CHUNK):
        state = update(state, torch.from_numpy(chunk))
    return state


def stream_seed_rows(seeds, known: dict = None) -> list:
    """For each seed the exact SSE over oocore_5m's points of: the chunked
    fit, the unsharded stream (16 partitions of 16,384 rows an update),
    the 4-shard stream at 4 partitions a shard (the same partitions) and at
    16 a shard (64 of 4,096 rows), and the unsharded stream at 64
    partitions (the same 4,096-row partitions as 16 a shard).  ``known``
    maps a seed to the entries already measured."""
    from repro_torch.api import SampledKMeans
    from repro_torch.core import sse_pass
    src = oocore_source()
    mesh = phase_mesh(MESH_SHARDS["stream_5m_sharded"])
    one = phase_mesh(1)
    n_sub = oocore_spec().partition.n_sub

    def exact(centers):
        return float(sse_pass(src, centers, OOCORE_CHUNK))

    runs = dict(unsharded=(one, n_sub), sharded=(mesh, n_sub // mesh.size),
                sharded_16_a_shard=(mesh, n_sub),
                unsharded_64=(one, n_sub * mesh.size))
    rows = []
    for seed in seeds:
        row = dict(seed=seed, **(known or {}).get(seed, {}))
        if "chunked" not in row:
            row["chunked"] = exact(SampledKMeans(oocore_spec()).fit(
                src, seed=seed).centers_)
        for name, (on, n) in runs.items():
            if name not in row:
                row[name] = exact(_stream_run(on, n, seed).centers)
        rows.append(row)
    return rows


def stream_5m_sharded(seed0: dict) -> dict:
    """``stream_5m``'s source and config through ``make_sharded_update``
    over 4 shards, 20 updates.  ``cfg.n_sub`` counts partitions per shard,
    so ``stream_5m``'s 16 partitions of a 262,144-row chunk are 4 per shard
    (16,384 rows each, as unsharded); the config's own 16 per shard make
    64 partitions of 4,096 rows.  Seed 0's run is timed and counted; then
    :func:`stream_seed_rows` over ``STREAM_SEEDS`` (``seed0``: seed 0's
    chunked and unsharded SSE, which oocore_5m and stream_5m measured).
    Checks, on the means over the seeds: the sharded stream at most
    ``QUALITY_LOSS`` above the chunked fit, and at each decomposition at
    most ``QUALITY_LOSS`` above the unsharded stream of the same
    partitions (what sharding costs)."""
    from repro_torch.core import sse_pass
    mesh = phase_mesh(MESH_SHARDS["stream_5m_sharded"])
    n_sub = oocore_spec().partition.n_sub // mesh.size
    sync_all()
    reset_launches()
    t0 = time.perf_counter()
    stack, recs = recorded("lloyd_step", "assign_argmin")
    with stack:
        state = _stream_run(mesh, n_sub, 0)
        sync_all()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    check(int(state.step) == 20 and float(state.n_seen) == OOCORE_N,
          f"stream_5m_sharded: {int(state.step)} updates")
    check(launches["lloyd_step"] > 0, f"stream_5m_sharded skipped the "
          f"Lloyd kernel: {launches}")
    check(bool(torch.isfinite(state.centers).all()),
          "stream_5m_sharded: centers not finite")
    seed0 = dict(seed0, sharded=float(sse_pass(oocore_source(), state.centers,
                                               OOCORE_CHUNK)))
    seeds = stream_seed_rows(STREAM_SEEDS, {0: seed0})

    def mean_ratio(a, b):
        return sum(r[a] / r[b] for r in seeds) / len(seeds)

    ratios = {f"{a}_to_{b}": mean_ratio(a, b) for a, b in (
        ("sharded", "chunked"), ("sharded", "unsharded"),
        ("sharded_16_a_shard", "unsharded_64"),
        ("sharded_16_a_shard", "chunked"), ("unsharded_64", "chunked"),
        ("unsharded", "chunked"))}
    for name in ("sharded_to_chunked", "sharded_to_unsharded",
                 "sharded_16_a_shard_to_unsharded_64"):
        check(ratios[name] <= 1.0 + QUALITY_LOSS,
              f"stream_5m_sharded: mean {name} {ratios[name]} over seeds "
              f"{STREAM_SEEDS}: {seeds}")
    emit("stream_5m_sharded", shards=mesh.size, n_sub_per_shard=n_sub,
         updates=20, fit_s=fit_s, s_per_update=fit_s / 20,
         points_per_s=OOCORE_N / fit_s, launches=launches,
         lloyd_shapes={str(k): v for k, v in recs[0].shapes.items()},
         live_coreset=int((state.coreset_w > 0).sum()), seeds=seeds,
         mean_ratios=ratios)
    return dict(launches=launches, recs=recs)


def index_5m_sharded(spec_file: Path, unsharded, true_ids) -> dict:
    """``index_5m`` built with a 4-entry mesh from the same seed.  Its
    source is an ``IterSource``, whose shards take every fourth chunk, so
    ids number the rows shard by shard; mapped back to the source's rows,
    the lists, codes and counts are the unsharded build's bit for bit
    (training is shared and encoding is row by row), and so are the
    search's distances and ids.  Recall@10 at nprobe = 2 against the
    exact search."""
    from repro_torch.index import build_index, recall_at_k
    ispec, w, src, queries = index_workload(spec_file)
    mesh = phase_mesh(MESH_SHARDS["index_5m_sharded"])
    sync_all()
    reset_launches()
    t0 = time.perf_counter()
    stack, recs = recorded("lloyd_step", "assign_argmin")
    with stack:
        index, stats = build_index(src, ispec, w["seed"], mesh=mesh)
        sync_all()
        build_s = time.perf_counter() - t0
        d, ids = index.search(queries, w["k"], nprobe=2, q_block=w["q_block"])
        sync_all()
    launches = read_launches()
    check(all(launches[k] > 0 for k in ("lloyd_step", "assign_argmin",
                                        "adc_scan")),
          f"index_5m_sharded skipped a kernel: {launches}")
    check(stats.n_shards == mesh.size and stats.n_points == w["n"],
          f"index_5m_sharded {stats}")
    # shard-major position -> source row
    cp = ispec.coarse.chunk.chunk_points
    n_chunks = -(-w["n"] // cp)
    rows = torch.cat([torch.arange(j * cp, min((j + 1) * cp, w["n"]))
                      for i in range(mesh.size)
                      for j in range(i, n_chunks, mesh.size)]).cuda()

    def by_row(idx, to_row):
        live = idx.ids >= 0
        r = idx.ids[live].long()
        r = rows[r] if to_row else r
        cell = torch.full((w["n"],), -1, dtype=torch.long,
                          device=idx.ids.device)
        code = torch.zeros((w["n"], idx.codes.shape[2]), dtype=torch.uint8,
                           device=idx.ids.device)
        cell[r] = live.nonzero()[:, 0]
        code[r] = idx.codes[live]
        return cell, code

    for f in ("coarse_centers", "codebooks", "counts"):
        check(torch.equal(getattr(index, f), getattr(unsharded, f)),
              f"index_5m_sharded: {f} differ from the unsharded build's")
    for a, b in zip(by_row(index, True), by_row(unsharded, False)):
        check(torch.equal(a, b), "index_5m_sharded: a row's cell or codes "
              "differ from the unsharded build's")
    mapped = torch.where(ids >= 0, rows[ids.long().clamp_min(0)], ids)
    recall = recall_at_k(mapped, true_ids)
    want_d, want_ids = unsharded.search(queries, w["k"], nprobe=2,
                                        q_block=w["q_block"])
    check(torch.equal(d, want_d) and torch.equal(mapped.to(want_ids.dtype),
                                                 want_ids),
          "index_5m_sharded: the search differs from the unsharded index's")
    emit("index_5m_sharded", shards=mesh.size,
         mesh=[str(dv) for dv in mesh.devices.flat], build_s=build_s,
         stats=stats._asdict(), launches=launches, recall_at_10=recall,
         equal_to_unsharded=True)
    return dict(launches=launches, recs=recs)


def cross_device_check() -> dict:
    """With two or more cards: each kernel's wrapper, given tensors on
    ``cuda:1`` while ``cuda:0`` is current, launches there (its outputs
    are on ``cuda:1``) and agrees with its plain version.  With one card
    there is no other device to launch on, and the line says so."""
    n = torch.cuda.device_count()
    if n < 2:
        return dict(run=False, reason=f"{n} visible card")
    from repro_torch.kernels import assign, centroid, lloyd, scan
    torch.cuda.set_device(0)
    dev = torch.device("cuda:1")
    x, w, c = (t.to(dev) for t in _case(3, 4000, 50, 2, seed=40))
    g = torch.Generator("cuda").manual_seed(41)
    luts = torch.rand((8, 16, 16), generator=g, device="cuda").to(dev)
    codes = torch.randint(0, 16, (8, 700, 16), generator=g, device="cuda",
                          dtype=torch.uint8).to(dev)
    cases = [lloyd_parity("cross_device_lloyd", x, w, c),
             assign_parity("cross_device_assign", x, c),
             centroid_parity("cross_device_centroid", x, w, c),
             scan_parity("cross_device_scan", luts, codes)]
    idx, _ = assign.assign_argmin(x, c)
    outs = [lloyd.lloyd_step(x, w, c)[0], idx,
            centroid.centroid_update(x, idx, w, c.shape[1])[0],
            scan.adc_scan_cuda(luts, codes)]
    check(all(o.device == dev for o in outs),
          "a kernel's outputs are not on its inputs' device")
    return dict(run=True, devices=n, cases=cases)


# ---------------------------------------------------------------------------
# clustered-KV decode serving (llama3-8b, long_500k)
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the launch-parameter tuner: its sweep, its lookup layers, cuda_tuned
# ---------------------------------------------------------------------------

TUNE_ITERS = 5          # timed calls a candidate in the tune phase's sweep
# most host time a lookup may take: one runs before every tuned launch of
# the fit, search and stream paths, which are host-bound (idle 0.77-0.85);
# half of the 0.1 ms of host work a kernel wrapper's call takes (PERF.md
# section 7), and five times the 10.2 us an H100 host measured
LOOKUP_US_MAX = 50.0


@contextlib.contextmanager
def star_rows_only():
    """Within ``with``: the committed table cut to its ``"*"`` rows (the
    derived plan) and empty tuner caches."""
    from repro_torch.kernels import autotune, tune_table
    saved = tune_table.TABLE
    tune_table.TABLE = {k: {"*": rows["*"]} for k, rows in saved.items()}
    autotune.clear_caches()
    try:
        yield
    finally:
        tune_table.TABLE = saved
        autotune.clear_caches()


def tune_backends(x, spec, std_sse: float, auto_est) -> dict:
    """``cuda_tuned`` against ``cuda_fused`` at paper_500k: with the derived
    plan (empty caches, the ``"*"`` rows) the same fit and labels bit for
    bit; ``auto`` resolves to ``cuda_tuned``, and its fit (the main path's,
    ``auto_est``) holds relative SSE < 0.10; every Lloyd lookup of a
    planned tuned fit hits the LRU that ``plan`` pre-warmed; the fit and
    predict times of both backends from this run, in turns (fused, tuned,
    tuned, fused)."""
    from repro_torch.api import SampledKMeans
    from repro_torch.core import CudaTunedBackend, get_backend, relative_error
    check(isinstance(get_backend("auto", device=x.device), CudaTunedBackend),
          "auto does not resolve to cuda_tuned on the card")
    fused_spec = spec.replace(backend="cuda_fused")
    fused = SampledKMeans(fused_spec).fit(x, seed=0)
    fused_labels = fused.predict(x)
    with star_rows_only():
        star = SampledKMeans(spec.replace(backend="cuda_tuned")).fit(x,
                                                                    seed=0)
        star_labels = star.predict(x)
    check(_equal_results(star.result_, fused.result_)
          and torch.equal(star_labels, fused_labels),
          "cuda_tuned at the derived plan differs from cuda_fused")
    # the layer each Lloyd lookup of a planned fit hits
    from repro_torch.api import execute, plan
    from repro_torch.kernels import autotune
    real, sources = autotune.lookup, []

    def spy(kernel, **kw):
        cfg, src = real(kernel, with_source=True, **kw)
        if kernel == "lloyd":
            sources.append(src)
        return cfg
    with star_rows_only():
        pl = plan(spec.replace(backend="cuda_tuned"), tuple(x.shape),
                  device=x.device)
        autotune.lookup = spy
        try:
            execute(pl, x, seed=0)
        finally:
            autotune.lookup = real
    check(sources and set(sources) == {"memory"},
          f"the fit's Lloyd lookups were not pre-warmed: "
          f"{ {src: sources.count(src) for src in set(sources)} }")
    auto_equal = _equal_results(auto_est.result_, fused.result_)
    rel = relative_error(float(auto_est.sse_), std_sse)
    check(rel < 0.10, f"paper_500k through auto: relative SSE {rel}")
    times = {"cuda_fused": [], "auto": []}
    for name in ("cuda_fused", "auto", "auto", "cuda_fused"):
        s = fused_spec if name == "cuda_fused" else spec
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est = SampledKMeans(s).fit(x, seed=0)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        est.predict(x)
        torch.cuda.synchronize()
        times[name].append(dict(fit_s=t1 - t0,
                                predict_s=time.perf_counter() - t1))
    out = dict(derived_plan_equals_cuda_fused=True,
               prewarmed_lloyd_lookups=len(sources),
               auto_equals_cuda_fused=auto_equal, auto_relative_error=rel,
               cuda_fused_relative_error=relative_error(float(fused.sse_),
                                                        std_sse),
               times=times)
    emit("tune_backends", spec=SPEC_FILE.name, **out)
    return out


def tune_sweep() -> list:
    """Each kernel a path looks up (Lloyd, assignment, ADC scan) at every
    shape of ``autotune.SWEEP_SHAPES`` over
    the committed grid, ``TUNE_ITERS`` timed calls a candidate: one line a
    shape with the derived plan's, the table config's and the best
    candidate's ms, each candidate's verdict (launch, ms, note, axes that
    moved bits).  Every candidate must pass the plain version's check and
    equal the derived plan's output bit for bit but on the axes that
    regroup float sums (``autotune.BIT_AXES``)."""
    from repro_torch.kernels import autotune
    records = []
    for kernel, shapes in autotune.SWEEP_SHAPES.items():
        for shape in shapes:
            r = autotune.sweep_shape(kernel, shape, iters=TUNE_ITERS)
            bad = [(c["launch"], c["note"]) for c in r["candidates"]
                   if not c["ok"]]
            check(not bad, f"tune {kernel} {shape.name}: rejected {bad[:3]}")
            check(set(r["moved_bits"])
                  <= set(autotune.BIT_AXES.get(kernel, ())),
                  f"tune {kernel} {shape.name}: bits moved on "
                  f"{r['moved_bits']}")
            emit("tune_sweep", **{k: v for k, v in r.items()
                                  if k != "candidates"},
                 verdicts=[[*c["launch"].values(), c["ms"],
                            c["note"] or "ok", c["moved"]]
                           for c in r["candidates"]])
            records.append(r)
    return records


def tune_layers(records) -> dict:
    """The lookup layers on the card: every committed row of this card
    resolves from the table at a swept shape of its bucket, then from the
    in-process LRU; a bucket without a row resolves to the derived plan; a
    persistent file's entry resolves from disk; an LRU hit takes at most
    ``LOOKUP_US_MAX`` microseconds of host time."""
    import tempfile
    from repro_torch.kernels import autotune, tune_table
    dev = torch.device("cuda", 0)
    kind, _ = autotune.device_info(dev)
    hits = []
    autotune.clear_caches()
    for r in records:
        kernel, dims = r["kernel"], r["dims"]
        row = tune_table.load_default(kernel, kind, r["bucket"])
        got = [autotune.lookup(kernel, device=dev, path=False,
                               with_source=True, **dims) for _ in range(2)]
        check(got == [(row, "table"), (row, "memory")]
              or got[0][1] == "memory",
              f"lookup layers at {kernel} {r['shape']}: {got}")
        if row != autotune.DEFAULT:
            hits.append(dict(kernel=kernel, shape=r["shape"],
                             bucket=r["bucket"], row=row.to_dict()))
    for kernel, rows in tune_table.TABLE.items():
        for pattern, buckets in rows.items():
            if pattern != "*" and pattern.lower() in kind.lower():
                check({h["bucket"] for h in hits if h["kernel"] == kernel}
                      >= set(buckets) - {"*"},
                      f"{kernel}: a {pattern} row was never looked up")
    dims = dict(b=128, l=1586, msub=64, c=256)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "tune.json"
        key = autotune.cache_key("scan", device=dev, **dims)
        check(autotune.save_entry(key, autotune.TileConfig(blocks=3), path),
              "the tuner's cache file was not written")
        autotune.clear_caches()
        disk = autotune.lookup("scan", device=dev, path=path,
                               with_source=True, **dims)
    check(disk == (autotune.TileConfig(blocks=3), "disk"),
          f"the disk layer gave {disk}")
    autotune.clear_caches()
    x = torch.empty((64, 7813, 2), device=dev)
    n = 20_000
    autotune.lookup("lloyd", b=64, m=7813, d=2, k=1562, device=x.device)
    t0 = time.perf_counter()
    for _ in range(n):
        autotune.lookup("lloyd", b=64, m=7813, d=2, k=1562, dtype=x.dtype,
                        device=x.device)
    us = (time.perf_counter() - t0) / n * 1e6
    check(us <= LOOKUP_US_MAX, f"a lookup takes {us} us of host time")
    autotune.clear_caches()
    out = dict(device_kind=kind, table_hits=hits, disk_layer=True,
               lookup_us=us)
    emit("tune_layers", **out)
    return out


def tune_rows_at_paths(by_kernel: dict, scans) -> list:
    """Every committed row of this card against the plain version at every
    shape the paths recorded in its bucket (``by_kernel``: kernel ->
    (shape -> calls, shared shapes); ``scans``: the probed scan inputs),
    and against the derived plan there: bit for bit but on the axes that
    regroup float sums."""
    from repro_torch.kernels import assign, autotune, lloyd, scan, tune_table
    kind, _ = autotune.device_info(torch.device("cuda", 0))
    parity = {"lloyd_step": lloyd_parity, "assign_argmin": assign_parity}
    derived = {"lloyd_step": lambda x, w, c: lloyd.lloyd_step(x, w, c),
               "assign_argmin": lambda x, w, c: assign.assign_argmin(x, c)}
    name_of = {"lloyd_step": "lloyd", "assign_argmin": "assign"}
    cases = []
    for kernel, (shapes, shared) in by_kernel.items():
        tk = name_of[kernel]
        for i, shape in enumerate(sorted(shapes)):
            b, m, k, d = shape
            row = tune_table.load_default(tk, kind, autotune.shape_bucket(
                tk, b=b, m=m, d=d, k=k))
            if row == autotune.DEFAULT:
                continue
            x, w, c = _case(*shape, share_x=shape in shared, seed=105 + i)
            args = (x, c) if kernel == "assign_argmin" else (x, w, c)
            case = parity[kernel](f"{tk}_row_{'x'.join(map(str, shape))}",
                                  *args, config=row)
            run = {"lloyd_step": lambda: lloyd.lloyd_step(x, w, c, row),
                   "assign_argmin": lambda: assign.assign_argmin(x, c, row)
                   }[kernel]
            moved, why = autotune.moved_bits(
                tk, tuple(run()), tuple(derived[kernel](x, w, c)),
                autotune.AXES[tk])
            check(why is None, f"{case['case']}: {why}")
            cases.append(dict(case, row=row.to_dict(), moved_bits=moved))
    for luts, codes in scans:
        b, l, m = codes.shape
        row = tune_table.load_default("scan", kind, autotune.shape_bucket(
            "scan", b=b, l=l, msub=m, c=luts.shape[2]))
        if row != autotune.DEFAULT:
            case = scan_parity(f"scan_row_{b}x{l}x{m}", luts, codes, row)
            check(torch.equal(scan.adc_scan_cuda(luts, codes, row),
                              scan.adc_scan_cuda(luts, codes,
                                                 autotune.DEFAULT)),
                  f"{case['case']}: differs from the derived plan")
            cases.append(dict(case, row=row.to_dict(), moved_bits=()))
    emit("tune_rows_at_paths", device_kind=kind, cases=cases)
    return cases


SERVE_SEED = 0
PROMPT_LEN = 512       # tokens per request (prefill by decode steps)
# llama3-8b serves with 8 of its 32 layers (64 refresh lanes): its two
# requests' decode steps at full depth took about 74 s of the script on
# the H100 (PERF.md §4); gemma3-12b serves at full depth
SERVE_LAYERS = 8
GEN_TOKENS = 32
RECOMPRESS_EVERY = 256
LLOYD_PER_REFRESH = 5  # 4 iterations, then the final pass (max_iters=4)
# recall@10 at nprobe = 2 on the H100 before the assignment kernel's
# tensor-core route routed the builds' chunks (PERF.md §6)
INDEX_RECALL_BEFORE = {"index_200k": 0.983203125, "index_5m": 0.9796875}

# The JAX package's relative error of the same clustered attention against
# exact attention (benchmarks/bench_cluster_attn.py, its jnp reference, run
# on a CPU with ``PYTHONPATH=src python -m benchmarks.run --only
# cluster_attn``); the port's kernel must stay within 1.25x + 0.01 of it.
JAX_ATTN_REL_ERR = {8: 0.3724, 64: 0.4155}


def layer_query(model, blk, token: torch.Tensor, pos: int) -> torch.Tensor:
    """The (B, H, dh) query that attention layer ``blk`` forms for the
    embedded ``token`` at ``pos`` (for layer 0 the query of the served
    step; for a deeper layer a query of its projections on the embedding)."""
    from repro_torch.models.attention import _qkv
    from repro_torch.models.layers import rms_norm, rope_tables
    cfg = model.cfg
    x = model.embed[token.long()]
    xn = rms_norm(x, blk.ln1, cfg.norm_eps)
    cos, sin = rope_tables(torch.tensor([pos], device=token.device), cfg.dh,
                           cfg.rope_theta)
    q, _, _ = _qkv(blk.attn, xn, blk.dims, cos, sin)
    return q.reshape(q.shape[0], cfg.n_heads, cfg.dh)


def clustered_part(caches: dict) -> dict:
    """The stacked clustered cache of a model's caches: ``blocks``, gemma's
    global layers ``super.global``, or zamba2's shared attention
    ``super.attn``."""
    if "blocks" in caches:
        return caches["blocks"]
    sup = caches["super"]
    return sup["global"] if "global" in sup else sup["attn"]


def decode_profile(model, shape, steps: int = 4,
                   kind: str = "clustered", batch: int = 1) -> dict:
    """Where a decode step's time goes (``kind``'s cache, ``batch``
    sequences): the wall time per step
    (``steps`` steps with no synchronisation between them, unprofiled),
    the device's busy time per step (the kernels' device time summed by
    ``torch.profiler`` over ``steps`` more steps; the profiler slows the
    host, not the kernels), the idle share, and the kernels that take the
    most device time (the kernel names are the library's or ours)."""
    from torch.profiler import ProfilerActivity, profile
    caches = model.init_caches(batch, shape, kind)
    tok = torch.zeros((batch, 1), dtype=torch.long, device="cuda")
    for i in range(steps):                       # warm-up
        model.decode_step(tok, caches, i, cache_kind=kind)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps, 2 * steps):
        model.decode_step(tok, caches, i, cache_kind=kind)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(2 * steps, 3 * steps):
            model.decode_step(tok, caches, i, cache_kind=kind)
        torch.cuda.synchronize()
    # the kernels' own rows: an operator's row repeats the device time of
    # the kernels it launched
    rows = [(k, n // steps, sec / steps * 1e3)
            for k, n, sec in device_rows(prof)]
    busy = sum(ms for _, _, ms in rows)
    top = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])[:8]
    return dict(steps=steps, wall_ms_per_step=wall * 1e3,
                device_busy_ms_per_step=busy,
                idle_share=max(0.0, 1.0 - busy / (wall * 1e3)),
                top_kernels=[dict(name=k[:80], per_step=n, ms_per_step=ms)
                             for k, n, ms in top])


def timed_s(fn):
    """Host seconds of ``fn()`` after a synchronise, ended by one; ->
    (seconds, result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def serve_requests(cfg, shape, model, prompt_len: int, gen: int,
                   n_requests: int, attn_layers: int):
    """``n_requests`` identical requests of ``prompt_len`` prompt tokens and
    ``gen`` generated ones through ``ServeEngine`` with the ``shape``'s
    cache (clustered, with a refresh every ``RECOMPRESS_EVERY`` tokens;
    for xlstm the recurrent state): per request the prefill and decode
    times, each refresh's time, live centroids and mass (and its Lloyd
    launches' device ms), the peak device memory and the kernels'
    launches.  Checks each request's launches (the cluster attention once
    per clustered layer (``attn_layers``) and step, the refresh's Lloyd
    passes on the route the shape takes; none of either without a
    clustered cache), that each refresh's mass equals the tokens folded
    and leaves gemma's local rings and zamba2's Mamba2 states alone, and
    that the answers agree.  -> (requests, answers, the clustered cache
    after the last refresh, the prompt)."""
    from repro_torch.core.device import derive_seed
    from repro_torch.kernels import tiles
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.telemetry import RecordingLogger

    log = RecordingLogger()
    eng = ServeEngine(cfg, shape, model,
                      ServeConfig(max_tokens=gen,
                                  recompress_every=RECOMPRESS_EVERY),
                      logger=log)
    clustered = eng.kind == "clustered"
    check(clustered == (attn_layers > 0), f"cache kind {eng.kind}")
    route = tiles.lloyd_route(shape.seq_len // shape.cluster_compression,
                              cfg.dh)
    refreshes, last = [], {}
    maybe_recompress = eng._maybe_recompress

    def recording(caches, pos):       # counts live centroids and mass
        first = len(rec.events)
        out = maybe_recompress(caches, pos)
        if out is not caches:         # a refresh ran
            cnt = clustered_part(out)["counts"]
            live = (cnt > 0).sum(-1)
            lane_mass = cnt.sum(-1)
            # the ring or state tensors of every group but the clustered
            # one pass through the refresh as they were
            untouched = {n: out["super"][n] for n in ("local", "mamba")
                         if n in out.get("super", {})}
            local_kept = all(
                t is caches["super"][g][n]
                for g, tree in untouched.items() for n, t in tree.items())
            refreshes.append(dict(
                pos=pos, live_min=int(live.min()), live_max=int(live.max()),
                live_total=int(live.sum()), mass=float(lane_mass.sum()),
                mass_per_lane_ok=bool((lane_mass == pos).all()),
                local_rings_untouched=local_kept,
                lloyd_calls=(first, len(rec.events))))
            last.update(clustered_part(out))
        return out

    eng._maybe_recompress = recording
    gen_ = torch.Generator(device="cuda")
    gen_.manual_seed(derive_seed(SERVE_SEED, 1))
    prompt = torch.randint(0, cfg.vocab, (1, prompt_len), generator=gen_,
                           device="cuda")
    steps = prompt_len + gen
    requests, answers = [], []
    for _ in range(n_requests):
        log.events.clear()
        refreshes.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        # CUDA events around each Lloyd launch: each refresh's device time
        with ShapeRecorder("lloyd_step", timed=True) as rec:
            answers.append(eng.generate(prompt))
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = read_launches()
        lloyd_ms = rec.device_ms()
        for r in refreshes:
            a, b = r.pop("lloyd_calls")
            r["lloyd_device_ms"] = lloyd_ms[a:b]
        decode_s = sum(e["dur"] for e in log.named("decode_rate"))
        requests.append(dict(
            total_s=total_s, prefill_s=total_s - decode_s,
            prefill_tokens_per_s=prompt_len / (total_s - decode_s),
            decode_s=decode_s, decode_tokens_per_s=gen / decode_s,
            refresh_s=[e["dur"] for e in log.named("recompress")],
            refreshes=list(refreshes), lloyd_shapes=[
                dict(shape=list(k), calls=n) for k, n in rec.shapes.items()],
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches=launches))
        check(launches["cluster_attn"] == attn_layers * steps,
              f"cluster_attn launched {launches['cluster_attn']} times, "
              f"not {attn_layers} layers x {steps} steps")
        n_refresh = steps // RECOMPRESS_EVERY if clustered else 0
        inner = launches["lloyd_step"] if route == "tc" else 0
        check(launches["lloyd_step"] == n_refresh * LLOYD_PER_REFRESH
              and launches["lloyd_centroid_update"] == inner
              and (launches["centroid_update"] > 0) == (n_refresh > 0),
              f"the refresh skipped a kernel ({route} route): {launches}")
        check(len(refreshes) == n_refresh
              and all(r["mass_per_lane_ok"] and r["local_rings_untouched"]
                      for r in refreshes),
              f"refresh mass differs from the tokens folded, or a refresh "
              f"touched a local ring: {refreshes}")
    # the recorder is an attribute of the engine that reaches the engine
    # again: without this the engine and its model would outlive the call
    # until the cyclic collector ran, and count in later phases' peaks
    del eng._maybe_recompress
    check(all(np.array_equal(answers[0], a) for a in answers[1:]),
          "identical requests gave different answers")
    check(answers[0].shape == (1, gen)
          and int(answers[0].min()) >= 0
          and int(answers[0].max()) < cfg.padded_vocab, "bad tokens")
    return requests, answers, last, prompt


def serve_long_500k():
    """Two identical requests through ``ServeEngine`` at full width with
    ``SERVE_LAYERS`` of llama3-8b's 32 layers and the ``long_500k``
    clustered cache: per request the prefill and decode
    times, each refresh's time, live centroids and mass, the peak device
    memory and the kernels' launches."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models import build_model

    cfg, shape = get_config("llama3-8b"), SHAPES["long_500k"]
    cfg = dataclasses.replace(cfg, n_layers=SERVE_LAYERS)
    init_s, model = timed_s(lambda: build_model(cfg).init_params(SERVE_SEED))
    check(model.embed.dtype == torch.bfloat16, "weights are not bf16")
    requests, answers, last, prompt = serve_requests(
        cfg, shape, model, PROMPT_LEN, GEN_TOKENS, 2, cfg.n_layers)
    profile = decode_profile(model, shape)
    # the served layer-0 cache after the last refresh, with a decode query
    q = layer_query(model, model.blocks[0], prompt[:, -1:], PROMPT_LEN)
    parity = attn_parity("attn_served_layer0", q, last["kc"][0],
                         last["vc"][0], last["counts"][0], cfg.dh ** -0.5)
    emit("serve_long_500k", arch=cfg.name, shape=shape.name,
         n_params=sum(p.numel() for p in model.parameters()),
         n_centroids=shape.seq_len // shape.cluster_compression,
         window=shape.cluster_window, prompt_len=PROMPT_LEN,
         gen_tokens=GEN_TOKENS, recompress_every=RECOMPRESS_EVERY,
         init_s=init_s, requests=requests, answer=answers[0][0].tolist(),
         live_totals=[r["live_total"] for r in requests[-1]["refreshes"]],
         identical_answers=True, decode_profile=profile,
         served_cache_parity=parity)
    return requests, parity


def attn_quality():
    """benchmarks/bench_cluster_attn.py's setup through the port: drifting
    keys (numpy, seed 0), ``compress_kv_cache`` at c = 8 and 64, then the
    cluster-attention kernel; relative error against exact attention."""
    from repro_torch.kernels import cluster_attn, ref
    from repro_torch.models.attention import compress_kv_cache
    rng = np.random.default_rng(0)
    b, kv, s, dh, h = 1, 8, 8192, 128, 32
    drift = np.cumsum(rng.normal(0, 0.05, (b, kv, s, dh)), axis=2)
    k = (drift + 0.4 * rng.normal(size=(b, kv, s, dh))).astype(np.float32)
    v = rng.normal(size=(b, kv, s, dh)).astype(np.float32)
    q = rng.normal(size=(b, h, dh)).astype(np.float32)
    k, v, q = (torch.from_numpy(a).cuda() for a in (k, v, q))
    scale = dh ** -0.5
    logits = torch.einsum("bkgd,bksd->bkgs", q.reshape(b, kv, h // kv, dh),
                          k) * scale
    exact = torch.einsum("bkgs,bksd->bkgd", torch.softmax(logits, -1),
                         v).reshape(b, h, dh)
    rows = []
    for c in (8, 64):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kc, vc, counts = compress_kv_cache(k, v, chunk=max(4 * c, 64),
                                           compression=c, iters=8)
        torch.cuda.synchronize()
        compress_s = time.perf_counter() - t0
        check(bool((counts.sum(-1) == s).all()),
              f"c={c}: counts do not sum to {s}")
        approx = cluster_attn.cluster_attn_decode(q, kc, vc, counts, scale)
        err = float((approx - exact).norm() / exact.norm())
        acc, _, l = ref.cluster_attn_decode_ref(q, kc, vc, counts, scale)
        plain = (acc / l[..., None]).reshape(b, h, dh)
        want = JAX_ATTN_REL_ERR[c]
        check(err <= 1.25 * want + 0.01, f"c={c}: relative error {err}, the "
              f"JAX package's {want}")
        rows.append(dict(c=c, rel_err=err, jax_rel_err=want,
                         compress_s=compress_s,
                         kernel_vs_plain=float((approx - plain).abs().amax()),
                         n_centroids=kc.shape[2]))
    emit("attn_quality", rows=rows)
    return rows


def launcher_request():
    """One request through the launcher's entry point (full cache, full
    width): ``python -m repro_torch.launch.serve --arch llama3-8b
    --prompt-len 64 --gen 16 --batch 2``, called in this process."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main as serve_main
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out, _ = serve_main(["--arch", "llama3-8b", "--prompt-len", "64",
                         "--gen", "16", "--batch", "2"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    vocab = get_config("llama3-8b").padded_vocab
    check(out.shape == (2, 16) and int(out.min()) >= 0
          and int(out.max()) < vocab, f"launcher gave {out}")
    emit("launcher", argv="--arch llama3-8b --prompt-len 64 --gen 16 "
         "--batch 2", seconds=seconds, launches=read_launches(),
         tokens=out.tolist())


# gemma3-12b (arXiv:2503.19786) at full width and depth, dbrx-132b at full
# width and 4 of its 40 layers (40 take 264 GB in bf16), internvl2-2b
# at full width and depth; weights from SERVE_SEED
GEMMA_PROMPT_LEN = 256        # tokens per request (prefill by decode steps)
# one request at full depth (8 superblocks, 48 layers): the refresh's five
# Lloyd launches over 64 lanes (d = 256) on the tensor-core route, its
# blocks streaming their points (the SIMT route took 10.1 s a launch
# there, PERF.md §6); section 12 reads their device times
GEMMA_REQUESTS = 1
GEMMA_SERVE_SUPERBLOCKS = 8
# the refresh's share of the request's wall it must stay under (on the
# SIMT route it took 17.0 of 20.38 s on one superblock, PERF.md §5)
GEMMA_REFRESH_SHARE = 0.05
GEMMA_FORWARD_LEN = 4096      # the timed forward's tokens (B = 1)
GEMMA_PARITY_LEN = 64         # forward against decode, every position
GEMMA_PARITY_WINDOW = 48      # < GEMMA_PARITY_LEN: the local rings wrap
# forward against decode in bf16 at full depth: each position's largest
# logit difference over its largest logit (the two round their bf16
# products in different GEMMs, and 48 layers carry the rounding)
# (about 13 units of bf16's 2^-8: the sound run reads at most 0.029 on the
# H100, the planted fault below 0.068-0.22 at every position from its
# wrap on)
GEMMA_FWD_DEC_REL = 0.05
# positions whose greedy token agrees (a guard against gross faults only:
# the planted fault still reads 0.953 against the sound run's 0.969)
GEMMA_FWD_DEC_TOP1 = 0.9
# the planted fault the check must catch: local layers that decode over a
# 47-key window against a forward over 48
GEMMA_FAULT_WINDOW = GEMMA_PARITY_WINDOW - 1
MOE_LAYERS = 4
MOE_FORWARD_LEN = 2048
VLM_TEXT_LEN = 1024           # text tokens after the 256 patches
VLM_PATCH_BATCH = 8           # the patch projection over "model"


@contextlib.contextmanager
def moe_drops():
    """Within ``with``: each MoE dispatch's entries and dropped entries
    (rank past the capacity), as (entries, dropped tensor) pairs."""
    from repro_torch.models import moe
    orig = moe._sorted_slots
    rows = []

    def recording(expert, e, c):
        order, slot = orig(expert, e, c)
        rows.append((expert.numel(), (slot == e * c).sum()))
        return order, slot

    moe._sorted_slots = recording
    try:
        yield rows
    finally:
        moe._sorted_slots = orig


def serve_gemma_long_500k():
    """gemma3-12b at full width with ``GEMMA_SERVE_SUPERBLOCKS`` of its 8
    superblocks (5 sliding-window layers + 1 global layer each), bf16
    from ``SERVE_SEED``, with the ``long_500k`` cache: the global layers'
    8192 centroids + 1024-slot window, the local layers' 1024-slot rings.
    ``GEMMA_REQUESTS`` request(s) of 256 + 32 tokens, a refresh every 256
    (the Lloyd kernel's tensor-core route at d = 256 over 64 lanes, one
    block a lane per 128 pool points)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import tiles
    from repro_torch.models import build_model

    cfg, shape = get_config("gemma3-12b"), SHAPES["long_500k"]
    cfg = dataclasses.replace(cfg, n_layers=GEMMA_SERVE_SUPERBLOCKS * (
        cfg.local_per_global + 1))
    init_s, model = timed_s(lambda: build_model(cfg).init_params(SERVE_SEED))
    check(model.embed.dtype == torch.bfloat16, "weights are not bf16")
    n_super = len(model.layers())
    check(n_super == GEMMA_SERVE_SUPERBLOCKS
          and len(model.attn_blocks()) == 6 * GEMMA_SERVE_SUPERBLOCKS,
          f"gemma3-12b built {n_super} superblocks")
    nc = shape.seq_len // shape.cluster_compression
    lanes = n_super * cfg.n_kv_heads
    route = tiles.lloyd_route(nc, cfg.dh)
    blocks = -(-(nc + shape.cluster_window) // tiles.TC_ROWS)
    check(route == "tc" and lanes == 64,
          f"the d = 256 refresh takes route {route} over {lanes} lanes, not "
          f"the tensor-core route's streamed blocks over 64")
    requests, answers, last, prompt = serve_requests(
        cfg, shape, model, GEMMA_PROMPT_LEN, GEN_TOKENS, GEMMA_REQUESTS,
        n_super)
    # the refresh's share of the request (the recompress timer: the Lloyd
    # launches, the value update and the cache's rebuild)
    for r in requests:
        r["refresh_share"] = sum(r["refresh_s"]) / r["total_s"]
    check(all(r["refresh_share"] < GEMMA_REFRESH_SHARE for r in requests),
          f"the refresh takes {[r['refresh_share'] for r in requests]} of "
          f"the request, not under {GEMMA_REFRESH_SHARE}")
    profile = decode_profile(model, shape)
    q = layer_query(model, model.layers()[0].glob, prompt[:, -1:],
                    GEMMA_PROMPT_LEN)
    parity = attn_parity("attn_served_gemma_global0", q, last["kc"][0],
                         last["vc"][0], last["counts"][0], cfg.dh ** -0.5)
    emit("serve_gemma_long_500k", arch=cfg.name, shape=shape.name,
         n_params=sum(p.numel() for p in model.parameters()),
         layers=dict(superblocks=n_super, of_superblocks=8,
                     local=cfg.local_per_global, window=cfg.window),
         n_centroids=nc, cluster_window=shape.cluster_window,
         prompt_len=GEMMA_PROMPT_LEN, gen_tokens=GEN_TOKENS,
         recompress_every=RECOMPRESS_EVERY,
         refresh_lloyd=dict(route=route, lanes=lanes, blocks_per_lane=blocks,
                            m=nc + shape.cluster_window, k=nc, d=cfg.dh),
         init_s=init_s, requests=requests, answer=answers[0][0].tolist(),
         decode_profile=profile, served_cache_parity=parity)
    return requests, parity


def gemma_forward():
    """The chunked forward of gemma3-12b at full width and depth:
    ``forward(last_only=True)`` over 4096 tokens (B = 1), timed; then, on a
    copy of the config with a 48-token window (the local rings wrap within
    64 tokens; the weights are the same draws), the forward's logits at
    every position of a 64-token prompt against token-by-token
    ``decode_step`` with the full cache, and the same check on a planted
    ring fault (local layers decoding over a 47-key window), which must
    fail it."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.device import derive_seed
    from repro_torch.models import build_model

    cfg = get_config("gemma3-12b")
    model = build_model(cfg).init_params(SERVE_SEED)
    g = torch.Generator(device="cuda").manual_seed(derive_seed(SERVE_SEED, 2))
    toks = torch.randint(0, cfg.vocab, (1, GEMMA_FORWARD_LEN), generator=g,
                         device="cuda")
    model.forward({"tokens": toks[:, :512]}, last_only=True)   # warm-up
    torch.cuda.reset_peak_memory_stats()
    fwd_s, (last, aux) = timed_s(
        lambda: model.forward({"tokens": toks}, last_only=True))
    check(last.shape == (1, 1, cfg.padded_vocab)
          and bool(torch.isfinite(last).all()) and float(aux) == 0.0,
          "bad forward logits")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del model
    torch.cuda.empty_cache()

    cfg48 = dataclasses.replace(cfg, window=GEMMA_PARITY_WINDOW)
    model = build_model(cfg48).init_params(SERVE_SEED)
    p = toks[:, :GEMMA_PARITY_LEN]
    fwd, _ = model.forward({"tokens": p})

    def against_forward(wrap: int) -> dict:
        """Token-by-token decode with the full cache against ``fwd``: each
        position's largest logit difference over its largest logit, and
        the share of positions whose greedy token agrees."""
        caches = model.init_caches(1, ShapeConfig(
            "gemma_parity", GEMMA_PARITY_LEN, 1, "decode"), "full")
        dec = torch.cat([model.decode_step(p[:, t:t + 1], caches, t)[0]
                         for t in range(GEMMA_PARITY_LEN)], 1)
        slot_pos = caches["super"]["local"]["slot_pos"]
        check(int(slot_pos.min()) == GEMMA_PARITY_LEN - wrap
              and int(slot_pos.max()) == GEMMA_PARITY_LEN - 1,
              "the local rings did not wrap")
        rel = ((dec - fwd).abs().amax(-1) / fwd.abs().amax(-1))[0].cpu()
        top1 = float((dec.argmax(-1) == fwd.argmax(-1)).float().mean())
        return dict(max_rel_before_wrap=float(rel[:wrap].max()),
                    max_rel_after_wrap=float(rel[wrap:].max()),
                    rel_by_position=[round(float(r), 6) for r in rel],
                    top1_agreement=top1)

    def passes(r: dict) -> bool:
        return (max(r["max_rel_before_wrap"], r["max_rel_after_wrap"])
                <= GEMMA_FWD_DEC_REL
                and r["top1_agreement"] >= GEMMA_FWD_DEC_TOP1)

    row = against_forward(GEMMA_PARITY_WINDOW)
    check(passes(row), f"gemma forward against decode: {row}")
    # the same check on a planted ring fault: the decode's local layers keep
    # one key fewer than the forward's, so from the wrap on each local
    # layer loses its oldest key; the check must fail on it
    for sb in model.layers():
        for blk in sb.local:
            blk.window = GEMMA_FAULT_WINDOW
    fault = against_forward(GEMMA_FAULT_WINDOW)
    check(not passes(fault),
          f"gemma forward against decode misses a lost ring key: {fault}")
    row["planted_fault"] = dict(window=GEMMA_FAULT_WINDOW, **fault)
    del model
    torch.cuda.empty_cache()
    emit("gemma_forward", arch=cfg.name, tokens=GEMMA_FORWARD_LEN,
         forward_s=fwd_s, tokens_per_s=GEMMA_FORWARD_LEN / fwd_s,
         peak_memory_gb=peak_gb, parity_window=GEMMA_PARITY_WINDOW,
         parity_len=GEMMA_PARITY_LEN, forward_vs_decode=row)
    return row


def serve_moe_long_500k():
    """dbrx-132b at full width with 4 of its 40 layers (16 experts, top 4),
    bf16 from ``SERVE_SEED``: one ``long_500k`` request of 256 + 32 tokens
    with a refresh every 256 (the cluster attention at 6 query heads a kv
    head; the refresh on the tensor-core route, 32 lanes), no decode
    entry dropped; then ``forward`` over 2048 tokens with the capacity
    drops counted."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.device import derive_seed
    from repro_torch.kernels import tiles
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=MOE_LAYERS)
    shape = SHAPES["long_500k"]
    init_s, model = timed_s(lambda: build_model(cfg).init_params(SERVE_SEED))
    nc = shape.seq_len // shape.cluster_compression
    check(tiles.lloyd_route(nc, cfg.dh) == "tc", "dbrx refresh route")
    with moe_drops() as decode_rows:
        requests, answers, last, _ = serve_requests(
            cfg, shape, model, GEMMA_PROMPT_LEN, GEN_TOKENS, 1, cfg.n_layers)
    decode_dropped = sum(int(n) for _, n in decode_rows)
    check(decode_dropped == 0, f"decode dropped {decode_dropped} entries")
    g = torch.Generator(device="cuda").manual_seed(derive_seed(SERVE_SEED, 3))
    toks = torch.randint(0, cfg.vocab, (1, MOE_FORWARD_LEN), generator=g,
                         device="cuda")
    model.forward({"tokens": toks[:, :256]}, last_only=True)    # warm-up
    with moe_drops() as rows:
        fwd_s, (logits, aux) = timed_s(
            lambda: model.forward({"tokens": toks}, last_only=True))
    check(len(rows) == cfg.n_layers and bool(torch.isfinite(logits).all())
          and np.isfinite(float(aux)) and float(aux) > 0,
          "bad MoE forward")
    drops = [dict(entries=n, dropped=int(d)) for n, d in rows]
    emit("serve_moe_long_500k", arch=cfg.name, n_layers=cfg.n_layers,
         n_params=sum(p.numel() for p in model.parameters()),
         experts=cfg.n_experts, top_k=cfg.experts_per_token,
         init_s=init_s, requests=requests, answer=answers[0][0].tolist(),
         decode_dropped=decode_dropped, forward_tokens=MOE_FORWARD_LEN,
         forward_s=fwd_s, forward_tokens_per_s=MOE_FORWARD_LEN / fwd_s,
         aux=float(aux), forward_drops=drops,
         dropped_share=sum(r["dropped"] for r in drops)
         / sum(r["entries"] for r in drops))
    return requests


def vlm_forward():
    """internvl2-2b at full width and depth, bf16 from ``SERVE_SEED``:
    ``forward`` and ``loss`` over 256 patch embeddings and 1024 text
    tokens (B = 2); the loss reads the text positions only."""
    from repro_torch.configs import get_config
    from repro_torch.core.device import derive_seed
    from repro_torch.models import build_model
    from repro_torch.models.layers import cross_entropy

    cfg = get_config("internvl2-2b")
    model = build_model(cfg).init_params(SERVE_SEED)
    g = torch.Generator(device="cuda").manual_seed(derive_seed(SERVE_SEED, 4))
    batch = {
        "tokens": torch.randint(0, cfg.vocab, (2, VLM_TEXT_LEN), generator=g,
                                device="cuda"),
        "labels": torch.randint(0, cfg.vocab, (2, VLM_TEXT_LEN), generator=g,
                                device="cuda"),
        "patches": torch.randn((2, cfg.n_patches, cfg.d_model), generator=g,
                               device="cuda").bfloat16()}
    model.forward(batch)                                         # warm-up
    fwd_s, (logits, aux) = timed_s(lambda: model.forward(batch))
    loss_s, loss = timed_s(lambda: model.loss(batch))
    text = cross_entropy(logits[:, cfg.n_patches:], batch["labels"])
    s_all = cfg.n_patches + VLM_TEXT_LEN
    check(logits.shape == (2, s_all, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()) and float(aux) == 0.0,
          "bad VLM logits")
    check(abs(float(loss) - float(text)) <= 1e-4 * abs(float(text)),
          f"the loss {float(loss)} is not the text positions' "
          f"{float(text)}")
    patch_proj = vlm_patch_proj_over_model(model, g)
    emit("vlm_forward", arch=cfg.name,
         n_params=sum(p.numel() for p in model.parameters()),
         patches=cfg.n_patches, text_tokens=VLM_TEXT_LEN, batch=2,
         forward_s=fwd_s, tokens_per_s=2 * s_all / fwd_s, loss_s=loss_s,
         loss=float(loss), log_vocab=float(np.log(cfg.vocab)),
         patch_proj_over_model=patch_proj)


def vlm_patch_proj_over_model(model, g) -> dict:
    """internvl2-2b's patch embedding (``VLM_PATCH_BATCH`` x 256 patches,
    d 2048, bf16) through ``embed_in`` with a 2-position ``ModelSplit`` on
    the card (each position projects by its 1024 columns of
    ``patch_proj``, the train step's regions), against ``embed_in``
    whole: bit equality and the largest difference in bf16 ulps, held
    within one ulp."""
    from repro_torch.core.model_axis import ModelSplit
    cfg = model.cfg
    batch = {"tokens": torch.randint(0, cfg.vocab, (VLM_PATCH_BATCH, 16),
                                     generator=g, device="cuda"),
             "patches": torch.randn((VLM_PATCH_BATCH, cfg.n_patches,
                                     cfg.d_model), generator=g,
                                    device="cuda").bfloat16()}
    regions = model.split_regions(2)["patch_proj"]
    split = ModelSplit(["cuda:0"] * 2, {model: [
        {"patch_proj": model.patch_proj[r].contiguous()} for r in regions]})
    with torch.no_grad():
        whole = model.embed_in(batch)
        over = model.embed_in(batch, {"model_split": split})
    out = dict(batch=VLM_PATCH_BATCH, columns_a_position=[
        r[1].stop - r[1].start for r in regions],
               bits_equal=bits_equal(over, whole),
               max_ulp=ulp_gap(over, whole),
               concat_model_calls=split.counts["concat_model_calls"])
    check(out["max_ulp"] <= 1.0 and out["concat_model_calls"] == 1,
          f"VLM patch_proj over 'model' against whole: {out}")
    return out


# zamba2-2.7b (arXiv:2411.15242) at full width and depth and xlstm-1.3b
# (arXiv:2405.04517) at full width with XLSTM_SERVE_SUPERBLOCKS of its 6
# superblocks (cut for the script's time: at 6 its request and forward
# took 35.1 s on the H100), weights from SERVE_SEED: one long_500k request
# each, zamba2's shared attention on the clustered cache (dh = 80, one
# query head a kv head), xlstm on its O(1) recurrent state
XLSTM_SERVE_SUPERBLOCKS = 1
SSM_PROMPT_LEN = 256          # tokens per request (prefill by decode steps)
SSM_FORWARD_LEN = 2048        # the timed forward's tokens (B = 1)
SSM_PARITY_LEN = 64           # forward against decode, every position
SSM_PARITY_CHUNK = 16         # the parity forward's recurrence chunk (4)
# forward against decode, each position's largest logit difference over
# its largest logit, gated in f32 (the same draws from SERVE_SEED,
# unrounded): on the H100 at full depth the sound runs read at most
# 5.6e-4 (xlstm) and 4.0e-6 (zamba2), the planted faults 0.51-1.29 at
# every position after the first.  In bf16 the check cannot gate xlstm:
# its forward and decode round their bf16 products differently (a 64-row
# GEMM against a one-row GEMV), and its blocks carry the difference on
# (``divergence_by_block``: at position 0 the residual parts by 0.16%
# after its first block, 24% after its 48th; zamba2's stays near 1.5%),
# so xlstm reads 0.24-0.64 at every position.  The served model's bf16
# reading is reported beside the gate
SSM_FWD_DEC_REL = 0.01
SSM_FWD_DEC_TOP1 = 0.9


def serve_zamba_long_500k():
    """zamba2-2.7b at full width and depth (6 superblocks of 9 Mamba2
    layers + the shared attention block), bf16 from ``SERVE_SEED``, with the
    ``long_500k`` cache: the shared attention's 8192 centroids + 1024-slot
    window in each superblock (dh = 80), the Mamba2 states beside them.
    One request of 256 + 32 tokens, a refresh at 256 (the Lloyd kernel's
    tensor-core route at d = 80 over 192 lanes).  -> (requests, the served
    cache's parity, the model)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import tiles
    from repro_torch.models import build_model

    cfg, shape = get_config("zamba2-2.7b"), SHAPES["long_500k"]
    init_s, model = timed_s(lambda: build_model(cfg).init_params(SERVE_SEED))
    check(model.embed.dtype == torch.bfloat16, "weights are not bf16")
    n_super = len(model.layers())
    check(n_super == 6 and all(len(sb.mamba) == 9 and sb.shared is
                               model.shared for sb in model.layers()),
          f"zamba2-2.7b built {n_super} superblocks")
    nc = shape.seq_len // shape.cluster_compression
    lanes = n_super * cfg.n_kv_heads
    route = tiles.lloyd_route(nc, cfg.dh)
    check(route == "tc" and tiles.tc_dims(cfg.dh) == 96
          and tiles.tc_smem_bytes(96) <= tiles.MAX_SMEM_BYTES,
          f"the d = 80 refresh takes route {route}, not the tensor cores")
    requests, answers, last, prompt = serve_requests(
        cfg, shape, model, SSM_PROMPT_LEN, GEN_TOKENS, 1, n_super)
    profile = decode_profile(model, shape)
    cache = model.init_caches(1, shape, "clustered")["super"]
    q = layer_query(model, model.shared, prompt[:, -1:], SSM_PROMPT_LEN)
    parity = attn_parity("attn_served_zamba_attn0", q, last["kc"][0],
                         last["vc"][0], last["counts"][0], cfg.dh ** -0.5)
    emit("serve_zamba_long_500k", arch=cfg.name, shape=shape.name,
         n_params=sum(p.numel() for p in model.parameters()),
         layers=dict(superblocks=n_super, mamba=cfg.mamba_per_attn,
                     shared_attn=1),
         n_centroids=nc, cluster_window=shape.cluster_window,
         cache_gb={g: sum(t.numel() * t.element_size()
                          for t in cache[g].values()) / 1e9
                   for g in ("attn", "mamba")},
         prompt_len=SSM_PROMPT_LEN, gen_tokens=GEN_TOKENS,
         recompress_every=RECOMPRESS_EVERY,
         refresh_lloyd=dict(route=route, lanes=lanes,
                            m=nc + shape.cluster_window, k=nc, d=cfg.dh),
         init_s=init_s, requests=requests, answer=answers[0][0].tolist(),
         decode_profile=profile, served_cache_parity=parity)
    del cache
    return requests, parity, model


def serve_xlstm_long_500k():
    """xlstm-1.3b at full width with ``XLSTM_SERVE_SUPERBLOCKS`` of its 6
    superblocks (7 mLSTM + 1 sLSTM blocks each), bf16 from
    ``SERVE_SEED``, at ``long_500k`` on its O(1) recurrent state (no
    attention cache, no refresh): one request of 256 + 32 tokens.  ->
    (requests, the model)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models import build_model, cache_kind

    cfg, shape = get_config("xlstm-1.3b"), SHAPES["long_500k"]
    check(cache_kind(cfg, shape) == "full", "xlstm's cache kind")
    cfg = dataclasses.replace(cfg, n_layers=XLSTM_SERVE_SUPERBLOCKS * (
        cfg.mlstm_per_slstm + 1))
    init_s, model = timed_s(lambda: build_model(cfg).init_params(SERVE_SEED))
    check(model.embed.dtype == torch.bfloat16, "weights are not bf16")
    n_super = len(model.layers())
    check(n_super == XLSTM_SERVE_SUPERBLOCKS
          and all(len(sb.mlstm) == 7 for sb in model.layers()),
          f"xlstm-1.3b built {n_super} superblocks")
    requests, answers, _, _ = serve_requests(
        cfg, shape, model, SSM_PROMPT_LEN, GEN_TOKENS, 1, 0)
    profile = decode_profile(model, shape, kind="full")
    cache = model.init_caches(1, shape, "full")["super"]
    emit("serve_xlstm_long_500k", arch=cfg.name, shape=shape.name,
         n_params=sum(p.numel() for p in model.parameters()),
         layers=dict(superblocks=n_super, of_superblocks=6,
                     mlstm=cfg.mlstm_per_slstm, slstm=1),
         state_gb={g: sum(t.numel() * t.element_size()
                          for t in cache[g].values()) / 1e9
                   for g in ("mlstm", "slstm")},
         prompt_len=SSM_PROMPT_LEN, gen_tokens=GEN_TOKENS, init_s=init_s,
         requests=requests, answer=answers[0][0].tolist(),
         decode_profile=profile)
    del cache
    return requests, model


@contextlib.contextmanager
def planted_fault(model):
    """Within ``with``: a fault in the recurrent decode that the forward
    against decode check must catch.  zamba2: every Mamba2 layer's conv
    history is never shifted (each step convolves the token with zeros, as
    if the history were lost); xlstm: every sLSTM layer's carry (c, n, h)
    is reset before each step."""
    blocks = []
    for sb in model.layers():
        if hasattr(sb, "mamba"):
            blocks += list(sb.mamba)
        else:
            blocks.append(sb.slstm)

    def faulty(blk):
        orig = blk.decode

        def decode(cache_l, x, ctx):
            if "conv" in cache_l:
                held = cache_l["conv"].clone()
                out = orig(cache_l, x, ctx)
                cache_l["conv"].copy_(held)
                return out
            for t in cache_l.values():
                t.zero_()
            return orig(cache_l, x, ctx)
        return decode

    for blk in blocks:
        blk.decode = faulty(blk)
    try:
        yield
    finally:
        for blk in blocks:
            del blk.decode


def ssm_forward(model) -> dict:
    """The chunked forward of a recurrent model at full width (at the
    depth it was served with):
    ``forward(last_only=True)`` over 2048 tokens (B = 1), timed, with its
    peak memory; then the forward's logits at every position of a
    64-token prompt (the recurrence in 4 chunks) against token-by-token
    ``decode_step`` with the full cache: on the served bf16 model
    (reported), and gated on an f32 copy (the same draws), sound and with
    a planted fault (:func:`planted_fault`), which must fail it."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.device import derive_seed
    from repro_torch.models import build_model

    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(derive_seed(SERVE_SEED, 5))
    toks = torch.randint(0, cfg.vocab, (1, SSM_FORWARD_LEN), generator=g,
                         device="cuda")
    model.forward({"tokens": toks[:, :256]}, last_only=True)   # warm-up
    torch.cuda.reset_peak_memory_stats()
    fwd_s, (last, aux) = timed_s(
        lambda: model.forward({"tokens": toks}, last_only=True))
    check(last.shape == (1, 1, cfg.padded_vocab)
          and bool(torch.isfinite(last).all()) and float(aux) == 0.0,
          f"{cfg.name}: bad forward logits")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    p = toks[:, :SSM_PARITY_LEN]
    ctx = dict(model.make_ctx(torch.arange(SSM_PARITY_LEN, device="cuda")),
               ssm_chunk=SSM_PARITY_CHUNK)

    def against_forward(m) -> dict:
        fwd, _ = m.forward({"tokens": p}, ctx)
        caches = m.init_caches(1, ShapeConfig(
            "ssm_parity", SSM_PARITY_LEN, 1, "decode"), "full")
        dec = torch.cat([m.decode_step(p[:, t:t + 1], caches, t)[0]
                         for t in range(SSM_PARITY_LEN)], 1)
        rel = ((dec - fwd).abs().amax(-1) / fwd.abs().amax(-1))[0].cpu()
        top1 = float((dec.argmax(-1) == fwd.argmax(-1)).float().mean())
        return dict(max_rel=float(rel.max()),
                    rel_by_position=[round(float(r), 6) for r in rel],
                    top1_agreement=top1)

    def passes(r: dict) -> bool:
        return (r["max_rel"] <= SSM_FWD_DEC_REL
                and r["top1_agreement"] >= SSM_FWD_DEC_TOP1)

    served = against_forward(model)
    served["pos0_rel_by_block"] = divergence_by_block(model, p, ctx)
    f32 = build_model(dataclasses.replace(cfg, dtype="float32")
                      ).init_params(SERVE_SEED)
    row = against_forward(f32)
    check(passes(row), f"{cfg.name} forward against decode (f32): {row}")
    with planted_fault(f32):
        fault = against_forward(f32)
    check(not passes(fault),
          f"{cfg.name} forward against decode misses a planted fault: "
          f"{fault}")
    del f32
    torch.cuda.empty_cache()
    row["planted_fault"] = fault
    emit("ssm_forward", arch=cfg.name, tokens=SSM_FORWARD_LEN,
         forward_s=fwd_s, tokens_per_s=SSM_FORWARD_LEN / fwd_s,
         peak_memory_gb=peak_gb, parity_len=SSM_PARITY_LEN,
         parity_chunk=SSM_PARITY_CHUNK, limit=SSM_FWD_DEC_REL,
         forward_vs_decode_f32=row, forward_vs_decode_bf16={
             n: served[n] for n in ("max_rel", "top1_agreement",
                                    "pos0_rel_by_block")})
    return row


def divergence_by_block(model, p, ctx) -> list:
    """Where the forward and the decode part at position 0: after each
    recurrent block (and zamba2's shared block), the largest difference of
    the residual stream over its largest value, between the block's
    forward over the prompt ``p`` and its decode of ``p``'s first token."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.models.lm import _index
    x = model.embed[p.long()]
    xd = x[:, :1].clone()
    caches = model.init_caches(1, ShapeConfig(
        "ssm_parity", p.shape[1], 1, "decode"), "full")["super"]
    dctx = model.make_ctx(torch.zeros(1, device="cuda"), pos=0)
    aux = torch.zeros((), device="cuda")
    rel = []
    with torch.no_grad():
        for i, sb in enumerate(model.layers()):
            c = _index(caches, i)
            if hasattr(sb, "mlstm"):
                steps = [(b.forward, b.decode, _index(c["mlstm"], j))
                         for j, b in enumerate(sb.mlstm)]
                steps.append((sb.slstm.forward, sb.slstm.decode, c["slstm"]))
            else:
                steps = [(b.forward, b.decode, _index(c["mamba"], j))
                         for j, b in enumerate(sb.mamba)]
                steps.append((lambda x_, ctx_: sb.shared(x_, aux, ctx_)[0],
                              sb.shared.decode, c["attn"]))
            for fwd, dec, cache in steps:
                x = fwd(x, ctx)
                xd, _ = dec(cache, xd, dctx)
                rel.append(round(float((x[:, 0] - xd[:, 0]).abs().max()
                                       / x[:, 0].abs().max()), 6))
    return rel


# llama3-8b at full width (d 4096, 32 heads / 8 kv, dh 128, d_ff 14336,
# vocab 128256) with 2 of its 32 layers: 1.487 B parameters, of which the
# embedding and the head are 1.05 B; bf16 weights from seed 0, AdamW with
# f32 master weights (the reference's plan below 3e10 parameters).  The
# depth is cut for the checkpoint's bytes: 20.8 GB at 2 layers.
TRAIN_LAYERS = 2
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO = 512, 8, 2
TRAIN_STEPS = 2
COMPRESS_LEVELS = 16


def host_available_gb() -> float:
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def on_card(t) -> torch.Tensor:
    """A tensor, or a sharded leaf gathered whole on its first device (a
    leaf of one block there is read in place)."""
    from repro_torch.core.blocks import Sharded, gather
    return gather(t, t.device) if isinstance(t, Sharded) else t


def host_copy(t) -> torch.Tensor:
    """A host copy of a tensor, or of a sharded leaf gathered whole."""
    return on_card(t).to("cpu", copy=True)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same dtype, shape and bit pattern (NaNs and signed zeros too)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (t.view(ints[t.element_size()]) for t in (a, b))
    return torch.equal(a, b)


def trees_bits_equal(a, b) -> list:
    """The keys at which two trees of tensors differ (compared on ``a``'s
    devices)."""
    from repro_torch import tree
    fa = {tree.key_of(p): t for p, t in tree.items(a)}
    fb = {tree.key_of(p): t for p, t in tree.items(b)}
    if fa.keys() != fb.keys():
        return sorted(fa.keys() ^ fb.keys())
    out = []
    for k in fa:
        a = on_card(fa[k])
        if not bits_equal(a, on_card(fb[k]).to(a.device)):
            out.append(k)
    return out


def train_llama3_8b():
    """The training path at full width (``TRAIN_LAYERS`` of llama3-8b's
    layers): ``Trainer(steps=2, ckpt_every=2)`` (its state in the blocks
    of a 1 x 1 mesh: one block a leaf) over ``token_stream``
    batches of 8 x 512 (``TrainPlan(n_micro=2, q_chunk=512, remat=True)``)
    into a directory under ``build/``, which writes one checkpoint; a
    second ``Trainer`` on it restores, bit for bit the first run's final
    state (the two 20.8 GB states side by side on the card); one step from
    the in-memory state, its loss and parameters kept on the host and the
    state freed, then one from the restored state agree bit for bit (a
    step with its gradients beside two states would pass 60 GB); the
    embedding moves only by weight decay (the hoisted gather gives it no
    gradient, as in the reference); then one step with the gradient
    compressor hooked in, whose 1-D fits launch the Lloyd kernel
    ``max_iters + 1`` times a leaf.  -> (the emitted fields, the head
    gradient's 4096-value sample as (1, 4096, 1))."""
    import dataclasses
    import gc
    import shutil
    from repro_torch import tree
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.blocks import is_sharded
    from repro_torch.data import token_stream
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamW
    from repro_torch.train.compress import SAMPLE, make_grad_compressor
    from repro_torch.train.step import TrainPlan, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=TRAIN_LAYERS)
    shape = ShapeConfig("train_8x512", TRAIN_SEQ, TRAIN_BATCH, "train")
    plan = TrainPlan(n_micro=TRAIN_MICRO, q_chunk=512, remat=True)
    work = ROOT / "build" / "train_llama3_8b"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    tc = TrainerConfig(steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS,
                       ckpt_dir=str(work), log_every=1, seed=0)
    io = dict(save_s=[], restore_s=[])
    real_save, real_restore = ckpt.save, ckpt.restore

    def save(*a, **k):
        io["free_disk_gb_before_write"] = shutil.disk_usage(work).free / 1e9
        io["host_available_gb_before_write"] = host_available_gb()
        sec, out = timed_s(lambda: real_save(*a, **k))
        io["save_s"].append(sec)
        io["bytes"] = (out / "arrays.npz").stat().st_size
        return out

    def restore(*a, **k):
        sec, out = timed_s(lambda: real_restore(*a, **k))
        io["restore_s"].append(sec)
        return out

    ckpt.save, ckpt.restore = save, restore
    try:
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(cfg, shape, make_host_mesh(1, 1), tc, plan=plan)
        opt = trainer.optimizer
        check(isinstance(opt, AdamW) and opt.master_weights
              and not callable(opt.lr), "train: not AdamW with master "
              "weights at a constant lr")
        walls, first = [], {}
        train_step = trainer.train_step

        def recording(state, batch):    # the initial embedding, step walls
            if not first:
                first["embed"] = host_copy(state["params"]["embed"])
                first["sharded"] = is_sharded(state["params"])
            sec, out = timed_s(lambda: train_step(state, batch))
            walls.append(sec)
            return out

        trainer.train_step = recording
        run_s, (state, hist) = timed_s(trainer.run)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(len(hist) == TRAIN_STEPS and all(np.isfinite(hist)),
              f"train: losses {hist}")
        check(ckpt.steps(work) == [TRAIN_STEPS], f"train: checkpoints "
              f"{ckpt.steps(work)}")
        params = state["params"]
        n_params = sum(t.numel() for t in tree.leaves(params))
        state_gb = sum(t.numel() * t.element_size()
                       for t in tree.leaves(state)) / 1e9
        # the hoisted embedding: zero moments, the master weights moved by
        # weight decay alone, step by step as the optimizer computes it
        m = first.pop("embed").cuda().float()
        for _ in range(TRAIN_STEPS):
            m = m - opt.lr * (0.0 + opt.weight_decay * m)
        embed = {k: on_card(tree.get(state, ("opt", k, "embed")))
                 for k in ("m", "v", "master")}
        embed_ok = (first["sharded"] and not embed["m"].any()
                    and not embed["v"].any()
                    and bits_equal(embed["master"], m)
                    and bits_equal(on_card(params["embed"]),
                                   m.to(params["embed"].dtype)))
        del embed
        check(embed_ok, "train: the embedding moved by more than its decay")
        del m
        resumed = Trainer(cfg, shape, make_host_mesh(1, 1), tc, plan=plan)
        restored, start = resumed.restore_or_init()
        check(start == TRAIN_STEPS, f"train: restored step {start}")
        differ = trees_bits_equal(restored, state)
        check(not differ, f"train: the restored state differs at {differ}")
        batch = token_stream(TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab,
                             seed=tc.seed)
        (state, met), prof = profiled_once(lambda: train_step(state, batch))
        # the idle share of the unprofiled step (the run's last, same shape)
        prof["idle_share"] = max(0.0, 1.0 - prof["device_busy_s"] / walls[-1])
        loss_mem = float(met["loss"])
        params_mem = tree.map_(host_copy, state["params"])
        del state, params, met, trainer, train_step, recording
        gc.collect()
        torch.cuda.empty_cache()

        state, met = resumed.train_step(restored, batch)
        del restored
        loss_res = float(met["loss"])
        differ = trees_bits_equal(state["params"], params_mem)
        check(loss_res == loss_mem and not differ,
              f"train: the step from the restored state gave loss "
              f"{loss_res} against {loss_mem}, parameters differ at {differ}")
        del params_mem

        # one step with the gradient compressor hooked in
        comp = make_grad_compressor(levels=COMPRESS_LEVELS)
        seen = {}

        def compress(grads):
            flat = grads["head"].reshape(-1, 1).float()
            seen["sample"] = flat[::max(1, flat.shape[0] // SAMPLE)][
                :SAMPLE].clone()[None]
            seen["leaves"] = len(tree.leaves(grads))
            seen["compress_s"], out = timed_s(lambda: comp(grads)[0])
            return out

        cstep = make_train_step(resumed.model, resumed.optimizer, cfg, shape,
                                plan, compress_fn=compress)
        batch = token_stream(TRAIN_STEPS + 1, TRAIN_BATCH, TRAIN_SEQ,
                             cfg.vocab, seed=tc.seed)
        reset_launches()
        step_s, (state, met) = timed_s(lambda: cstep(state, batch))
        launches = read_launches()
        want = seen["leaves"] * (8 + 1)     # max_iters + the final pass
        check(seen["leaves"] == 12 and launches["lloyd_step"] == want
              and sum(launches.values()) == want,
              f"train: compressor launches {launches}, want {want} Lloyd "
              f"launches over {seen['leaves']} leaves")
        check(np.isfinite(float(met["loss"])), "train: compressed step loss")
        fields = dict(
            arch=cfg.name, layers=TRAIN_LAYERS, of_layers=32,
            n_params=n_params, state_gb=state_gb, plan=dataclasses.asdict(
                plan), optimizer=dict(name="adamw", master_weights=True,
                                      lr=opt.lr,
                                      weight_decay=opt.weight_decay),
            batch=[TRAIN_BATCH, TRAIN_SEQ], losses=hist, run_s=run_s,
            step_wall_s=walls, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ
            / walls[-1], step_profile=prof, peak_gb=peak_gb,
            checkpoint=io,
            restored_bitwise=True, resumed_step=dict(
                loss=loss_res, in_memory_loss=loss_mem,
                params_bitwise=True),
            embed_decay_only=embed_ok,
            compressed_step=dict(step_s=step_s,
                                 compress_s=seen["compress_s"],
                                 leaves=seen["leaves"],
                                 loss=float(met["loss"]),
                                 launches=launches))
        emit("train_llama3_8b", **fields)
        del state, met, resumed, cstep
        gc.collect()
        torch.cuda.empty_cache()
        return fields, seen["sample"]
    finally:
        ckpt.save, ckpt.restore = real_save, real_restore
        shutil.rmtree(work, ignore_errors=True)


def train_launcher():
    """``python -m repro_torch.launch.train --arch llama3-8b --reduced
    --steps 4 --ckpt-dir D``, then ``python -m repro_torch.launch.serve
    --arch llama3-8b --reduced --ckpt-dir D --prompt-len 16 --gen 4
    --batch 2``, both in this process on the card; the served parameters
    are bit for bit the checkpoint's."""
    import shutil
    from repro_torch import tree
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.convert import lm_params_to_stacked
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main

    work = ROOT / "build" / "train_launcher"
    shutil.rmtree(work, ignore_errors=True)
    train_argv = ["--arch", "llama3-8b", "--reduced", "--steps", "4",
                  "--ckpt-dir", str(work)]
    serve_argv = ["--arch", "llama3-8b", "--reduced", "--ckpt-dir",
                  str(work), "--prompt-len", "16", "--gen", "4", "--batch",
                  "2"]
    try:
        train_s, (_, hist) = timed_s(lambda: train_main(train_argv))
        check(len(hist) == 4 and all(np.isfinite(hist))
              and ckpt.steps(work) == [4], f"train launcher: {hist}, "
              f"checkpoints {ckpt.steps(work)}")
        reset_launches()
        serve_s, (out, model) = timed_s(lambda: serve_main(serve_argv))
        served = lm_params_to_stacked({n: p.detach() for n, p in
                                       model.named_parameters()})
        with np.load(work / "step_00000004" / "arrays.npz") as data:
            differ = [tree.key_of(p) for p, t in tree.items(served)
                      if not bits_equal(t.cpu(), ckpt.from_numpy(
                          data["params/" + tree.key_of(p)]))]
        check(not differ, f"served parameters differ from the checkpoint's "
              f"at {differ}")
        check(tuple(out.shape) == (2, 4), f"served {tuple(out.shape)}")
        emit("train_launcher", train_argv=" ".join(train_argv[:-1]) + " D",
             serve_argv=" ".join(serve_argv[:4] + ["D"] + serve_argv[5:]),
             train_s=train_s, losses=hist, serve_s=serve_s,
             served_bitwise=True, tokens=out.tolist(),
             launches=read_launches())
    finally:
        shutil.rmtree(work, ignore_errors=True)


def whole_train_state(cfg, opt):
    """(the model on the card bound to it, the one-device train state):
    the seed-0 weights as the stacked tree of whole tensors, the
    optimizer's initial state, step 0."""
    from repro_torch.convert import stacked_params
    from repro_torch.models.registry import build_model
    model = build_model(cfg, device="cuda").init_params(0)
    params = stacked_params(model)
    return model, {"params": params, "opt": opt.init(params),
                   "step": torch.zeros((), dtype=torch.int32,
                                       device="cuda")}


def train_one_device():
    """The one-device step on a state of whole tensors at
    ``train_llama3_8b``'s configuration (llama3-8b at full width with
    ``TRAIN_LAYERS`` layers, bf16 from seed 0, AdamW with f32 master
    weights, 8 x 512 tokens, ``TrainPlan(n_micro=2, q_chunk=512)``):
    ``make_train_step`` without a mesh, one step from the seed-0 state,
    its loss, norm and state kept on the host and the state freed.  No
    checkpoint is written.  -> (the emitted fields, the loss, norm, lr
    and host state that :func:`train_sharded` is held against)."""
    import gc
    from repro_torch import tree
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import token_stream
    from repro_torch.optim import AdamW
    from repro_torch.train.step import TrainPlan, make_train_step

    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=TRAIN_LAYERS)
    shape = ShapeConfig("train_8x512", TRAIN_SEQ, TRAIN_BATCH, "train")
    plan = TrainPlan(n_micro=TRAIN_MICRO, q_chunk=512, remat=True)
    batch = token_stream(0, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab, seed=0)

    opt = AdamW(master_weights=True)       # the trainer's, below 3e10
    model, state = whole_train_state(cfg, opt)
    one = make_train_step(model, opt, cfg, shape, plan)
    torch.cuda.reset_peak_memory_stats()
    step_s, (state, met) = timed_s(lambda: one(state, batch))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(np.isfinite(float(met["loss"])), "one device: loss")
    baseline = dict(loss=met["loss"].cpu(), grad_norm=met["grad_norm"].cpu(),
                    lr=opt.lr, state=tree.map_(host_copy, state))
    fields = dict(
        arch=cfg.name, layers=TRAIN_LAYERS, of_layers=32,
        plan=dataclasses.asdict(plan), batch=[TRAIN_BATCH, TRAIN_SEQ],
        loss=float(baseline["loss"]),
        grad_norm=float(baseline["grad_norm"]), step_wall_s=step_s,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s, peak_gb=peak_gb)
    emit("train_one_device", **fields)
    del state, met, model, one
    gc.collect()
    torch.cuda.empty_cache()
    return fields, baseline


# the sharded step against the one-device step.  Where the mesh's "model"
# axis is 1 (2 x 1, 2 x 2 x 1, the Trainer's 1 x 1) the step is the
# one-device step bit for bit (tests/test_torch_train_sharded.py).  Here
# "model" is 2: attention, the dense FFN and the head are computed over
# it, and the row-parallel adds (the f32 partials of wo, w2 and the
# vocab-parallel loss's sums) reorder the sums, as the reference's GSPMD
# step does.  So the rule is: the loss at rtol 1e-3; grad_norm at rtol
# 1e-2; each leaf's AdamW first moment (the step's gradient times
# 1 - beta1) within a relative Frobenius error of 1e-2; every parameter
# within 2 lr plus one ulp of its one-device value (AdamW's first step
# moves an entry by about lr at most)
SHARDED_MESH = (2, 2)
SHARDED_LOSS_RTOL, SHARDED_NORM_RTOL = 1e-3, 1e-2
SHARDED_MOMENT_REL = 1e-2


def sharded_vs_one_device(state, kept, lr: float,
                          moment_rel: float = SHARDED_MOMENT_REL,
                          param_lr: float = 2.0) -> dict:
    """Each leaf of the sharded ``state``, gathered on the card, against
    ``kept`` (the host copy of the one-device step's): each moment's
    relative Frobenius error (AdamW's first moments ``m``; Adafactor's
    second moments ``fac``: ``vr``, ``vc``, ``v``), the largest and its
    leaf, the largest parameter difference in units of lr and its leaf,
    and the keys of the leaves outside the rule (the moments within
    ``moment_rel``, the parameters within ``param_lr`` lr plus one
    ulp)."""
    from repro_torch import tree
    group = "m" if "m" in kept["opt"] else "fac"
    out = dict(moment_rel_err=0.0, moment_leaf=None, param_err_lr=0.0,
               param_leaf=None, moment_rel_errs={}, outside=[])
    for path, s in tree.items(state["opt"][group]):
        a = on_card(s).float()
        b = tree.get(kept["opt"][group], path).to(a.device).float()
        rel = float((a - b).norm()) / max(float(b.norm()), 1e-30)
        key = tree.key_of(path)
        out["moment_rel_errs"][key] = rel
        if rel > out["moment_rel_err"]:
            out.update(moment_rel_err=rel, moment_leaf=key)
        if not rel <= moment_rel:
            out["outside"].append(f"opt/{group}/{key}")
        del a, b
    for path, s in tree.items(state["params"]):
        a = on_card(s)
        b = tree.get(kept["params"], path).to(a.device)
        big = torch.maximum(a.abs(), b.abs())   # one ulp at the larger
        ulp = torch.nextafter(big, torch.full_like(big, float("inf"))
                              ).float() - big.float()
        diff = (a.float() - b.float()).abs()
        err = float(diff.max()) / lr
        if err > out["param_err_lr"]:
            out.update(param_err_lr=err, param_leaf=tree.key_of(path))
        if not bool((diff <= param_lr * lr + ulp).all()):
            out["outside"].append("params/" + tree.key_of(path))
        del a, b, big, ulp, diff
    return out


def position_blocks(cfg, n_model: int) -> tuple[int, int]:
    """(the bytes of one llama layer's column and row blocks a "model"
    position computes with, those of its vocab block of the head): wq, wo
    h dh / M, wk, wv the kv heads of its h / M query heads, w1, w3, w2
    d_ff / M, in bf16."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    hm = h // n_model
    kvm = max(1, hm * kv // h)
    layer = 2 * d * hm * dh + 2 * d * kvm * dh + 3 * d * cfg.d_ff // n_model
    return 2 * layer, 2 * d * cfg.padded_vocab // n_model


def train_sharded(baseline: dict):
    """The sharded trainer at ``train_llama3_8b``'s configuration on
    ``make_host_mesh(2, 2, device="cuda")``: ``cuda:0`` four times, so
    each position's blocks of the parameters, the gradient accumulator
    and the optimizer state are held once on the one card (no device
    holds less here; the 1/W saving shows only in the byte counts).
    Each data shard computes attention, the FFN and the head over its two
    "model" positions.  ``Trainer.init_state`` from seed 0 a leaf at a
    time; one step on the one-device step's batch, held against
    ``baseline`` (from :func:`train_one_device`) under the rule above
    ``SHARDED_MESH``; each position's bytes against
    ``sharding.shard_bytes``; each position's gathers (its column and row
    blocks of a layer, its vocab block of the head,
    :func:`position_blocks`), wall and peak; a warm step's wall and a
    profiled repeat (the idle share is the warm step's); then one
    compressed sharded step (the hook once, on the gradient gathered
    whole: 12 x 9 Lloyd launches).  No checkpoint.  -> (the emitted
    fields, the compressed step's head-gradient sample as (1, 4096,
    1))."""
    import gc
    from repro_torch import tree
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import token_stream
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamW
    from repro_torch.train import sharding as sh
    from repro_torch.train.compress import SAMPLE, make_grad_compressor
    from repro_torch.train.step import TrainPlan, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=TRAIN_LAYERS)
    shape = ShapeConfig("train_8x512", TRAIN_SEQ, TRAIN_BATCH, "train")
    plan = TrainPlan(n_micro=TRAIN_MICRO, q_chunk=512, remat=True)
    tc = TrainerConfig(steps=1, ckpt_dir=str(ROOT / "build" / "unused"),
                       seed=0)
    batch = token_stream(0, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab, seed=tc.seed)
    mesh = make_host_mesh(*SHARDED_MESH, device="cuda")
    tr = Trainer(cfg, shape, mesh, tc, plan=plan)
    opt = tr.optimizer
    check(isinstance(opt, AdamW) and opt.master_weights
          and opt.lr == baseline["lr"], "sharded: not the one-device "
          "step's AdamW")
    torch.cuda.reset_peak_memory_stats()
    init_s, state = timed_s(tr.init_state)
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    specs = tr.specs()
    held = tr.position_bytes(state)
    want = {k: sh.shard_bytes(state[k], specs[k], mesh)
            for k in ("params", "opt")}
    torch.cuda.reset_peak_memory_stats()
    step_s, (state, met) = timed_s(lambda: tr.train_step(state, batch))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = dict(tr.train_step.stats)
    gdtype = getattr(torch, plan.grad_dtype)
    held["grad_accumulator"] = stats.pop("accumulator_bytes")
    want["grad_accumulator"] = sh.shard_bytes(
        tree.map_(lambda p: torch.empty(p.shape, dtype=gdtype,
                                        device="meta"), state["params"]),
        sh.grad_specs(state["params"], mesh), mesh)
    bytes_ok = all(bool((held[k] == want[k]).all()) for k in want)
    loss_err = abs(float(met["loss"]) - float(baseline["loss"])) / abs(
        float(baseline["loss"]))
    norm_err = abs(float(met["grad_norm"]) - float(baseline["grad_norm"])
                   ) / abs(float(baseline["grad_norm"]))
    rule = sharded_vs_one_device(state, baseline["state"], baseline["lr"])
    rule_ok = (loss_err <= SHARDED_LOSS_RTOL and norm_err <= SHARDED_NORM_RTOL
               and not rule["outside"])
    layer_block, head_block = position_blocks(cfg, mesh.shape["model"])
    positions = stats.pop("positions")
    per_position_ok = all(
        set(p["layer_bytes"].values()) == {layer_block}
        and p["once_bytes"] == head_block
        and p["gathers"] == 2 * TRAIN_LAYERS * p["micro_batches"]
        and p["max_live_layers"] == 1 and p["live_after"] == 0
        for p in positions)
    fields = dict(
        arch=cfg.name, layers=TRAIN_LAYERS, of_layers=32, mesh=repr(mesh),
        data_shards=len(sh.batch_devices(mesh)),
        model_ways=mesh.shape["model"],
        plan=dataclasses.asdict(plan), batch=[TRAIN_BATCH, TRAIN_SEQ],
        loss=float(met["loss"]), loss_one_device=float(baseline["loss"]),
        loss_rel_err=loss_err, grad_norm=float(met["grad_norm"]),
        grad_norm_one_device=float(baseline["grad_norm"]),
        grad_norm_rel_err=norm_err, state=rule, rule=dict(
            loss_rtol=SHARDED_LOSS_RTOL, norm_rtol=SHARDED_NORM_RTOL,
            moment_rel=SHARDED_MOMENT_REL, param="2 lr + 1 ulp"),
        bytes_per_position={
            k: dict(held=held[k].tolist(), shard_bytes=int(want[k]))
            for k in want},
        bytes_equal_shard_bytes=bytes_ok, gather=stats,
        positions=[dict(p, layer_bytes=sorted(set(p["layer_bytes"].values())))
                   for p in positions],
        position_layer_block_bytes=layer_block,
        position_head_block_bytes=head_block,
        per_position_ok=per_position_ok, init_s=init_s,
        init_peak_gb=init_peak_gb, step_wall_s=step_s,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s, peak_gb=peak_gb)
    if not (bytes_ok and rule_ok and per_position_ok):
        emit("train_sharded_failed", **fields)
    check(bytes_ok, f"sharded: bytes a position holds {held}, "
          f"shard_bytes {want}")
    check(rule_ok, f"sharded: loss {float(met['loss'])} against "
          f"{float(baseline['loss'])}, norm {float(met['grad_norm'])} "
          f"against {float(baseline['grad_norm'])}, state {rule}")
    check(per_position_ok, f"sharded: a position's gathers are not its "
          f"blocks ({layer_block} B a layer, {head_block} B of head), or "
          f"gathered layers outlived their use: {fields['positions']}")
    # the first step is the first call of the positions' GEMM shapes; a
    # second, unprofiled, is the warm step the idle share is taken from
    warm_s, (state, met) = timed_s(lambda: tr.train_step(state, batch))
    (state, met), prof = profiled_once(lambda: tr.train_step(state, batch))
    fields["step_profile"] = prof
    fields["warm_step_wall_s"] = warm_s
    fields["idle_share"] = max(0.0, 1.0 - prof["device_busy_s"] / warm_s)
    fields["first_step_idle_share"] = max(
        0.0, 1.0 - prof["device_busy_s"] / step_s)

    comp = make_grad_compressor(levels=COMPRESS_LEVELS)
    seen = dict(calls=0)

    def compress(grads):
        seen["calls"] += 1
        flat = grads["head"].reshape(-1, 1).float()
        seen["sample"] = flat[::max(1, flat.shape[0] // SAMPLE)][
            :SAMPLE].clone()[None]
        seen["leaves"] = len(tree.leaves(grads))
        seen["compress_s"], out = timed_s(lambda: comp(grads)[0])
        return out

    cstep = make_train_step(tr.model, opt, cfg, shape, plan,
                            compress_fn=compress, mesh=mesh)
    batch = token_stream(1, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab, seed=tc.seed)
    reset_launches()
    cstep_s, (state, met) = timed_s(lambda: cstep(state, batch))
    launches = read_launches()
    want_l = seen["leaves"] * (8 + 1)   # max_iters + the final pass
    check(seen["calls"] == 1 and seen["leaves"] == 12
          and launches["lloyd_step"] == want_l
          and sum(launches.values()) == want_l,
          f"sharded: compressor called {seen['calls']} times, launches "
          f"{launches}, want {want_l} Lloyd launches")
    check(np.isfinite(float(met["loss"])), "sharded: compressed loss")
    fields["compressed_step"] = dict(step_s=cstep_s,
                                     compress_s=seen["compress_s"],
                                     hook_calls=seen["calls"],
                                     leaves=seen["leaves"],
                                     loss=float(met["loss"]),
                                     launches=launches)
    emit("train_sharded", **fields)
    del state, met, tr, cstep
    gc.collect()
    torch.cuda.empty_cache()
    return fields, seen["sample"]


# dbrx-132b at full width (d 6144, 48 heads / 8 kv of 128, 16 experts
# top 4, d_ff 10,752, vocab 100,352) with 1 of its 40 layers: 4.49 B
# parameters (3.17 B of experts), bf16 from seed 0, the reference's plan
# for it (Adafactor, bf16 gradient accumulation, no master weights),
# 8 x 512 tokens in 2 micro-batches with remat.  The depth is cut for the
# peak: at 2 layers the one-device step alone peaked at 80.41 GB on an
# H100 80GB HBM3 (its f32 gradient beside the weights and the update's
# f32 temporaries of the stacked expert leaves)
MOE_TRAIN_LAYERS = 1
# The 2 x 2 step against the one-device step.  With only the experts over
# "model" no sum is split, so the forward is the one-device step's bits:
# the loss bit for bit, the drops equal, each Adafactor second moment
# (vr, vc, v) within f32 rounding (MOE_EXACT_MOMENT_REL: the sharded
# optimizer adds its row and column sums per block) and every parameter
# within one ulp plus MOE_EXACT_PARAM_LR lr (those f32 sums move the f32
# router's update at its last bits).  With attention and the head split too, their partial
# sums reorder and the MoE layer's input moves at bf16 rounding, so a
# near-tied gate may flip an entry: the loss at rtol 1e-3, the gradient
# norm (read from the first step's second moments) at rtol 1e-2, each
# drop count within MOE_DROPS_REL of the entries routed, each second
# moment within MOE_MOMENT_REL and each parameter within MOE_PARAM_LR lr
# plus one ulp: about twice the bf16 noise floor tools/model_axis_noise.py
# measures at this configuration (PERF.md section 6; a split sum leaves a
# gradient about 1% off, so its square, which the second moments hold
# after the first step, about 2%)
MOE_EXACT_MOMENT_REL = 1e-6
MOE_EXACT_PARAM_LR = 1e-4
MOE_DROPS_REL = 1e-3
MOE_MOMENT_REL = 4e-2
MOE_PARAM_LR = 4.0


def moe_train_setup():
    """(config, shape, plan, batch) of the MoE training phases."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import token_stream
    from repro_torch.train.step import TrainPlan
    cfg = dataclasses.replace(get_config("dbrx-132b"),
                              n_layers=MOE_TRAIN_LAYERS)
    shape = ShapeConfig("train_8x512", TRAIN_SEQ, TRAIN_BATCH, "train")
    plan = TrainPlan(optimizer="adafactor", n_micro=TRAIN_MICRO,
                     grad_dtype="bfloat16", q_chunk=512, remat=True)
    return cfg, shape, plan, token_stream(0, TRAIN_BATCH, TRAIN_SEQ,
                                          cfg.vocab, seed=0)


@contextlib.contextmanager
def experts_only_split():
    """Within ``with``: the models split only the MoE experts over
    "model" (attention and the head computed whole on each data shard's
    first position), so no sum is split."""
    from repro_torch.models import lm
    regions = lm.DecoderLM.split_regions, lm.AttnBlock.split_regions
    lm.DecoderLM.split_regions = lambda self, n: {
        k: v for k, v in regions[0](self, n).items() if ".moe.we" in k}
    lm.AttnBlock.split_regions = lambda self, n: {
        k: v for k, v in regions[1](self, n).items()
        if k.startswith("moe.we")}
    try:
        yield
    finally:
        lm.DecoderLM.split_regions, lm.AttnBlock.split_regions = regions


def ulp_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest difference of two tensors in units of the type's ulp
    at the larger of the two entries (0.0 where they are equal)."""
    big = torch.maximum(a.abs(), b.abs())
    ulp = (torch.nextafter(big, torch.full_like(big, float("inf"))).float()
           - big.float())
    return float(((a.float() - b.float()).abs() / ulp).max())


def moe_layer_alone() -> dict:
    """One MoE layer at dbrx's full width on the card (16 experts of 6144
    x 10,752, top 4, bf16 weights, x (4, 512, 6144) bf16, an f32 router
    at 8 d^-1/2 so the favourite experts overfill and drop): ``moe_ffn`` whole
    against ``moe_ffn`` with the experts over two "model" positions
    (``cuda:0`` twice), on the same inputs and output gradient: the
    output, the aux loss and the gradients of x, the router and each
    expert weight, bit for bit or, per tensor, the largest gap in ulps."""
    from repro_torch.configs import get_config
    from repro_torch.core.model_axis import ModelSplit
    from repro_torch.models import moe

    cfg = get_config("dbrx-132b")
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    g = torch.Generator(device="cuda").manual_seed(11)

    def randn(*shape, scale, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(dtype)

    p = {"router": randn(d, e, scale=d ** -0.5 * 8, dtype=torch.float32),
         "we1": randn(e, d, f, scale=d ** -0.5),
         "we3": randn(e, d, f, scale=d ** -0.5),
         "we2": randn(e, f, d, scale=f ** -0.5)}
    # x off zero along every dim, so the router's column sums favour some
    # experts for every token and those overfill
    x = (randn(TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ, d, scale=1.0,
               dtype=torch.float32) + 0.5).to(torch.bfloat16)
    gy = randn(*x.shape, scale=1.0)
    kw = dict(n_experts=e, top_k=cfg.experts_per_token,
              capacity_factor=cfg.expert_capacity_factor)
    out = []
    for ways in (1, 2):
        split = ModelSplit(["cuda:0"] * ways)
        ps = {n: t.requires_grad_(True) for n, t in p.items()}
        xx = x.detach().requires_grad_(True)
        experts = None
        if ways > 1:
            n = e // ways
            experts = [{w: ps[w][m * n:(m + 1) * n]
                        for w in ("we1", "we3", "we2")} for m in range(ways)]
        with moe_drops() as rows:
            y, aux = moe.moe_ffn(ps if experts is None else
                                 {"router": ps["router"]}, xx, split=split,
                                 experts=experts, **kw)
        grads = torch.autograd.grad((y.float() * gy.float()).sum() + aux,
                                    [xx, *ps.values()])
        torch.cuda.synchronize()
        out.append(dict(y=y.detach(), aux=aux.detach(),
                        **dict(zip(["grad_x"] + [f"grad_{n}" for n in ps],
                                   grads)),
                        dropped=int(rows[0][1]), entries=rows[0][0],
                        counts=dict(split.counts)))
        for t in p.values():
            t.requires_grad_(False)
        del y, aux, grads
    whole, over = out
    gaps = {k: (0.0 if bits_equal(whole[k], over[k])
                else ulp_gap(whole[k], over[k]))
            for k in whole if isinstance(whole[k], torch.Tensor)}
    row = dict(shape=dict(x=list(x.shape), experts=e, d=d, d_ff=f,
                          top_k=cfg.experts_per_token),
               entries=whole["entries"], dropped=whole["dropped"],
               dropped_over_model=over["dropped"],
               bitwise=all(v == 0.0 for v in gaps.values()),
               ulp_gaps=gaps, counts=over["counts"])
    check(whole["dropped"] == over["dropped"] and whole["dropped"] > 0,
          f"MoE layer alone: drops {whole['dropped']} whole, "
          f"{over['dropped']} over model")
    check(over["counts"]["split_model_calls"] == 2
          and over["counts"]["concat_model_calls"] == 1,
          f"MoE layer alone: collectives {over['counts']}")
    # where the card computes an expert's products alike whatever the
    # batch of experts a call holds, the layer is the whole layer's bits;
    # otherwise each tensor stays within a few ulps (bf16: 2^-8 relative)
    check(max(gaps.values()) <= 8.0, f"MoE layer alone: {gaps}")
    del out, whole, over, p, x, gy
    torch.cuda.empty_cache()
    return row


def first_step_grad_norm(opt_state) -> float:
    """The gradient's global norm read from Adafactor's state after its
    first step, whose decay there is 0: a factored leaf's ``vr`` holds
    its squared gradient's row means (times the row length, ``vc``'s last
    dim, its sum of squares), an unfactored leaf's ``v`` its squares; in
    f64 (the optimizer reports no norm)."""
    total = 0.0
    for fac in _fac_leaves(opt_state["fac"]):
        if "v" in fac:
            total += float(on_card(fac["v"]).double().sum())
        else:
            total += float(on_card(fac["vr"]).double().sum()) * \
                fac["vc"].shape[-1]
    return total ** 0.5


def _fac_leaves(t):
    """The per-parameter dicts (``{vr, vc}`` or ``{v}``) of an Adafactor
    ``fac`` tree."""
    if isinstance(t, dict) and ("v" in t or "vr" in t):
        return [t]
    return [f for v in t.values() for f in _fac_leaves(v)]


def train_moe_one_device(nudge: bool = False):
    """The one-device Adafactor step of the MoE phase on a whole seed-0
    state, profiled (``nudge`` moves one entry of the first layer's ``attn.wq``,
    which every token's path crosses, by one bf16 ulp first: the noise
    floor's probe): its loss, norm, drops
    and state kept on the host and the card freed.  -> (the emitted
    fields, the baseline :func:`train_moe_sharded` is held against)."""
    import gc
    from repro_torch import tree
    from repro_torch.optim import get_optimizer
    from repro_torch.train.step import make_train_step

    cfg, shape, plan, batch = moe_train_setup()
    opt = get_optimizer(plan.optimizer)
    model, state = whole_train_state(cfg, opt)
    if nudge:
        state["params"]["g_blocks"]["attn"]["wq"].view(torch.int16)[
            0, 3, 5] += 1
    one = make_train_step(model, opt, cfg, shape, plan)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    # profiled: its device-busy time is the 2 x 2 step's yardstick
    with moe_drops() as rows:
        (state, met), prof = profiled_once(lambda: one(state, batch))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = read_launches()
    step_s = prof["profiled_wall_s"]
    check(np.isfinite(float(met["loss"])), "MoE one device: loss")
    baseline = dict(loss=met["loss"].cpu(),
                    grad_norm=first_step_grad_norm(state["opt"]),
                    lr=opt.lr, drops=[int(n) for _, n in rows],
                    state=tree.map_(host_copy, state))
    fields = dict(
        arch=cfg.name, layers=MOE_TRAIN_LAYERS, of_layers=40,
        n_params=sum(t.numel() for t in tree.leaves(state["params"])),
        plan=dataclasses.asdict(plan), batch=[TRAIN_BATCH, TRAIN_SEQ],
        loss=float(baseline["loss"]), grad_norm=baseline["grad_norm"],
        drops=baseline["drops"], entries=[n for n, _ in rows],
        step_wall_s=step_s, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s,
        step_profile=prof, peak_gb=peak_gb, launches=launches)
    del state, met, model, one
    gc.collect()
    torch.cuda.empty_cache()
    return fields, baseline


def moe_position_blocks(cfg, n_model: int) -> tuple[int, int]:
    """(the bytes of one dbrx layer's blocks a "model" position computes
    with: its E / M experts of ``moe.we1``, ``moe.we3``, ``moe.we2`` and
    its heads' columns and rows of the attention, in bf16; the f32 router
    its data shard's first position reads whole beside them)."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    hm = h // n_model
    kvm = max(1, hm * kv // h)
    experts = 3 * cfg.n_experts // n_model * d * cfg.d_ff
    return 2 * (experts + 2 * d * hm * dh + 2 * d * kvm * dh), \
        4 * d * cfg.n_experts


def train_moe_sharded(baseline: dict, experts_only: bool = False) -> dict:
    """The sharded trainer at the MoE phase's configuration on
    ``make_host_mesh(2, 2, device="cuda")`` (``cuda:0`` four times): each
    data shard computes its experts (8 a position), attention (24 heads a
    position) and the head (vocab halves) over its two "model" positions
    (with ``experts_only``, the experts alone: :func:`experts_only_split`).
    ``Trainer.init_state`` from seed 0, one step on the one-device step's
    batch held against ``baseline`` (:func:`train_moe_one_device`) under
    the rules above ``MOE_EXACT_MOMENT_REL``, its capacity drops against
    the baseline's, each position's bytes against
    ``sharding.shard_bytes``; with everything split, each position's
    gathered layer against its blocks (:func:`moe_position_blocks`),
    nothing gathered alive after the step, a warm step and a profiled
    repeat.  -> the fields."""
    import gc
    from repro_torch import tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import Adafactor
    from repro_torch.train import sharding as sh
    from repro_torch.train.trainer import Trainer, TrainerConfig

    what = "MoE sharded (experts only)" if experts_only else "MoE sharded"
    cfg, shape, plan, batch = moe_train_setup()
    tc = TrainerConfig(steps=1, ckpt_dir=str(ROOT / "build" / "unused"),
                       seed=0)
    mesh = make_host_mesh(*SHARDED_MESH, device="cuda")
    tr = Trainer(cfg, shape, mesh, tc, plan=plan)
    opt = tr.optimizer
    check(isinstance(opt, Adafactor) and opt.lr == baseline["lr"],
          f"{what}: not the one-device step's Adafactor")
    torch.cuda.reset_peak_memory_stats()
    init_s, state = timed_s(tr.init_state)
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    specs = tr.specs()
    held = tr.position_bytes(state)
    want = {k: sh.shard_bytes(state[k], specs[k], mesh)
            for k in ("params", "opt")}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with contextlib.ExitStack() as stack:
        if experts_only:
            stack.enter_context(experts_only_split())
        rows = stack.enter_context(moe_drops())
        step_s, (state, met) = timed_s(lambda: tr.train_step(state, batch))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = read_launches()
    stats = dict(tr.train_step.stats)
    gdtype = getattr(torch, plan.grad_dtype)
    held["grad_accumulator"] = stats.pop("accumulator_bytes")
    want["grad_accumulator"] = sh.shard_bytes(
        tree.map_(lambda p: torch.empty(p.shape, dtype=gdtype,
                                        device="meta"), state["params"]),
        sh.grad_specs(state["params"], mesh), mesh)
    bytes_ok = all(bool((held[k] == want[k]).all()) for k in want)
    loss_err = abs(float(met["loss"]) - float(baseline["loss"])) / abs(
        float(baseline["loss"]))
    grad_norm = first_step_grad_norm(state["opt"])
    norm_err = abs(grad_norm - baseline["grad_norm"]) / baseline["grad_norm"]
    # the forward and the recompute (remat) each route every micro-batch,
    # in the one-device step's order
    drops = [int(n) for _, n in rows]
    entries = [n for n, _ in rows]
    drop_gap = max((abs(a - b) / n for a, b, n in
                    zip(drops, baseline["drops"], entries)), default=1.0)
    if experts_only:
        rule = sharded_vs_one_device(state, baseline["state"],
                                     baseline["lr"], MOE_EXACT_MOMENT_REL,
                                     MOE_EXACT_PARAM_LR)
        limits = dict(loss="bit for bit", drops="equal",
                      moment_rel=MOE_EXACT_MOMENT_REL,
                      param=f"{MOE_EXACT_PARAM_LR} lr + 1 ulp")
        rule_ok = (float(met["loss"]) == float(baseline["loss"])
                   and drops == baseline["drops"] and not rule["outside"])
    else:
        rule = sharded_vs_one_device(state, baseline["state"],
                                     baseline["lr"], MOE_MOMENT_REL,
                                     MOE_PARAM_LR)
        limits = dict(loss_rtol=SHARDED_LOSS_RTOL,
                      norm_rtol=SHARDED_NORM_RTOL, drops_rel=MOE_DROPS_REL,
                      moment_rel=MOE_MOMENT_REL,
                      param=f"{MOE_PARAM_LR} lr + 1 ulp")
        rule_ok = (loss_err <= SHARDED_LOSS_RTOL
                   and norm_err <= SHARDED_NORM_RTOL
                   and len(drops) == len(baseline["drops"])
                   and drop_gap <= MOE_DROPS_REL and not rule["outside"])
    split_ok = (stats["split_model_calls"] > 0
                and stats["concat_model_calls"] > 0)
    positions = stats.pop("positions")
    fields = dict(
        arch=cfg.name, layers=MOE_TRAIN_LAYERS, of_layers=40,
        mesh=repr(mesh), data_shards=len(sh.batch_devices(mesh)),
        model_ways=mesh.shape["model"], experts_only=experts_only,
        plan=dataclasses.asdict(plan), batch=[TRAIN_BATCH, TRAIN_SEQ],
        loss=float(met["loss"]), loss_one_device=float(baseline["loss"]),
        loss_rel_err=loss_err, grad_norm=grad_norm,
        grad_norm_one_device=baseline["grad_norm"],
        grad_norm_rel_err=norm_err, state=rule, rule=limits,
        drops=drops, drops_one_device=baseline["drops"], entries=entries,
        drops_equal=drops == baseline["drops"], drop_gap=drop_gap,
        bytes_per_position={
            k: dict(held=held[k].tolist(), shard_bytes=int(want[k]))
            for k in want},
        bytes_equal_shard_bytes=bytes_ok, gather=stats,
        positions=[dict(p, layer_bytes=sorted(set(p["layer_bytes"].values())))
                   for p in positions],
        init_s=init_s, init_peak_gb=init_peak_gb, step_wall_s=step_s,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s, peak_gb=peak_gb,
        launches=launches)
    per_position_ok = True
    if not experts_only:
        layer_block, router = moe_position_blocks(cfg, mesh.shape["model"])
        _, head_block = position_blocks(cfg, mesh.shape["model"])
        first = {row[0][0] for row in sh.model_positions(mesh)}
        per_position_ok = all(
            set(p["layer_bytes"].values())
            == {layer_block + (router if p["position"] in first else 0)}
            and p["once_bytes"] == head_block
            and p["gathers"] == 2 * MOE_TRAIN_LAYERS * p["micro_batches"]
            and p["max_live_layers"] == 1 and p["live_after"] == 0
            for p in positions)
        fields.update(position_layer_block_bytes=layer_block,
                      router_bytes=router,
                      position_head_block_bytes=head_block,
                      per_position_ok=per_position_ok)
    if not (bytes_ok and rule_ok and per_position_ok and split_ok):
        emit("train_moe_sharded_failed", **fields)
    check(bytes_ok, f"{what}: bytes a position holds {held}, "
          f"shard_bytes {want}")
    check(rule_ok, f"{what}: loss {float(met['loss'])} against "
          f"{float(baseline['loss'])}, norm {grad_norm} against "
          f"{baseline['grad_norm']}, drops {drops} against "
          f"{baseline['drops']}, state {rule}")
    check(per_position_ok, f"{what}: a position's gathers are not its "
          f"blocks, or gathered layers outlived their use: "
          f"{fields['positions']}")
    check(split_ok, f"{what}: the experts did not split: {stats}")
    if not experts_only:
        warm_s, (state, met) = timed_s(lambda: tr.train_step(state, batch))
        (state, met), prof = profiled_once(
            lambda: tr.train_step(state, batch))
        check(np.isfinite(float(met["loss"])), f"{what}: repeat loss")
        fields["step_profile"] = prof
        fields["warm_step_wall_s"] = warm_s
        fields["idle_share"] = max(0.0, 1.0 - prof["device_busy_s"] / warm_s)
        fields["first_step_idle_share"] = max(
            0.0, 1.0 - prof["device_busy_s"] / step_s)
    del state, met, tr
    gc.collect()
    torch.cuda.empty_cache()
    return fields


def train_moe_phase() -> dict:
    """``train_moe_sharded``'s line: the MoE layer alone, the one-device
    step, the 2 x 2 step with the experts alone over "model" and then
    with attention and the head too, each against it; the phase's
    seconds."""
    t0 = time.perf_counter()
    layer = moe_layer_alone()
    one, baseline = train_moe_one_device()
    experts = train_moe_sharded(baseline, experts_only=True)
    fields = train_moe_sharded(baseline)
    del baseline
    fields.update(moe_layer_alone=layer, one_device=one,
                  experts_only_step={k: experts[k] for k in (
                      "loss", "loss_rel_err", "grad_norm_rel_err", "drops",
                      "drops_equal", "state", "rule", "gather",
                      "bytes_equal_shard_bytes", "step_wall_s", "peak_gb")},
                  seconds=time.perf_counter() - t0)
    emit("train_moe_sharded", **fields)
    return fields


# xlstm-1.3b (arXiv:2405.04517: d 2048, 4 heads, mLSTM heads of 1024 on di
# 4096 and sLSTM heads of 512, vocab 50,304 padded to 50,432) with one of
# its 6 superblocks (7 mLSTM and 1 sLSTM, 8 of its 48 layers) and
# zamba2-2.7b (arXiv:2411.15242: d 2560, Mamba2 blocks of 80 heads of 64
# with a 64-wide state, the shared attention block of 32 heads of 80 and
# d_ff 10,240, vocab 32,000) with one of its 6 superblocks (9 Mamba2
# layers and the shared block): from seed 0, AdamW with f32 master
# weights (the reference's plan for both), 8 x 512 tokens in 2
# micro-batches with remat, in bf16 (the models' type) and again in f32
# (the same seed-0 draws).  The depth is cut for the script's time: the
# sLSTM is a loop of 512 steps a micro-batch, run once on each position
# that holds its heads.  On the 2 x 2 mesh each data shard computes the
# recurrent blocks by heads over its two "model" positions (xlstm: 2 of 4
# heads a position in each mLSTM and the sLSTM; zamba2: 40 of 80 Mamba2
# heads), the shared attention by heads, the FFN and the head by columns
RECURRENT_TRAIN_LAYERS = {"xlstm-1.3b": 8, "zamba2-2.7b": 9}
# each type and whether its steps are profiled and timed (the f32 steps
# are a check only)
RECURRENT_TRAIN_DTYPES = {"bfloat16": True, "float32": False}
# The 2 x 2 step against the one-device step in the same type: the loss
# and the gradient norm at relative errors ``loss`` and ``norm``, each
# leaf's AdamW first moment (the gradient times 1 - beta1) within a
# relative Frobenius error ``moment``, each parameter within 2 lr plus
# one ulp (AdamW's first step moves an entry by about lr, so a flipped
# sign of a near-zero gradient moves it 2 lr).  Each limit is twice what
# tools/model_axis_noise.py measured for the same step on an H100
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6), rounded up, and
# no less than 1e-6 (some f32 ulps) where the reading was 0.  In bf16
# these random-weight recurrent models carry any change of rounding far
# into their gradients (one bf16 ulp of one mLSTM wq entry moved xlstm's
# first moments 8.9%, one Mamba2 in_proj entry zamba2's 2.0%; the step
# read loss 9.2e-5 and 2.3e-5, norm 1.8e-3 and 1.8e-5, moments 12.3% and
# 2.8%), so the bf16 step is the smoke and the f32 step the discriminating
# check (loss 8.4e-8 and 0, norm 1.6e-6 and 0, moments 0.21% and 0.0022%)
REC_LIMITS = {
    ("xlstm-1.3b", "bfloat16"): dict(loss=2e-4, norm=4e-3, moment=0.25),
    ("zamba2-2.7b", "bfloat16"): dict(loss=5e-5, norm=4e-5, moment=0.06),
    ("xlstm-1.3b", "float32"): dict(loss=1e-6, norm=4e-6, moment=5e-3),
    ("zamba2-2.7b", "float32"): dict(loss=1e-6, norm=1e-6, moment=5e-5),
}


def recurrent_train_setup(arch: str, dtype: str):
    """(config, shape, plan, batch) of the recurrent training phase for
    ``arch`` in ``dtype``."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import token_stream
    from repro_torch.train.step import TrainPlan
    cfg = dataclasses.replace(get_config(arch), dtype=dtype,
                              n_layers=RECURRENT_TRAIN_LAYERS[arch])
    shape = ShapeConfig("train_8x512", TRAIN_SEQ, TRAIN_BATCH, "train")
    plan = TrainPlan(optimizer="adamw", n_micro=TRAIN_MICRO, q_chunk=512,
                     remat=True)
    return cfg, shape, plan, token_stream(0, TRAIN_BATCH, TRAIN_SEQ,
                                          cfg.vocab, seed=0)


def recurrent_step(fn, profile: bool):
    """(``fn()``, the first step's fields): with ``profile`` its profile
    (:func:`profiled_once`), else only its wall seconds."""
    if profile:
        out, prof = profiled_once(fn)
        return out, dict(first_step_s=prof["profiled_wall_s"],
                         device_busy_s=prof["device_busy_s"],
                         device_launches=prof["device_launches"],
                         step_profile=prof)
    wall, out = timed_s(fn)
    return out, dict(first_step_s=wall)


def warm_fields(first: dict, warm_s: float) -> dict:
    """The warm step's fields: its seconds, the idle share of the first
    step's busy time in it, tokens/s."""
    return dict(warm_step_s=warm_s,
                idle_share=max(0.0, 1.0 - first["device_busy_s"] / warm_s),
                tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / warm_s)


def train_recurrent_one_device(arch: str, dtype: str, profile: bool):
    """The one-device AdamW step of the recurrent phase for ``arch`` in
    ``dtype`` on a whole seed-0 state: a first step (with ``profile``
    profiled, then a warm step timed) whose loss, norm and state are kept
    on the host; the card freed.  -> (the emitted fields, the baseline
    :func:`train_recurrent_sharded` is held against)."""
    import gc
    from repro_torch import tree
    from repro_torch.optim import AdamW
    from repro_torch.train.step import make_train_step

    cfg, shape, plan, batch = recurrent_train_setup(arch, dtype)
    opt = AdamW(master_weights=True)
    model, state = whole_train_state(cfg, opt)
    one = make_train_step(model, opt, cfg, shape, plan)
    torch.cuda.reset_peak_memory_stats()
    (state, met), first = recurrent_step(lambda: one(state, batch), profile)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(np.isfinite(float(met["loss"])), f"{arch} one device: loss")
    baseline = dict(loss=met["loss"].cpu(), grad_norm=met["grad_norm"].cpu(),
                    lr=opt.lr, state=tree.map_(host_copy, state))
    fields = dict(
        arch=cfg.name, dtype=dtype, layers=cfg.n_layers,
        n_params=sum(t.numel() for t in tree.leaves(state["params"])),
        plan=dataclasses.asdict(plan), batch=[TRAIN_BATCH, TRAIN_SEQ],
        loss=float(baseline["loss"]), grad_norm=float(baseline["grad_norm"]),
        peak_gb=peak_gb, **first)
    if profile:
        warm_s, (state, met) = timed_s(lambda: one(state, batch))
        check(np.isfinite(float(met["loss"])),
              f"{arch} one device: warm loss")
        fields.update(warm_fields(first, warm_s))
    del state, met, model, one
    gc.collect()
    torch.cuda.empty_cache()
    return fields, baseline


def recurrent_position_blocks(cfg, n_model: int) -> tuple[int, int, int]:
    """(the bytes a "model" position copies of one superblock's recurrent
    layers, the extra its data shard's first position copies, the bytes
    a position copies once a step), from the shapes, with M dividing the
    heads; ``w`` bytes an entry of the model's type, 4 of an f32 leaf.
    xlstm: each mLSTM's H / M heads' columns of ``wq``, ``wk``, ``wv``,
    ``up2`` (w), ``wi``, ``wf`` (f32) and their rows of ``down``, the
    sLSTM's heads' columns of ``wz`` ... ``wo``, slices of ``rz`` ...
    ``ro`` and rows of ``down``; the first position also each mLSTM's
    ``up1``.  zamba2: each Mamba2's nh / M heads' z, x and dt columns and
    all of B and C of ``in_proj``, their x channels and B, C of ``conv``
    (f32), their entries of ``A_log``, ``dt_bias``, ``D`` (f32) and rows
    of ``out_proj``; once a step the shared attention's heads' columns
    and rows and its FFN's d_ff / M columns and rows.  Both: the head's
    Vp / M columns once a step."""
    w = getattr(torch, cfg.dtype).itemsize
    d, di, vp = cfg.d_model, 2 * cfg.d_model, cfg.padded_vocab
    head = w * d * vp // n_model
    if cfg.family == "ssm":
        h = cfg.n_heads
        cm, sd = di // n_model, d // n_model
        mlstm = w * (3 * di * cm + 2 * d * cm) + 4 * 2 * di * (h // n_model)
        slstm = w * (4 * d * sd + 4 * (h // n_model) * (d // h) ** 2
                     + sd * d)
        return (cfg.mlstm_per_slstm * mlstm + slstm,
                cfg.mlstm_per_slstm * w * d * di, head)
    ds, hm = cfg.ssm_state, di // 64 // n_model
    xm = 64 * hm
    mamba = (w * d * (2 * xm + 2 * ds + hm) + 4 * 4 * (xm + 2 * ds)
             + 4 * 3 * hm + w * xm * d)
    cols = cfg.n_heads // n_model * cfg.dh
    shared = w * (4 * d * cols + 3 * d * cfg.d_ff // n_model)
    return cfg.mamba_per_attn * mamba, 0, shared + head


def train_recurrent_sharded(arch: str, dtype: str, baseline: dict,
                            profile: bool) -> dict:
    """The sharded trainer at the recurrent phase's configuration for
    ``arch`` in ``dtype`` on ``make_host_mesh(2, 2, device="cuda")``
    (``cuda:0`` four times).  ``Trainer.init_state`` from seed 0, one step
    on the one-device step's batch held against ``baseline``
    (:func:`train_recurrent_one_device`) under ``REC_LIMITS``; each
    position's bytes against ``sharding.shard_bytes``; each position's
    gathered layer against :func:`recurrent_position_blocks`, none alive
    after the step; the recurrent blocks' row products among
    ``from_model_adds``.  With ``profile`` the first step is profiled
    (its device-busy time and launches), then a warm step timed.  -> the
    fields."""
    import gc
    from repro_torch import tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamW
    from repro_torch.train import sharding as sh
    from repro_torch.train.trainer import Trainer, TrainerConfig

    what = f"{arch} {dtype} sharded"
    limits = REC_LIMITS[arch, dtype]
    cfg, shape, plan, batch = recurrent_train_setup(arch, dtype)
    tc = TrainerConfig(steps=1, ckpt_dir=str(ROOT / "build" / "unused"),
                       seed=0)
    mesh = make_host_mesh(*SHARDED_MESH, device="cuda")
    tr = Trainer(cfg, shape, mesh, tc, plan=plan)
    opt = tr.optimizer
    check(isinstance(opt, AdamW) and opt.master_weights
          and opt.lr == baseline["lr"], f"{what}: not the one-device "
          f"step's AdamW")
    state = tr.init_state()
    specs = tr.specs()
    held = tr.position_bytes(state)
    want = {k: sh.shard_bytes(state[k], specs[k], mesh)
            for k in ("params", "opt")}
    torch.cuda.reset_peak_memory_stats()
    (state, met), first = recurrent_step(lambda: tr.train_step(state, batch),
                                         profile)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = dict(tr.train_step.stats)
    gdtype = getattr(torch, plan.grad_dtype)
    held["grad_accumulator"] = stats.pop("accumulator_bytes")
    want["grad_accumulator"] = sh.shard_bytes(
        tree.map_(lambda p: torch.empty(p.shape, dtype=gdtype,
                                        device="meta"), state["params"]),
        sh.grad_specs(state["params"], mesh), mesh)
    bytes_ok = all(bool((held[k] == want[k]).all()) for k in want)
    loss_err = abs(float(met["loss"]) - float(baseline["loss"])) / abs(
        float(baseline["loss"]))
    norm_err = abs(float(met["grad_norm"]) - float(baseline["grad_norm"])
                   ) / abs(float(baseline["grad_norm"]))
    rule = sharded_vs_one_device(state, baseline["state"], baseline["lr"],
                                 limits["moment"])
    rule_ok = (loss_err <= limits["loss"] and norm_err <= limits["norm"]
               and not rule["outside"])
    n_model = mesh.shape["model"]
    layer, first_extra, once = recurrent_position_blocks(cfg, n_model)
    firsts = {row[0][0] for row in sh.model_positions(mesh)}
    positions = stats.pop("positions")
    per_position_ok = all(
        set(p["layer_bytes"].values())
        == {layer + (first_extra if p["position"] in firsts else 0)}
        and p["once_bytes"] == once
        and p["gathers"] == 2 * p["micro_batches"]     # one superblock
        and p["max_live_layers"] == 1 and p["live_after"] == 0
        for p in positions)
    # each recurrent block's row product in each micro-batch's forward and
    # again in most of the remat recomputes (which stop after the last
    # saved tensor they need)
    n_blocks = (cfg.mlstm_per_slstm + 1 if cfg.family == "ssm"
                else cfg.mamba_per_attn)
    adds = stats["from_model_adds"]
    adds_ok = adds >= TRAIN_MICRO * n_blocks
    fields = dict(
        arch=cfg.name, dtype=dtype, layers=cfg.n_layers, mesh=repr(mesh),
        data_shards=len(sh.batch_devices(mesh)), model_ways=n_model,
        plan=dataclasses.asdict(plan), batch=[TRAIN_BATCH, TRAIN_SEQ],
        loss=float(met["loss"]), loss_one_device=float(baseline["loss"]),
        loss_rel_err=loss_err, grad_norm=float(met["grad_norm"]),
        grad_norm_one_device=float(baseline["grad_norm"]),
        grad_norm_rel_err=norm_err, state=rule,
        rule=dict(limits, param="2 lr + 1 ulp"),
        bytes_per_position={
            k: dict(held=held[k].tolist(), shard_bytes=int(want[k]))
            for k in want},
        bytes_equal_shard_bytes=bytes_ok, gather=stats,
        positions=[dict(p, layer_bytes=sorted(set(
            p["layer_bytes"].values()))) for p in positions],
        position_layer_bytes=layer, first_position_extra=first_extra,
        position_once_bytes=once, per_position_ok=per_position_ok,
        recurrent_row_products=TRAIN_MICRO * n_blocks, adds_ok=adds_ok,
        peak_gb=peak_gb, **first)
    if not (bytes_ok and rule_ok and per_position_ok and adds_ok):
        emit("train_recurrent_sharded_failed", **fields)
    check(bytes_ok, f"{what}: bytes a position holds {held}, "
          f"shard_bytes {want}")
    check(rule_ok, f"{what}: loss {float(met['loss'])} against "
          f"{float(baseline['loss'])}, norm {float(met['grad_norm'])} "
          f"against {float(baseline['grad_norm'])}, limits {limits}, "
          f"state {rule}")
    check(per_position_ok, f"{what}: a position's gathers are not its "
          f"regions ({layer} B a layer, {first_extra} B more on a shard's "
          f"first, {once} B once), or gathered layers outlived their use: "
          f"{fields['positions']}")
    check(adds_ok, f"{what}: {adds} row-product adds, want at least "
          f"{TRAIN_MICRO * n_blocks}")
    if profile:
        warm_s, (state, met) = timed_s(lambda: tr.train_step(state, batch))
        check(np.isfinite(float(met["loss"])), f"{what}: warm loss")
        fields.update(warm_fields(first, warm_s))
    del state, met, tr
    gc.collect()
    torch.cuda.empty_cache()
    return fields


def train_recurrent_phase() -> dict:
    """``train_recurrent_sharded``'s line: for xlstm-1.3b and zamba2-2.7b,
    in bf16 and in f32, the one-device step and the 2 x 2 step against
    it, and their seconds; the phase's seconds."""
    t0 = time.perf_counter()
    out = {}
    for arch in RECURRENT_TRAIN_LAYERS:
        for dtype, profile in RECURRENT_TRAIN_DTYPES.items():
            t1 = time.perf_counter()
            one, baseline = train_recurrent_one_device(arch, dtype, profile)
            fields = train_recurrent_sharded(arch, dtype, baseline, profile)
            del baseline
            out.setdefault(arch, {})[dtype] = dict(
                one_device=one, sharded=fields,
                seconds=time.perf_counter() - t1)
    emit("train_recurrent_sharded", **out,
         seconds=time.perf_counter() - t0)
    return out


# whisper-base (arXiv:2212.04356) at full width and depth: 6 encoder and 6
# decoder layers, d 512, 8 heads of 64, d_ff 2048, 1500 frames, vocab
# 51,865 padded to 51,968; bf16 weights from SERVE_SEED.  Its cells are
# train_4k's 4096 tokens and decode_32k's 32,768-slot full cache
# (long_500k is skipped for the encoder-decoder); the batches are cut for
# the script's time (train_4k 256 -> 8: a step of 256 sequences would take
# about 30 s; decode_32k 128 -> 8 for the served request, whose 288
# steps would take a step's time at 128 each, which the decode profile
# measures at the full batch, after the engine's cache is freed)
WHISPER_BATCH = 8             # train_4k's and decode_32k's batch, cut
WHISPER_TRAIN_MICRO = 2
WHISPER_PROMPT_LEN = 256      # tokens per sequence (prefill by decode steps)
WHISPER_PARITY_LEN = 64       # forward against decode, every position
WHISPER_PARITY_BATCH = 2
# forward against decode on an f32 copy: each position's largest logit
# difference over its largest logit (PERF.md §2's limit)
WHISPER_FWD_DEC_REL = 0.01
WHISPER_STEPS = 2
# the cluster-balanced sampler (data/pipeline.py) over a corpus of
# 1,048,576 documents of 129 tokens from llama3-8b's vocabulary (541 MB of
# int32 drawn on the card from seed 0, built as the tests' corpus: each
# document draws 80% of its tokens from its topic's six words, the rest
# uniformly): 32-dim sketches, 1024 clusters over 64 partitions at
# compression 5; 65,536 drawn documents
SAMPLER_DOCS, SAMPLER_SEQ = 1_048_576, 129
SAMPLER_TOPICS, SAMPLER_TOPIC_WORDS, SAMPLER_NOISE = 1024, 6, 0.2
SAMPLER_CLUSTERS, SAMPLER_SUB, SAMPLER_COMPRESSION = 1024, 64, 5
SAMPLER_DRAWS = 65_536
SAMPLER_LANDMARK_DOCS = 65_536
SAMPLER_TRAIN_SEQ, SAMPLER_TRAIN_BATCH = 128, 8
CHI2_P_MIN = 1e-3
# the paper's Table 1 on the surrogates (tests/test_system.py's bound on
# the relative SSE against standard k-means), as the mean over these
# seeds: one seed's error is one draw of the fit's random stages; each
# seed's error also stays below about 1.5x the largest sound reading
# (0.170 on the H100, 0.167 on the CPU, iris with the equal scheme)
TABLE1_SEEDS = range(8)
TABLE1_REL_MAX = 0.12
TABLE1_WORST_MAX = 0.25


def whisper_model(dtype: str = "bfloat16"):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("whisper-base"), dtype=dtype)
    return build_model(cfg).init_params(SERVE_SEED)


def whisper_forward(model) -> dict:
    """whisper-base's forward at full width and depth: ``forward(
    last_only=True)`` over train_4k's 4096 tokens and 1500 frames at batch
    ``WHISPER_BATCH``, timed, with its peak memory; then, on an f32 copy
    (the same draws), the forward's logits at every position of a
    64-token prompt against token-by-token ``decode_step`` on the full
    cache with the cross caches filled from the same encoder output,
    gated at ``WHISPER_FWD_DEC_REL``; and the same check with the cross
    caches filled from other frames (a planted fault), which must fail
    it."""
    from repro_torch.configs import SHAPES, ShapeConfig
    from repro_torch.models import batch_like
    cfg = model.cfg
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=WHISPER_BATCH)
    batch = batch_like(cfg, shape, SERVE_SEED)
    check(batch["frames"].shape == (WHISPER_BATCH, cfg.encoder_ctx,
                                    cfg.d_model)
          and batch["frames"].dtype == torch.bfloat16, "whisper frames")
    model.forward({"tokens": batch["tokens"][:, :512],
                   "frames": batch["frames"]}, last_only=True)   # warm-up
    torch.cuda.reset_peak_memory_stats()
    fwd_s, (last, aux) = timed_s(
        lambda: model.forward(batch, last_only=True))
    check(last.shape == (WHISPER_BATCH, 1, cfg.padded_vocab)
          and bool(torch.isfinite(last).all()) and float(aux) == 0.0,
          "whisper: bad forward logits")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_tokens = WHISPER_BATCH * shape.seq_len

    f32 = whisper_model("float32")
    b, n = WHISPER_PARITY_BATCH, WHISPER_PARITY_LEN
    p = {"tokens": batch["tokens"][:b, :n], "frames": batch["frames"][:b]}
    fwd, _ = f32.forward(p)
    other = batch_like(cfg, shape, SERVE_SEED + 1)["frames"][:b]

    def against_forward(frames) -> dict:
        caches = f32.init_caches(b, ShapeConfig("whisper_parity", n, b,
                                                "decode"), "full")
        # each layer's cross keys and values of the encoding (the engine
        # leaves them zero, as the reference's does)
        with torch.no_grad():
            enc = f32.encode(frames)
            for i, blk in enumerate(f32.dec):
                k, v = blk.cross_kv(enc)
                caches["xk"][i] = k.transpose(1, 2)
                caches["xv"][i] = v.transpose(1, 2)
        dec = torch.cat([f32.decode_step(p["tokens"][:, t:t + 1], caches,
                                         t)[0] for t in range(n)], 1)
        rel = ((dec - fwd).abs().amax(-1) / fwd.abs().amax(-1)).amax(0)
        top1 = float((dec.argmax(-1) == fwd.argmax(-1)).float().mean())
        return dict(max_rel=float(rel.max()),
                    rel_by_position=[round(float(r), 7) for r in rel.cpu()],
                    top1_agreement=top1)

    row = against_forward(p["frames"])
    check(row["max_rel"] <= WHISPER_FWD_DEC_REL,
          f"whisper forward against decode (f32): {row}")
    fault = against_forward(other)
    check(fault["max_rel"] > WHISPER_FWD_DEC_REL,
          f"whisper forward against decode misses cross caches of other "
          f"frames: {fault}")
    row["planted_fault"] = dict(what="cross caches from other frames",
                                **fault)
    del f32
    torch.cuda.empty_cache()
    fields = dict(
        arch=cfg.name, n_params=sum(t.numel() for t in model.parameters()),
        param_count=cfg.param_count(), batch=WHISPER_BATCH,
        tokens=shape.seq_len, frames=cfg.encoder_ctx, forward_s=fwd_s,
        tokens_per_s=n_tokens / fwd_s, peak_memory_gb=peak_gb,
        parity_len=n, parity_batch=b, limit=WHISPER_FWD_DEC_REL,
        forward_vs_decode_f32=row)
    emit("whisper_forward", **fields)
    return fields


def serve_whisper_decode_32k(model) -> dict:
    """``ServeEngine`` over whisper-base at decode_32k's full cache of
    32,768 slots with its batch cut to ``WHISPER_BATCH``: one request of
    256 prompt tokens a sequence (prefill by decode steps) and 32
    generated; the decode's tokens/s, the peak memory, no kernel of the
    five launched (the cache is full and nothing is clustered); a decode
    step's wall time against the card's busy time at that batch and, once
    the engine's cache is freed, at decode_32k's full batch (its 51.5 GB
    cache and each layer's f32 copy fit the card); then ``python -m
    repro_torch.launch.serve --arch whisper-base --prompt-len 64 --gen 16
    --batch 2`` in this process."""
    from repro_torch.configs import SHAPES
    from repro_torch.core.device import derive_seed
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.telemetry import RecordingLogger

    cfg = model.cfg
    shape = dataclasses.replace(SHAPES["decode_32k"],
                                global_batch=WHISPER_BATCH)
    log = RecordingLogger()
    eng = ServeEngine(cfg, shape, model, ServeConfig(max_tokens=GEN_TOKENS),
                      logger=log)
    check(eng.kind == "full", f"whisper decode_32k cache kind {eng.kind}")
    g = torch.Generator(device="cuda").manual_seed(derive_seed(SERVE_SEED, 6))
    prompt = torch.randint(0, cfg.vocab, (WHISPER_BATCH, WHISPER_PROMPT_LEN),
                           generator=g, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    total_s, out = timed_s(lambda: eng.generate(prompt))
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decode_s = sum(e["dur"] for e in log.named("decode_rate"))
    check(out.shape == (WHISPER_BATCH, GEN_TOKENS) and int(out.min()) >= 0
          and int(out.max()) < cfg.padded_vocab, "whisper: bad tokens")
    check(sum(launches.values()) == 0,
          f"whisper's full-cache decode launched a kernel: {launches}")
    del eng
    torch.cuda.empty_cache()
    profile = decode_profile(model, shape, kind="full", batch=WHISPER_BATCH)
    full_batch = SHAPES["decode_32k"].global_batch
    torch.cuda.reset_peak_memory_stats()
    profile_full = decode_profile(model, shape, kind="full",
                                  batch=full_batch)
    profile_full.update(batch=full_batch, peak_memory_gb=(
        torch.cuda.max_memory_allocated() / 1e9))
    torch.cuda.empty_cache()
    reset_launches()
    launcher_s, (tokens, _) = timed_s(lambda: serve_main(
        ["--arch", "whisper-base", "--prompt-len", "64", "--gen", "16",
         "--batch", "2"]))
    check(tokens.shape == (2, 16) and int(tokens.min()) >= 0
          and int(tokens.max()) < cfg.padded_vocab,
          f"whisper launcher gave {tokens}")
    fields = dict(
        arch=cfg.name, shape=shape.name, cache_len=shape.seq_len,
        batch=WHISPER_BATCH, prompt_len=WHISPER_PROMPT_LEN,
        gen_tokens=GEN_TOKENS, total_s=total_s, prefill_s=total_s - decode_s,
        decode_s=decode_s,
        decode_tokens_per_s=WHISPER_BATCH * GEN_TOKENS / decode_s,
        peak_memory_gb=peak_gb, launches=launches, decode_profile=profile,
        decode_profile_full_batch=profile_full,
        answer=out[0].tolist(), launcher=dict(
            argv="--arch whisper-base --prompt-len 64 --gen 16 --batch 2",
            seconds=launcher_s, launches=read_launches(),
            tokens=tokens.tolist()))
    emit("serve_whisper_decode_32k", **fields)
    return fields


def train_whisper() -> dict:
    """whisper-base's training at full width and depth through
    ``make_train_step``: train_4k's 4096 tokens with the batch cut to
    ``WHISPER_BATCH`` (1500 frames each) in 2 micro-batches with remat,
    AdamW with f32 master weights (the reference's plan below 3e10
    parameters), batches from ``batch_like`` (the reference's ``Trainer``
    cannot feed frames); ``WHISPER_STEPS`` steps, the losses finite, the
    embedding moved by weight decay alone (the hoisted gather gives it no
    gradient), a profiled step's idle share, and the state's checkpoint
    read back bit for bit through ``stacked_like``.  -> (the emitted
    fields, the first step's baseline for :func:`train_whisper_sharded`:
    its loss, norm and lr, and its state before and after, on the
    host)."""
    import shutil
    from repro_torch import tree
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import SHAPES
    from repro_torch.convert import stacked_like, stacked_params
    from repro_torch.models import batch_like
    from repro_torch.optim import get_optimizer
    from repro_torch.train.step import TrainPlan, make_train_step

    model = whisper_model()
    cfg = model.cfg
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=WHISPER_BATCH)
    plan = TrainPlan(n_micro=WHISPER_TRAIN_MICRO, q_chunk=2048, remat=True)
    opt = get_optimizer("adamw", master_weights=True)
    check(not callable(opt.lr), "whisper train: lr is a schedule")
    torch.cuda.reset_peak_memory_stats()
    params = stacked_params(model)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    step = make_train_step(model, opt, cfg, shape, plan)
    embed0 = state["opt"]["master"]["embed"].clone()
    baseline = dict(lr=opt.lr, before=tree.map_(host_copy, state))
    walls, losses = [], []
    for i in range(WHISPER_STEPS):
        batch = batch_like(cfg, shape, i)
        sec, (state, met) = timed_s(lambda: step(state, batch))
        walls.append(sec)
        losses.append(float(met["loss"]))
        if i == 0:
            baseline.update(loss=met["loss"].cpu(),
                            grad_norm=met["grad_norm"].cpu(),
                            state=tree.map_(host_copy, state))
    check(all(np.isfinite(losses)), f"whisper train: losses {losses}")
    m = embed0
    for _ in range(WHISPER_STEPS):
        m = m - opt.lr * (0.0 + opt.weight_decay * m)
    embed_ok = (not state["opt"]["m"]["embed"].any()
                and not state["opt"]["v"]["embed"].any()
                and bits_equal(state["opt"]["master"]["embed"], m)
                and bits_equal(state["params"]["embed"],
                               m.to(state["params"]["embed"].dtype)))
    check(embed_ok, "whisper train: the embedding moved by more than its "
          "decay")
    del m, embed0
    batch = batch_like(cfg, shape, WHISPER_STEPS)
    (state, met), prof = profiled_once(lambda: step(state, batch))
    prof["idle_share"] = max(0.0, 1.0 - prof["device_busy_s"] / walls[-1])
    losses.append(float(met["loss"]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    work = ROOT / "build" / "train_whisper"
    shutil.rmtree(work, ignore_errors=True)
    try:
        n = WHISPER_STEPS + 1
        save_s, _ = timed_s(lambda: ckpt.save(work, n, state))
        like_p = stacked_like(cfg)
        like = {"params": like_p, "opt": opt.init(like_p),
                "step": torch.zeros((), dtype=torch.int32, device="meta")}
        restore_s, (restored, _) = timed_s(
            lambda: ckpt.restore(work, n, like, device="cuda"))
        differ = trees_bits_equal(restored, state)
        check(not differ, f"whisper train: the restored state differs at "
              f"{differ}")
        n_bytes = (work / f"step_{n:08d}" / "arrays.npz").stat().st_size
    finally:
        shutil.rmtree(work, ignore_errors=True)
    fields = dict(
        arch=cfg.name, n_params=sum(t.numel() for t in
                                    tree.leaves(state["params"])),
        batch=[WHISPER_BATCH, shape.seq_len], frames=cfg.encoder_ctx,
        plan=dataclasses.asdict(plan), optimizer=dict(
            name="adamw", master_weights=True, lr=opt.lr,
            weight_decay=opt.weight_decay),
        losses=losses, step_wall_s=walls,
        tokens_per_s=WHISPER_BATCH * shape.seq_len / walls[-1],
        step_profile=prof, peak_gb=peak_gb, embed_decay_only=embed_ok,
        checkpoint=dict(bytes=n_bytes, save_s=save_s, restore_s=restore_s,
                        restored_bitwise=True))
    emit("train_whisper", **fields)
    del state, restored, model, step
    torch.cuda.empty_cache()
    return fields, baseline


# whisper-base's 2 x 2 step against its one-device step: the seed-0 state
# on train_whisper's plan and its first batch, on make_host_mesh(2, 2,
# device="cuda").  Each data shard computes the encoder's and decoder's
# self attention, the cross attention (4 of the 8 heads a position) and
# the FFN (1024 of 2048 columns) over its two "model" positions, and the
# head by vocab halves.  In bf16 (the model's type; the first one-device
# step of train_whisper is the baseline) and again in f32 (the same
# seed-0 draws), the discriminating check.  The loss and the gradient
# norm at relative errors ``loss`` and ``norm``, each leaf's AdamW first
# moment within a relative Frobenius error ``moment``, each parameter
# within 2 lr plus one ulp.  Each limit is twice what
# tools/model_axis_noise.py measured for the same step on an H100
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6), rounded up, and no
# less than 1e-6: whisper_full read loss 4.2e-7, norm 6.0e-4 and first
# moments 1.50% (one bf16 ulp of one decoder wq entry, whisper_ulp: loss
# 1.4e-6, norm 6.5e-5, moments 1.23%); whisper_full_f32 loss 8.4e-8, norm
# 8.7e-7, moments 9.8e-6
WHISPER_LIMITS = {
    "bfloat16": dict(loss=1e-6, norm=1.2e-3, moment=0.03),
    "float32": dict(loss=1e-6, norm=2e-6, moment=2e-5),
}


def whisper_train_setup(dtype: str):
    """(config, shape, plan) of whisper-base's training in ``dtype``:
    train_4k's 4096 tokens, ``WHISPER_BATCH`` sequences in
    ``WHISPER_TRAIN_MICRO`` micro-batches, remat."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.train.step import TrainPlan
    cfg = dataclasses.replace(get_config("whisper-base"), dtype=dtype)
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=WHISPER_BATCH)
    return cfg, shape, TrainPlan(n_micro=WHISPER_TRAIN_MICRO, q_chunk=2048,
                                 remat=True)


def train_whisper_one_device(dtype: str) -> dict:
    """One one-device AdamW step (f32 master weights) of whisper-base in
    ``dtype`` from the seed-0 state on ``batch_like(cfg, shape, 0)``, not
    profiled: the baseline :func:`train_whisper_sharded` is held against,
    as :func:`train_whisper`'s first step gives it in bf16."""
    import gc
    from repro_torch import tree
    from repro_torch.models import batch_like
    from repro_torch.optim import AdamW
    from repro_torch.train.step import make_train_step

    cfg, shape, plan = whisper_train_setup(dtype)
    opt = AdamW(master_weights=True)
    model, state = whole_train_state(cfg, opt)
    baseline = dict(lr=opt.lr, before=tree.map_(host_copy, state))
    step = make_train_step(model, opt, cfg, shape, plan)
    state, met = step(state, batch_like(cfg, shape, 0))
    check(np.isfinite(float(met["loss"])), f"whisper {dtype}: loss")
    baseline.update(loss=met["loss"].cpu(), grad_norm=met["grad_norm"].cpu(),
                    state=tree.map_(host_copy, state))
    del state, met, model, step
    gc.collect()
    torch.cuda.empty_cache()
    return baseline


def whisper_position_blocks(cfg, n_model: int) -> tuple[int, int, int]:
    """(the bytes a "model" position copies of one encoder layer, of one
    decoder layer, of the head once a step), from the shapes, with M
    dividing the heads and d_ff: its h / M heads' columns of ``wq``,
    ``wk``, ``wv`` and rows of ``wo`` (a decoder layer's ``xattn`` too),
    its d_ff / M columns of ``w1``, ``w3`` and rows of ``w2``, its Vp / M
    columns of ``head``."""
    w = getattr(torch, cfg.dtype).itemsize
    d = cfg.d_model
    attn = 2 * d * (cfg.n_heads + cfg.n_kv_heads) * cfg.dh // n_model
    ffn = 3 * d * cfg.d_ff // n_model
    return (w * (attn + ffn), w * (2 * attn + ffn),
            w * d * cfg.padded_vocab // n_model)


def train_whisper_sharded(dtype: str, baseline: dict, profile: bool
                          ) -> dict:
    """The 2 x 2 step of whisper-base in ``dtype`` (``make_train_step`` on
    ``make_host_mesh(2, 2, device="cuda")``, the state ``baseline``'s
    seed-0 state cut into its blocks; whisper has no ``Trainer``) on the
    one-device step's batch, held against ``baseline`` under
    ``WHISPER_LIMITS``; each position's gathered bytes of every encoder
    and decoder layer and of the head against
    :func:`whisper_position_blocks`, exactly; the encoder's gathered
    layers alive until the backward (at most ``encoder_layers + 1`` at
    once), none after; the row products among ``from_model_adds``.  With
    ``profile`` the step is profiled (device-busy seconds, launches) and
    a warm step timed.  -> the fields."""
    import gc
    from repro_torch import tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import batch_like, build_model
    from repro_torch.optim import AdamW
    from repro_torch.train import sharding as sh
    from repro_torch.train.step import make_train_step

    what = f"whisper {dtype} sharded"
    limits = WHISPER_LIMITS[dtype]
    cfg, shape, plan = whisper_train_setup(dtype)
    mesh = make_host_mesh(*SHARDED_MESH, device="cuda")
    opt = AdamW(master_weights=True)
    check(opt.lr == baseline["lr"], f"{what}: not the one-device step's "
          f"AdamW")
    state = sh.shard_state(tree.map_(lambda t: t.to("cuda"),
                                     baseline["before"]), mesh)
    step = make_train_step(build_model(cfg, device="meta"), opt, cfg, shape,
                           plan, mesh=mesh)
    batch = batch_like(cfg, shape, 0)
    torch.cuda.reset_peak_memory_stats()
    (state, met), first = recurrent_step(lambda: step(state, batch), profile)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = dict(step.stats)
    stats.pop("accumulator_bytes")
    loss_err = abs(float(met["loss"]) - float(baseline["loss"])) / abs(
        float(baseline["loss"]))
    norm_err = abs(float(met["grad_norm"]) - float(baseline["grad_norm"])
                   ) / abs(float(baseline["grad_norm"]))
    rule = sharded_vs_one_device(state, baseline["state"], baseline["lr"],
                                 limits["moment"])
    rule_ok = (loss_err <= limits["loss"] and norm_err <= limits["norm"]
               and not rule["outside"])
    n_model = mesh.shape["model"]
    enc_layer, dec_layer, head = whisper_position_blocks(cfg, n_model)
    want_layers = {**{f"enc.{i}": enc_layer
                      for i in range(cfg.encoder_layers)},
                   **{f"dec.{i}": dec_layer for i in range(cfg.n_layers)}}
    positions = stats.pop("positions")
    per_micro = cfg.encoder_layers + 2 * cfg.n_layers   # decoder remat'd
    per_position_ok = all(
        p["layer_bytes"] == want_layers and p["once_bytes"] == head
        and p["gathers"] == per_micro * p["micro_batches"]
        and p["max_live_layers"] <= cfg.encoder_layers + 1
        and p["live_after"] == 0 for p in positions)
    # each micro-batch's forward adds the row products of every encoder
    # layer (wo, w2) and decoder layer (wo, xattn wo, w2); the remat'd
    # decoder adds more in its recompute
    row_products = WHISPER_TRAIN_MICRO * (2 * cfg.encoder_layers
                                          + 3 * cfg.n_layers)
    adds = stats["from_model_adds"]
    adds_ok = adds >= row_products
    fields = dict(
        arch=cfg.name, dtype=dtype, mesh=repr(mesh),
        data_shards=len(sh.batch_devices(mesh)), model_ways=n_model,
        plan=dataclasses.asdict(plan), batch=[WHISPER_BATCH, shape.seq_len],
        frames=cfg.encoder_ctx,
        loss=float(met["loss"]), loss_one_device=float(baseline["loss"]),
        loss_rel_err=loss_err, grad_norm=float(met["grad_norm"]),
        grad_norm_one_device=float(baseline["grad_norm"]),
        grad_norm_rel_err=norm_err, state=rule,
        rule=dict(limits, param="2 lr + 1 ulp"), gather=stats,
        positions=[dict(p, layer_bytes=sorted(set(
            p["layer_bytes"].values()))) for p in positions],
        position_enc_layer_bytes=enc_layer,
        position_dec_layer_bytes=dec_layer, position_head_bytes=head,
        per_position_ok=per_position_ok, row_products=row_products,
        adds_ok=adds_ok, peak_gb=peak_gb, **first)
    if not (rule_ok and per_position_ok and adds_ok):
        emit("train_whisper_sharded_failed", **fields)
    check(rule_ok, f"{what}: loss {float(met['loss'])} against "
          f"{float(baseline['loss'])}, norm {float(met['grad_norm'])} "
          f"against {float(baseline['grad_norm'])}, limits {limits}, "
          f"state {rule}")
    check(per_position_ok, f"{what}: a position's gathers are not its "
          f"regions ({enc_layer} B an encoder layer, {dec_layer} B a "
          f"decoder layer, {head} B of head), or gathered layers outlived "
          f"their use: {fields['positions']}")
    check(adds_ok, f"{what}: {adds} row-product adds, want at least "
          f"{row_products}")
    if profile:
        warm_s, (state, met) = timed_s(lambda: step(state, batch))
        check(np.isfinite(float(met["loss"])), f"{what}: warm loss")
        fields.update(warm_fields(first, warm_s))
        fields["tokens_per_s"] = WHISPER_BATCH * shape.seq_len / warm_s
    del state, met, step
    gc.collect()
    torch.cuda.empty_cache()
    return fields


def train_whisper_sharded_phase(one_device: dict, baseline: dict) -> dict:
    """``train_whisper_sharded``'s line: the bf16 2 x 2 step against
    ``baseline`` (:func:`train_whisper`'s first step, whose profiled
    repeat ``one_device`` gives the one-device busy seconds, launches,
    idle share and peak beside it), then the f32 one-device and 2 x 2
    steps; the phase's seconds."""
    t0 = time.perf_counter()
    bf16 = train_whisper_sharded("bfloat16", baseline, True)
    prof = one_device["step_profile"]
    bf16["one_device"] = dict(
        device_busy_s=prof["device_busy_s"],
        device_launches=prof["device_launches"],
        idle_share=prof["idle_share"], peak_gb=one_device["peak_gb"])
    del baseline
    t1 = time.perf_counter()
    f32 = train_whisper_sharded("float32", train_whisper_one_device(
        "float32"), False)
    fields = dict(bfloat16=bf16, float32=f32,
                  float32_seconds=time.perf_counter() - t1,
                  seconds=time.perf_counter() - t0)
    emit("train_whisper_sharded", **fields)
    return fields


def chi2_p(counts: np.ndarray) -> float:
    """The p-value of Pearson's chi-square test that ``counts`` come from
    a uniform draw over their cells (the regularised upper incomplete
    gamma function of (cells - 1) / 2 and half the statistic)."""
    expected = counts.sum() / len(counts)
    stat = float(((counts - expected) ** 2 / expected).sum())
    return float(torch.special.gammaincc(
        torch.tensor((len(counts) - 1) / 2, dtype=torch.float64),
        torch.tensor(stat / 2, dtype=torch.float64)))


def topic_corpus(vocab: int, seed: int = 0) -> np.ndarray:
    """(SAMPLER_DOCS, SAMPLER_SEQ) int32 tokens, drawn on the card and
    brought to the host: each document a topic of ``SAMPLER_TOPICS``, each
    token one of its topic's ``SAMPLER_TOPIC_WORDS`` words or, with
    probability ``SAMPLER_NOISE``, any of ``vocab``
    (tests/test_torch_data_pipeline.py's corpus at size)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(high, size):
        return torch.randint(0, high, size, generator=g, device="cuda")

    n, s = SAMPLER_DOCS, SAMPLER_SEQ
    topic = draw(SAMPLER_TOPICS, (n, 1))
    words = draw(vocab, (SAMPLER_TOPICS, SAMPLER_TOPIC_WORDS))
    pick = words[topic, draw(SAMPLER_TOPIC_WORDS, (n, s))]
    noise = torch.rand((n, s), generator=g, device="cuda") < SAMPLER_NOISE
    return torch.where(noise, draw(vocab, (n, s)), pick).int().cpu().numpy()


def cluster_balanced_sampler() -> dict:
    """``data/pipeline.py`` on the card: the corpus's sketches
    (``doc_sketch``), ``ClusterBalancedSampler(n_clusters=1024, n_sub=64,
    compression=5)`` (the sampled k-means, then each document's nearest
    center), with the Lloyd and assignment launches and their shapes;
    the same fit again under the profiler (the card's busy share of the
    fit, and the same labels: the fit is deterministic in its seed); the
    assignment kernel at the fit's own launch (every document against
    the fitted centers) held against the plain version (near-ties within
    ``dot_rounding_bound``); ``SAMPLER_DRAWS`` drawn documents whose
    clusters pass a chi-square test of a uniform draw; with a landmark
    spec on the first 65,536 documents, the assignment kernel's labels
    against the plain version's on the card; one reduced-llama
    ``Trainer`` step fed by ``sampler.batch``, as ``examples/train_lm.py
    --cluster-sampling`` does."""
    import shutil
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core import ClusterSpec
    from repro_torch.data import ClusterBalancedSampler, doc_sketch
    from repro_torch.kernels import assign, ref
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.step import TrainPlan
    from repro_torch.train.trainer import Trainer, TrainerConfig

    llama = get_config("llama3-8b")
    make_s, docs = timed_s(lambda: topic_corpus(llama.vocab))
    sketch_s, sk = timed_s(lambda: doc_sketch(docs))
    check(sk.shape == (SAMPLER_DOCS, 32) and sk.device.type == "cuda"
          and bool(torch.isfinite(sk).all()), "bad sketches")
    norms = torch.linalg.vector_norm(sk, dim=1)
    check(bool(((norms - 1).abs() < 1e-5).all()), "sketches not unit norm")
    del norms

    def fit():
        return ClusterBalancedSampler(
            docs, n_clusters=SAMPLER_CLUSTERS, n_sub=SAMPLER_SUB,
            compression=SAMPLER_COMPRESSION, seed=0)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with ShapeRecorder("lloyd_step") as lrec, \
            ShapeRecorder("assign_argmin") as arec:
        sampler_s, sampler = timed_s(fit)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches["lloyd_step"] > 0 and launches["assign_argmin"] > 0,
          f"the sampler skipped a kernel: {launches}")
    again, prof = profiled_once(fit)
    check(np.array_equal(again.assignment, sampler.assignment),
          "the sampler's fit is not deterministic in its seed")
    prof["busy_share"] = prof["device_busy_s"] / sampler_s
    prof["idle_share"] = max(0.0, 1.0 - prof["busy_share"])
    del again
    sizes = np.bincount(sampler.assignment, minlength=SAMPLER_CLUSTERS)
    check(sampler.assignment.shape == (SAMPLER_DOCS,)
          and sum(len(c) for c in sampler.by_cluster) == SAMPLER_DOCS,
          "the sampler lost documents")
    # the fit's assignment launch: every document against the centers
    x, c = sk[None], sampler.centers[None]
    idx, _ = assign.assign_argmin(x, c)
    check(np.array_equal(idx[0].cpu().numpy(), sampler.assignment),
          "the sampler's labels are not the assignment kernel's")
    full_case = assign_parity("assign_sampler_"
                              + "x".join(map(str, list(x.shape[:2])
                                             + [c.shape[1], x.shape[2]])),
                              x, c)
    del sk, x, c, idx
    torch.cuda.empty_cache()
    draw_s, ids = timed_s(lambda: sampler.batch_indices(0, SAMPLER_DRAWS))
    drawn = np.bincount(sampler.assignment[ids],
                        minlength=SAMPLER_CLUSTERS)[sizes > 0]
    p = chi2_p(drawn)
    check(p > CHI2_P_MIN, f"cluster draws not uniform: p = {p}")
    # the landmark spec: no random draw in the fit
    lm_spec = ClusterSpec.make(SAMPLER_CLUSTERS, n_sub=SAMPLER_SUB,
                               compression=SAMPLER_COMPRESSION,
                               init="landmark", backend="cuda_fused")
    sub = docs[:SAMPLER_LANDMARK_DOCS]
    lm = ClusterBalancedSampler(sub, spec=lm_spec, seed=0)
    x = doc_sketch(sub)[None]
    c = lm.centers[None]
    idx, dist = assign.assign_argmin(x, c)
    check(np.array_equal(idx[0].cpu().numpy(), lm.assignment),
          "the landmark sampler's labels are not the assignment kernel's")
    ridx, rdist = ref.assign_argmin_ref(x, c)
    near_ties = _check_assignment("sampler_landmark", x, c, idx, dist, ridx,
                                  rdist, dot_rounding_bound(x, c))
    # one Trainer step fed by the sampler (llama3-8b reduced, at its vocab)
    cfg = dataclasses.replace(llama.reduced(), vocab=llama.vocab)
    shape = ShapeConfig("sampler_train", SAMPLER_TRAIN_SEQ,
                        SAMPLER_TRAIN_BATCH, "train")
    work = ROOT / "build" / "sampler_train"
    shutil.rmtree(work, ignore_errors=True)
    try:
        trainer = Trainer(cfg, shape, make_host_mesh(1, 1), TrainerConfig(
            steps=1, ckpt_every=1, ckpt_dir=str(work), log_every=1),
            plan=TrainPlan(n_micro=2, q_chunk=SAMPLER_TRAIN_SEQ),
            batch_fn=lambda step: sampler.batch(step, SAMPLER_TRAIN_BATCH,
                                                SAMPLER_TRAIN_SEQ))
        train_s, (_, hist) = timed_s(trainer.run)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check(len(hist) == 1 and np.isfinite(hist[0]),
          f"sampler-fed train step: {hist}")
    fields = dict(
        docs=SAMPLER_DOCS, seq=SAMPLER_SEQ, vocab=llama.vocab,
        topics=SAMPLER_TOPICS, topic_words=SAMPLER_TOPIC_WORDS,
        noise=SAMPLER_NOISE, corpus_mb=docs.nbytes / 1e6,
        make_corpus_s=make_s, sketch_s=sketch_s, sampler_s=sampler_s,
        fit_and_assign_s=sampler_s - sketch_s, fit_profile=prof,
        peak_memory_gb=peak_gb,
        n_clusters=SAMPLER_CLUSTERS, non_empty=int((sizes > 0).sum()),
        cluster_sizes=dict(min=int(sizes[sizes > 0].min()),
                           max=int(sizes.max()),
                           median=float(np.median(sizes[sizes > 0]))),
        launches=launches,
        lloyd_shapes=[dict(shape=list(k), calls=n)
                      for k, n in lrec.shapes.items()],
        assign_shapes=[dict(shape=list(k), calls=n)
                       for k, n in arec.shapes.items()],
        assign_parity=full_case,
        draws=SAMPLER_DRAWS, draw_s=draw_s, chi2_p=p,
        landmark=dict(docs=SAMPLER_LANDMARK_DOCS,
                      labels_at_near_ties=near_ties),
        train_step=dict(arch=cfg.name, vocab=cfg.vocab,
                        batch=[SAMPLER_TRAIN_BATCH, SAMPLER_TRAIN_SEQ],
                        loss=hist[0], seconds=train_s))
    emit("cluster_balanced_sampler", **fields)
    fields["lloyd_rec"], fields["assign_rec"] = lrec, arec
    del docs, sampler, lm, x, c
    torch.cuda.empty_cache()
    return fields


def paper_table1() -> dict:
    """The paper's Table 1 through the port's ``sampled_kmeans`` on the
    card: ``surrogate_iris`` and ``surrogate_seeds``, both schemes, 6
    subclusters, compression 6; the relative SSE against
    ``standard_kmeans(iters=40)``, its mean over ``TABLE1_SEEDS`` below
    ``TABLE1_REL_MAX`` and each seed's below ``TABLE1_WORST_MAX``.  The
    Lloyd launches' shapes are recorded with the inputs of the first call
    at each (``lloyd_rec``), for the parity check against the plain
    version."""
    from repro_torch.core import (ClusterSpec, relative_error,
                                  sampled_kmeans, standard_kmeans)
    from repro_torch.data import surrogate_iris, surrogate_seeds
    rows = []
    reset_launches()
    t0 = time.perf_counter()
    with ShapeRecorder("lloyd_step", keep=True) as rec:
        for name, data in (("iris", surrogate_iris),
                           ("seeds", surrogate_seeds)):
            x, _ = data()
            full = float(standard_kmeans(x, 3, iters=40).sse)
            for scheme in ("equal", "unequal"):
                spec = ClusterSpec.make(3, scheme=scheme, n_sub=6,
                                        compression=6)
                rels = [relative_error(float(sampled_kmeans(
                    x, 3, spec=spec, seed=seed).sse), full)
                    for seed in TABLE1_SEEDS]
                rows.append(dict(dataset=name, scheme=scheme,
                                 mean_rel=float(np.mean(rels)),
                                 max_rel=max(rels), rels=rels))
                check(np.mean(rels) < TABLE1_REL_MAX
                      and max(rels) < TABLE1_WORST_MAX,
                      f"Table 1 {name} {scheme}: relative errors {rels}")
        torch.cuda.synchronize()
    launches = read_launches()
    check(launches["lloyd_step"] > 0, f"Table 1 skipped the Lloyd kernel: "
          f"{launches}")
    fields = dict(rows=rows, seeds=len(TABLE1_SEEDS), limit=TABLE1_REL_MAX,
                  worst_limit=TABLE1_WORST_MAX,
                  seconds=time.perf_counter() - t0, launches=launches,
                  lloyd_shapes=[dict(shape=list(k), calls=n)
                                for k, n in sorted(rec.shapes.items())])
    emit("paper_table1", **fields)
    fields["lloyd_rec"] = rec
    return fields


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import SampledKMeans
    from repro_torch.core import (ClusterSpec, equal_partition,
                                  feature_scale, relative_error,
                                  standard_kmeans)
    from repro_torch.data import blobs
    from repro_torch.kernels import (assign, build, centroid, cluster_attn,
                                     lloyd, ref, scan, tiles)
    from repro_torch.roofline.analysis import (
        issue_floor_ms, kernel_bound_ms, kernel_dims, pair_bound_ms,
        tc_lo_blocks)
    from repro_torch.telemetry import RecordingLogger

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    # -- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    sm_clock_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    emit("device", kind=kind, capability=list(cap), nvidia_smi=smi,
         max_sm_clock_hz=sm_clock_hz, torch=torch.__version__,
         cuda=torch.version.cuda)
    check(cap == (9, 0), f"needs an sm_90 card, got {cap}")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    build.build()
    ptxas = {n: [ln.strip() for ln in build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in build.SOURCES}
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    # -- 3. kernel parity at the main path's shapes -------------------------
    local = _case(64, 7813, 1562, 2, seed=1)
    merge = _case(4, 99968, 1000, 2, share_x=True, seed=2)
    cases = [lloyd_parity("lloyd_local", *local),
             lloyd_parity("lloyd_merge", *merge),
             lloyd_parity("lloyd_d16", *_case(3, 1000, 77, 16, seed=3)),
             lloyd_parity("lloyd_d64", *_case(2, 517, 300, 64, seed=4)),
             lloyd_parity("lloyd_d200", *_case(1, 300, 50, 200, seed=5)),
             lloyd_parity("lloyd_bf16", *_case(2, 5000, 100, 8, seed=6,
                                               dtype=torch.bfloat16))]
    # the PQ codebook fits: all subspaces as lanes, 1-D codebooks of 256
    pq200k = _case(64, 32768, 256, 1, seed=10)
    pq5m = _case(32, 65536, 256, 1, seed=11)
    cases += [lloyd_parity("lloyd_pq_200k", *pq200k),
              lloyd_parity("lloyd_pq_5m", *pq5m)]
    predict_x = torch.rand((1, 500_000, 2), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(7))
    predict_c = predict_x[:, ::500].contiguous()          # 1000 centers
    cases += [assign_parity("assign_predict", predict_x, predict_c),
              assign_parity("assign_merge_final", merge[0], merge[2]),
              assign_parity("assign_d64", *_case(2, 517, 300, 64, seed=8)[::2]),
              assign_parity("assign_bf16",
                            *_case(2, 5000, 100, 8, seed=9,
                                   dtype=torch.bfloat16)[::2]),
              # d = 256, gemma3's head width: the tensor-core route with
              # both operands streamed as TF32 planes (section 12 times it)
              assign_parity("assign_d256",
                            *_case(1, 500_000, 1000, 256, seed=26)[::2])]
    identity = [assign_lloyd_identity("predict", predict_x, predict_c),
                assign_lloyd_identity("local", local[0], local[2]),
                assign_lloyd_identity("merge", merge[0], merge[2])]
    cases += [centroid_parity("centroid_local", *local),
              centroid_parity("centroid_merge", *merge),
              centroid_parity("centroid_pq_200k", *pq200k),
              centroid_parity("centroid_pq_5m", *pq5m),
              centroid_parity("centroid_d64", *_case(2, 517, 300, 64,
                                                     seed=12)),
              centroid_parity("centroid_bf16",
                              *_case(2, 5000, 100, 8, seed=13,
                                     dtype=torch.bfloat16))]
    g = torch.Generator("cuda").manual_seed(14)
    luts16 = torch.rand((64, 64, 16), generator=g, device="cuda")
    codes16 = torch.randint(0, 16, (64, 1500, 64), generator=g,
                            device="cuda", dtype=torch.uint8)
    cases += [scan_parity("scan_bits4", luts16, codes16),
              scan_parity("scan_bits4_int32_codes", luts16, codes16.int()),
              scan_parity("scan_bits4_bf16", luts16.bfloat16(), codes16)]
    # the serving path: the refresh's Lloyd pass and value update on 4 of
    # its 256 lanes (9216 pool points, K=8192, d=128; the plain version
    # forms the (B, M, K) distances), and the cluster attention at
    # long_500k, ragged Nc, half the slots dead (poisoned) and all dead
    refresh = _case(4, 9216, 8192, 128, seed=19)
    cases += [lloyd_parity("lloyd_refresh_4_lanes", *refresh,
                           cancel=dot_rounding_bound(refresh[0],
                                                     refresh[2])),
              centroid_parity("centroid_refresh_4_lanes", *refresh)]
    # the served pool's points are bf16 keys upcast to f32, exact in TF32:
    # every tensor-core block takes its two-pass branch
    refresh_bf16 = (refresh[0].bfloat16().float(), *refresh[1:])
    check(not tc_lo_blocks(refresh_bf16[0]).any(),
          "bf16-valued points: a block would take three passes")
    cases += [lloyd_parity("lloyd_refresh_4_lanes_bf16_points",
                           *refresh_bf16,
                           cancel=dot_rounding_bound(refresh_bf16[0],
                                                     refresh_bf16[2]))]
    # the first refresh of an empty cache: 8192 zero centers (w = 0 in the
    # pool) and 1024 window keys; every distance to a center ties, and the
    # labels must be the plain version's exactly (all 0)
    zx, zw, _ = _case(4, 1024, 1, 128, seed=24)
    zc = torch.zeros((4, 8192, 128), device="cuda")
    zpool = torch.cat([zc, zx], 1)
    zpw = torch.cat([torch.zeros((4, 8192), device="cuda"),
                     torch.ones_like(zw)], 1)
    zero_case = lloyd_parity("lloyd_refresh_zero_centers", zpool, zpw, zc,
                             cancel=dot_rounding_bound(zpool, zc))
    check(zero_case["labels_at_near_ties"] == 0,
          "zero centers: labels differ from the plain version's")
    cases.append(zero_case)
    # the served refresh's value update: all 256 lanes (the 4 lanes above,
    # 64 times over)
    refresh_ids, _ = assign.assign_argmin(refresh[0], refresh[2])
    refresh256 = tuple(t.repeat(64, *[1] * (t.dim() - 1))
                       for t in (refresh[0], refresh_ids, refresh[1]))
    cases += [centroid_ids_parity("centroid_refresh_256_lanes", *refresh256,
                                  8192)]
    cases += centroid_worst_cases()
    # the Lloyd kernel's routes at these shapes, and the SIMT route's grid:
    # every block resident at once (the runtime's occupancy, registers
    # included, against the shared-memory and thread reckoning of tiles.py)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = []
    for name, (xx, _, cc) in (("local", local), ("merge", merge),
                              ("pq_200k", pq200k), ("refresh", refresh)):
        bb, mm, dd = xx.shape
        kk = cc.shape[1]
        route = tiles.lloyd_route(kk, dd)
        plan = dict(shape=name, b=bb, m=mm, k=kk, d=dd, route=route)
        if route == "simt":
            per_sm, smem = lloyd.simt_occupancy(kk, dd)
            g = tiles.lloyd_blocks(bb, mm, kk, dd, sms, per_sm)
            check(smem == tiles.lloyd_simt_smem_bytes(kk, dd)
                  and per_sm <= tiles.blocks_per_sm(smem)
                  and bb * g <= per_sm * sms,
                  f"lloyd {name}: the SIMT grid outgrows the card")
            plan.update(smem=smem, per_sm=per_sm,
                        per_sm_by_smem=tiles.blocks_per_sm(smem),
                        blocks=bb * g, slots=per_sm * sms)
        else:
            plan.update(smem=tiles.tc_smem_bytes(dd),
                        blocks=bb * -(-mm // tiles.TC_ROWS))
        plans.append(plan)
    check([p["route"] for p in plans] == ["simt", "simt", "simt", "tc"],
          f"lloyd routes: {plans}")
    scale = 128 ** -0.5
    serve_attn = attn_case(1, 32, 8, 8192, 128, dtype=torch.bfloat16,
                           seed=15)
    cases += [attn_parity("attn_long_500k_f32",
                          *attn_case(1, 32, 8, 8192, 128, seed=15), scale),
              attn_parity("attn_long_500k_bf16", *serve_attn, scale),
              attn_parity("attn_ragged_f32",
                          *attn_case(4, 32, 8, 1000, 128, seed=16), scale),
              attn_parity("attn_ragged_bf16",
                          *attn_case(4, 32, 8, 1000, 128, seed=16,
                                     dtype=torch.bfloat16), scale)]
    q, kc, vc, cnt = attn_case(1, 32, 8, 8192, 128, dtype=torch.bfloat16,
                               seed=17)
    cnt[..., 1::2] = 0.0
    poisoned = vc.clone()
    poisoned[..., 1::2, :] = 1e6
    check(torch.equal(cluster_attn.cluster_attn_decode(q, kc, vc, cnt, scale),
                      cluster_attn.cluster_attn_decode(q, kc, poisoned, cnt,
                                                       scale)),
          "poisoned dead centroids changed the output")
    cases += [attn_parity("attn_half_dead_poisoned", q, kc, poisoned, cnt,
                          scale)]
    attn_kernels = attn_kernels_per_call(serve_attn, scale)
    check(attn_kernels == ["cluster_attn_kernel"],
          f"cluster_attn_partial launched {attn_kernels}, not one kernel")
    q, kc, vc, cnt = attn_case(2, 32, 8, 1024, 128, seed=18)
    cnt[0] = 0.0
    _, m_dead, l_dead = cluster_attn.cluster_attn_partial(q, kc, vc, cnt,
                                                          scale)
    check(bool((m_dead[0] == ref.NEG).all() and (l_dead[0] == 1024).all()),
          "an all-dead row's state is not (NEG, Nc)")
    cases += [attn_parity("attn_all_dead_row", q, kc, vc, cnt, scale)]
    # zamba2's shared attention: dh = 80 (10 pieces of 16 bytes in bf16,
    # 20 in f32, on 16 and 32 lanes a row), one query head a kv head; and
    # dh = 80 at four heads a kv head, ragged Nc
    zamba_attn = attn_case(1, 32, 32, 8192, 80, dtype=torch.bfloat16,
                           seed=36)
    cases += [attn_parity("attn_zamba_dh80_f32",
                          *attn_case(1, 32, 32, 8192, 80, seed=36),
                          80 ** -0.5),
              attn_parity("attn_zamba_dh80_bf16", *zamba_attn, 80 ** -0.5),
              attn_parity("attn_dh80_g4_f32",
                          *attn_case(2, 16, 4, 777, 80, seed=37),
                          80 ** -0.5),
              attn_parity("attn_dh80_g4_bf16",
                          *attn_case(2, 16, 4, 777, 80, seed=37,
                                     dtype=torch.bfloat16), 80 ** -0.5)]
    attn_kernels = attn_kernels_per_call(zamba_attn, 80 ** -0.5)
    check(attn_kernels == ["cluster_attn_kernel"],
          f"cluster_attn_partial at dh = 80 launched {attn_kernels}")
    torch.cuda.synchronize()
    emit("parity", cases=cases, lloyd_plans=plans,
         assign_vs_lloyd_simt=identity)

    # -- 4. main path: SampledKMeans fit + predict at paper_500k ------------
    spec = ClusterSpec.from_dict(json.loads(SPEC_FILE.read_text())
                                 ["cluster_spec"])
    pts, _, _ = blobs(500_000, dim=2, seed=0)
    x = torch.from_numpy(pts).cuda()
    # warm-up, same seed; the shapes of its assignment calls
    with ShapeRecorder("assign_argmin") as fused_assign, \
            ShapeRecorder("lloyd_step") as fused_lloyd:
        warm = SampledKMeans(spec).fit(x, seed=0)
        warm.predict(x)
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    est = SampledKMeans(spec).fit(x, seed=0)
    labels = est.predict(x)
    torch.cuda.synchronize()
    fit_predict_s = time.perf_counter() - t0
    launches = read_launches()
    check(launches["lloyd_step"] > 0 and launches["assign_argmin"] > 0,
          f"the main path skipped a kernel: {launches}")

    check(est.centers_.shape == (1000, 2)
          and bool(torch.isfinite(est.centers_).all()), "bad centers")
    check(labels.shape == (500_000,) and int(labels.min()) >= 0
          and int(labels.max()) < 1000, "bad labels")
    sse = float(est.sse_)
    check(np.isfinite(sse) and sse > 0, "bad sse")
    # the labels are the nearest centers (plain check on a sample)
    sample = x[::97]
    ref_idx, _ = ref.assign_argmin_ref(sample[None], est.centers_[None])
    agree = float((labels[::97] == ref_idx[0]).float().mean())
    check(agree > 0.999, f"predict disagrees with the plain assignment "
          f"({agree})")

    # where the fit's time goes: the stage timers of a logged fit (a timer
    # synchronises the card), which must equal the unlogged fit bit for bit
    log = RecordingLogger()
    logged = SampledKMeans(spec, logger=log).fit(x, seed=0)
    check(torch.equal(logged.centers_, est.centers_),
          "a logged fit differs from the unlogged one")
    stages = {e["name"]: e["dur"] for e in log.events if e["kind"] == "timer"}

    t0 = time.perf_counter()
    std = standard_kmeans(x, 1000, iters=10, seed=0)
    torch.cuda.synchronize()
    std_s = time.perf_counter() - t0
    rel = relative_error(sse, float(std.sse))
    check(rel < 0.10, f"sampled SSE {sse} vs standard {float(std.sse)}: "
          f"relative error {rel}")
    emit("main_path", spec=SPEC_FILE.name, n=500_000, k=1000,
         fit_predict_s=fit_predict_s, standard_kmeans_s=std_s,
         sampled_sse=sse, standard_sse=float(std.sse), relative_error=rel,
         launches=launches, predict_agreement=agree, stage_s=stages)

    # -- 5. exact check on the card: kernels vs plain, landmark spec --------
    # landmark init draws nothing, so the two backends differ only in
    # arithmetic.  At paper_500k's own sizes (~5 points per local center in
    # the unit box) the expanded-form distance keeps only a few of fp32's
    # bits of the gap between neighbouring centers, so assignments there are
    # rounding-noise-dominated (in the JAX package too): that comparison is
    # reported, not checked.  The checked one keeps the 500k points and the
    # 64 equal partitions with coarse centers (3 per partition, k=20).
    def landmark(compression, k):
        return spec.replace(
            local=dataclasses.replace(spec.local, init="landmark",
                                      compression=compression),
            merge=dataclasses.replace(spec.merge, init="landmark", k=k))

    def both_backends(lm):
        return [SampledKMeans(lm.replace(backend=be)).fit(x, seed=0).result_
                for be in ("cuda_fused", "torch")]

    a, b = both_backends(landmark(2000, 20))
    part = equal_partition(feature_scale(x)[0], 64)
    check(torch.equal(a.local_weights.view(64, -1).sum(1),
                      b.local_weights.view(64, -1).sum(1))
          and torch.equal(a.local_weights.view(64, -1).sum(1),
                          part.mask.sum(1).float()),
          "partitions differ between backends")
    rel_exact = abs(float(a.sse) - float(b.sse)) / float(b.sse)
    check(rel_exact <= 1e-4,
          f"landmark SSE: kernels {float(a.sse)} vs plain {float(b.sse)}")
    pa, pb = both_backends(landmark(spec.local.compression, spec.merge.k))
    emit("landmark_exact", sse_kernels=float(a.sse), sse_plain=float(b.sse),
         rel=rel_exact,
         max_center_diff=float((a.centers - b.centers).abs().amax()),
         max_local_center_diff=float(
             (a.local_centers - b.local_centers).abs().amax()),
         paper_sizes_unchecked=dict(
             sse_kernels=float(pa.sse), sse_plain=float(pb.sse),
             rel=abs(float(pa.sse) - float(pb.sse)) / float(pb.sse)))

    # -- 6. determinism: the warm-up and the timed fit share a seed ---------
    check(torch.equal(warm.centers_, est.centers_)
          and torch.equal(warm.sse_, est.sse_),
          "two kmeans++ fits with one seed differ")
    emit("determinism", bit_identical=True)

    # -- 7. the unfused cuda backend at paper_500k --------------------------
    cuda_spec = spec.replace(backend="cuda")
    with ShapeRecorder("assign_argmin") as cuda_assign:
        warm_cuda = SampledKMeans(cuda_spec).fit(x, seed=0)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    est_cuda = SampledKMeans(cuda_spec).fit(x, seed=0)
    torch.cuda.synchronize()
    cuda_fit_s = time.perf_counter() - t0
    cuda_launches = read_launches()
    check(cuda_launches["centroid_update"] > 0
          and cuda_launches["assign_argmin"] > 0
          and cuda_launches["lloyd_step"] == 0,
          f"the cuda backend skipped a kernel: {cuda_launches}")
    cuda_sse = float(est_cuda.sse_)
    cuda_rel = relative_error(cuda_sse, float(std.sse))
    check(cuda_rel < 0.10, f"cuda backend SSE {cuda_sse} vs standard "
          f"{float(std.sse)}: relative error {cuda_rel}")
    check(torch.equal(warm_cuda.centers_, est_cuda.centers_)
          and torch.equal(warm_cuda.sse_, est_cuda.sse_),
          "two kmeans++ fits with one seed differ (cuda backend)")
    coarse = landmark(2000, 20)
    ua, ub = (SampledKMeans(coarse.replace(backend=be)).fit(x, seed=0).result_
              for be in ("cuda", "cuda_fused"))
    unfused_rel = abs(float(ua.sse) - float(ub.sse)) / float(ub.sse)
    check(unfused_rel <= 1e-4, f"landmark SSE: cuda {float(ua.sse)} vs "
          f"cuda_fused {float(ub.sse)}")
    # where the two backends part: one step from the same centers
    trace = [backend_step_trace("local", *local),
             backend_step_trace("merge", *merge),
             backend_step_trace("landmark_local",
                                *_case(64, 7813, 4, 2, seed=27))]
    emit("cuda_backend", fit_s=cuda_fit_s, launches=cuda_launches,
         landmark_trace=trace,
         sse=cuda_sse, standard_sse=float(std.sse), relative_error=cuda_rel,
         bit_identical=True, landmark_sse_cuda=float(ua.sse),
         landmark_sse_cuda_fused=float(ub.sse), landmark_rel=unfused_rel)

    # -- 7a. cuda_tuned (auto) against cuda_fused at paper_500k -------------
    tuned = tune_backends(x, spec, float(std.sse), est)

    # -- 7b. the out-of-core executor, the streaming engine and mini-batch
    # Lloyd: the one-chunk pin, paper_500k with a mini-batch merge,
    # oocore_5m (auto, cuda) and its flush run, stream_5m,
    # stream_drift
    chunked_one_chunk_pin(x, spec, est.result_)
    mb = minibatch_500k(x, spec, sse)

    # -- 7c. the multi-device executors: one line with the cards and each
    # phase's mesh, then paper_500k over 4 shards and its exact check
    emit("meshes", device_count=torch.cuda.device_count(),
         meshes={name: [str(d) for d in phase_mesh(n).devices.flat]
                 for name, n in MESH_SHARDS.items()},
         cross_device=cross_device_check())
    sm = shard_map_500k(x, spec, float(std.sse), est.result_)
    sm_exact = shard_map_landmark_exact(x, coarse)
    del x
    torch.cuda.empty_cache()
    oo = oocore_5m()
    oo_exact = oo.pop("exact_sse")
    st5 = stream_5m(oo_exact)
    pin1 = chunked_dist_one_shard_pin(oo["est"].result_)
    st5s = stream_5m_sharded(dict(chunked=oo_exact, unsharded=st5["sse"]))
    drift = stream_drift()
    torch.cuda.empty_cache()
    cd50 = chunked_dist_50m()
    torch.cuda.empty_cache()
    # the kernels at these paths' shapes against their plain versions: the
    # chunk fold (16 partitions of 16,384, 256 centers each), the merge
    # (4 restarts over the 78,112-row pool), a mini-batch merge step, a
    # stream update's merge over the coreset, a chunk's predict
    oo_fold = _case(16, 16_384, 256, 8, seed=28)
    oo_merge = _case(4, 78_112, OOCORE_K, 8, share_x=True, seed=29)
    mb_step = _case(4, MINIBATCH_ROWS, 1000, 2, seed=30)
    st_merge = _case(1, 1024, OOCORE_K, 8, seed=31)
    oo_cases = [lloyd_parity("lloyd_oocore_fold", *oo_fold),
                lloyd_parity("lloyd_oocore_merge", *oo_merge),
                lloyd_parity("lloyd_minibatch_step", *mb_step),
                lloyd_parity("lloyd_stream_merge", *st_merge),
                centroid_parity("centroid_oocore_fold", *oo_fold),
                assign_parity("assign_oocore_predict",
                              *_case(1, OOCORE_CHUNK, OOCORE_K, 8,
                                     seed=32)[::2])]
    cases += oo_cases
    emit("oocore_parity", cases=oo_cases)

    # -- 8. the IVF/PQ index at index_200k -----------------------------------
    repeats2 = 3
    (ispec, w2, q2, index2, stats2, build2_s, exact2_s, sweep2,
     index_launches, lloyd_shapes2, assign_rec2) = build_and_sweep(
         SPECS / "index_200k.json", [1, 2, 4, 8], repeats2)
    check(all(index_launches[n] > 0 for n in
              ("adc_scan", "lloyd_step", "assign_argmin")),
          f"the index path skipped a kernel: {index_launches}")
    recall2 = {p["nprobe"]: p["recall"] for p in sweep2}
    check(recall2[2] >= 0.95, f"index_200k recall@10 at nprobe=2: "
          f"{recall2[2]}")
    scan200k = probed_scan_inputs(index2, q2[:w2["q_block"]], 2)
    cases += [scan_parity("scan_index_200k", *scan200k),
              scan_parity("scan_index_200k_bf16",
                          scan200k[0].bfloat16(), scan200k[1])]
    emit("index_200k", n=w2["n"], dim=w2["dim"], nlist=ispec.nlist,
         n_subspaces=ispec.pq.n_subspaces, cap=index2.cap,
         build_s=build2_s, stats=stats2._asdict(), exact_search_s=exact2_s,
         repeats=repeats2, launches=index_launches,
         sweep=[dict(nprobe=p["nprobe"], qps=p["qps"],
                     qps_repeats=p["qps_repeats"], recall=p["recall"])
                for p in sweep2],
         recall_at_10_nprobe2_before=INDEX_RECALL_BEFORE["index_200k"],
         scan_parity=cases[-2:])

    # -- 9. the IVF/PQ index at index_5m, the repo's largest ---------------
    import repro_torch.index.ivf as ivf_mod
    (ispec5, w5, q5, index5, stats5, build5_s, exact5_s, sweep5,
     launches5, lloyd_shapes5, assign_rec5) = build_and_sweep(
         SPECS / "index_5m.json", [2], 1)
    check(all(launches5[n] > 0 for n in
              ("adc_scan", "lloyd_step", "assign_argmin")),
          f"the index_5m path skipped a kernel: {launches5}")
    # the same search with the plain scan in place of the kernel
    ivf_mod.adc_scan_cuda = ref.adc_scan_ref
    try:
        plain_d, plain_i = index5.search(q5, w5["k"], nprobe=2,
                                         q_block=w5["q_block"])
    finally:
        ivf_mod.adc_scan_cuda = scan.adc_scan_cuda
    kern_d, kern_i = sweep5[0]["dists"], sweep5[0]["ids"]
    rel5 = float(((kern_d - plain_d).abs()
                  / plain_d.abs().clamp_min(1e-30)).amax())
    check(rel5 <= 1e-5, f"index_5m: kernel vs plain scan distances "
          f"{rel5} relative")
    swapped = kern_i != plain_i
    n_swapped = int(swapped.sum())
    if n_swapped:
        near = torch.zeros_like(swapped)
        close = torch.isclose(plain_d[:, 1:], plain_d[:, :-1], rtol=1e-5,
                              atol=0.0)
        near[:, 1:] |= close
        near[:, :-1] |= close
        check(bool(near[swapped].all()), f"index_5m: {n_swapped} ids "
              f"differ between kernel and plain scan, not at near-ties")
    scan5m = probed_scan_inputs(index5, q5[:w5["q_block"]], 2)
    cases += [scan_parity("scan_index_5m", *scan5m)]
    emit("index_5m", n=w5["n"], dim=w5["dim"], nlist=ispec5.nlist,
         n_subspaces=ispec5.pq.n_subspaces, cap=index5.cap,
         source=w5["source"], build_s=build5_s, stats=stats5._asdict(),
         exact_search_s=exact5_s, launches=launches5,
         qps=sweep5[0]["qps"], recall_at_10=sweep5[0]["recall"],
         recall_at_10_before=INDEX_RECALL_BEFORE["index_5m"],
         kernel_vs_plain_scan=dict(max_rel_dist_err=rel5,
                                   ids_swapped_at_near_ties=n_swapped),
         scan_parity=cases[-1])
    torch.cuda.synchronize()
    ix5s = index_5m_sharded(SPECS / "index_5m.json", index5,
                            sweep5[0]["true_ids"])
    del index2, index5, sweep2, sweep5, kern_d, plain_d
    torch.cuda.empty_cache()

    # the Lloyd kernel at the index builds' coarse-fit shapes (as their runs
    # gave them) with d >= TC_MIN_D, against the plain version where the
    # tensor-core route takes them (fp32-class distances: the expanded
    # form's rounding bound at width d)
    index_lloyd = [(path, shape, calls, _case(*shape, seed=25))
                   for path, shapes in (("index_200k", lloyd_shapes2),
                                        ("index_5m", lloyd_shapes5))
                   for shape, calls in sorted(shapes.items())
                   if shape[3] >= tiles.TC_MIN_D]
    index_parity = [
        lloyd_parity(f"lloyd_{path}_coarse_{'x'.join(map(str, shape))}",
                     *inputs, cancel=dot_rounding_bound(inputs[0],
                                                        inputs[2]))
        for path, shape, _, inputs in index_lloyd
        if tiles.lloyd_route(shape[2], shape[3]) == "tc"]
    check(len(index_parity) >= 2, "the index builds' coarse fits took the "
          f"tensor-core route {len(index_parity)} times, not at both sizes")
    cases += index_parity
    emit("index_lloyd_parity", cases=index_parity)

    # the assignment kernel at every shape the paths launched it at (as
    # their runs recorded them), with each path's calls; where d >=
    # TC_MIN_D (the index builds' routing of chunks to cells) on the route
    # its shape takes, against the plain version
    # the mesh paths' recorders: (Lloyd, assignment[, centroid]) each
    mesh_paths = [
        ("shard_map_500k", sm["replicated"]["recs"]),
        ("shard_map_500k_distributed", sm["distributed"]["recs"]),
        ("shard_map_500k_cuda", sm["cuda"]["recs"]),
        ("shard_map_landmark_exact", sm_exact["recs"]["replicated"]),
        ("shard_map_landmark_exact_distributed",
         sm_exact["recs"]["distributed"]),
        ("chunked_dist_50m", cd50["recs"]),
        ("stream_5m_sharded", st5s["recs"]),
        ("index_5m_sharded", ix5s["recs"])]
    assign_calls, assign_shared = {}, set()
    for path, rec in (("paper_500k", fused_assign),
                      ("paper_500k_cuda", cuda_assign),
                      ("index_200k", assign_rec2), ("index_5m", assign_rec5),
                      ("oocore_5m", oo["assign_rec"]),
                      ("oocore_5m_cuda", oo["cuda_assign_rec"]),
                      ("stream_drift", drift["assign_rec"]),
                      *((path, recs[1]) for path, recs in mesh_paths)):
        assign_shared |= rec.shared
        for shape, n in rec.shapes.items():
            assign_calls.setdefault(shape, {})[path] = n
    index_assign = [
        assign_parity(f"assign_{'+'.join(calls)}_{'x'.join(map(str, shape))}",
                      *_case(*shape, seed=26)[::2])
        for shape, calls in sorted(assign_calls.items())
        if shape[3] >= tiles.TC_MIN_D]
    check(len(index_assign) >= 2
          and all(c_["route"] == "tc" for c_ in index_assign),
          f"the index builds' routing took another route: {index_assign}")
    cases += index_assign
    emit("index_assign_parity", cases=index_assign)

    # the kernels at every shape the mesh paths launched them at (as their
    # runs recorded them) against their plain versions: the Lloyd and the
    # centroid kernel at each, the assignment kernel at each with d <
    # TC_MIN_D (index_assign_parity holds the others)
    def mesh_recorded(kind):
        shapes, shared = {}, set()
        for path, recs in mesh_paths:
            if len(recs) > kind:
                shared |= recs[kind].shared
                for shape in recs[kind].shapes:
                    shapes.setdefault(shape, []).append(path)
        return sorted(shapes.items()), shared

    def shape_name(kernel, shape, paths):
        return f"{kernel}_{'+'.join(paths)}_{'x'.join(map(str, shape))}"

    mesh_cases = []
    lloyd_mesh, shared = mesh_recorded(0)
    for i, (shape, paths) in enumerate(lloyd_mesh):
        inputs = _case(*shape, share_x=shape in shared, seed=45 + i)
        mesh_cases.append(lloyd_parity(
            shape_name("lloyd", shape, paths), *inputs,
            cancel=(dot_rounding_bound(inputs[0], inputs[2])
                    if tiles.lloyd_route(shape[2], shape[3]) == "tc"
                    else None)))
    assign_mesh, shared = mesh_recorded(1)
    for i, (shape, paths) in enumerate(assign_mesh):
        if shape[3] < tiles.TC_MIN_D:
            mesh_cases.append(assign_parity(
                shape_name("assign", shape, paths),
                *_case(*shape, share_x=shape in shared, seed=65 + i)[::2]))
    centroid_mesh, shared = mesh_recorded(2)
    for i, (shape, paths) in enumerate(centroid_mesh):
        mesh_cases.append(centroid_parity(
            shape_name("centroid", shape, paths),
            *_case(*shape, share_x=shape in shared, seed=85 + i)))
    check(len(lloyd_mesh) > 0 and len(centroid_mesh) > 0,
          "the mesh paths recorded no Lloyd or centroid shape")
    cases += mesh_cases
    emit("mesh_parity", cases=mesh_cases)

    # -- 9b. the tuner: the sweep of the kernels the paths look up, the lookup
    # layers, and every committed row at every shape the paths recorded in
    # its bucket
    t_tune = time.perf_counter()
    sweep = tune_sweep()
    layers = tune_layers(sweep)

    def recorded_shapes(recs):
        shapes, shared = {}, set()
        for rec in recs:
            shapes.update(dict.fromkeys(rec.shapes if hasattr(rec, "shapes")
                                        else rec))
            shared |= getattr(rec, "shared", set())
        return shapes, shared

    row_cases = tune_rows_at_paths(
        {"lloyd_step": recorded_shapes(
            [fused_lloyd, lloyd_shapes2, lloyd_shapes5, oo["lloyd_rec"],
             oo["flush_lloyd_rec"], *(recs[0] for _, recs in mesh_paths)]),
         "assign_argmin": (assign_calls, assign_shared)},
        [scan200k, scan5m])
    emit("tune", seconds=time.perf_counter() - t_tune, shapes=len(sweep),
         rows_checked_at_paths=len(row_cases),
         lookup_us=layers["lookup_us"])

    # -- 10. clustered-KV decode serving, llama3-8b at full width ------------
    serve_requests, served_parity = serve_long_500k()
    cases.append(served_parity)
    serve_launches = serve_requests[-1]["launches"]
    torch.cuda.empty_cache()

    # -- 11. attention quality, and the launcher's full-cache request --------
    attn_quality()
    launcher_request()
    torch.cuda.empty_cache()

    # -- 11a. the other attention decoders: gemma3-12b serving and forward,
    # dbrx-132b (4 layers) serving and forward, internvl2-2b forward/loss,
    # then the kernels at the shapes only these paths launch
    t_models = time.perf_counter()
    gemma_requests, gemma_parity = serve_gemma_long_500k()
    cases.append(gemma_parity)
    gemma_launches = gemma_requests[-1]["launches"]
    torch.cuda.empty_cache()
    gemma_forward()
    moe_launches = serve_moe_long_500k()[-1]["launches"]
    torch.cuda.empty_cache()
    vlm_forward()
    torch.cuda.empty_cache()
    # the recurrent families: zamba2-2.7b serving (the shared attention at
    # dh = 80 on the clustered cache, its refresh on 192 tensor-core
    # lanes) and forward, xlstm-1.3b (1 of its 6 superblocks) serving on
    # its recurrent state and forward
    zamba_requests, zamba_parity, model = serve_zamba_long_500k()
    cases.append(zamba_parity)
    zamba_launches = zamba_requests[-1]["launches"]
    ssm_forward(model)
    del model
    torch.cuda.empty_cache()
    _, model = serve_xlstm_long_500k()
    ssm_forward(model)
    del model
    torch.cuda.empty_cache()
    # the cluster attention at gemma's dh = 256 (g = 2) and dbrx's g = 6;
    # the gemma refresh's Lloyd pass (tensor-core route, d = 256, the
    # points streamed) and value update on 4 of its 64 lanes (the plain
    # version's (B, M, K) distances at 64 lanes take 19 GB)
    gemma_attn = attn_case(1, 16, 8, 8192, 256, dtype=torch.bfloat16,
                           seed=33)
    dbrx_attn = attn_case(1, 48, 8, 8192, 128, dtype=torch.bfloat16,
                          seed=34)
    gemma_refresh = _case(4, 9216, 8192, 256, seed=35)
    check(tiles.lloyd_route(8192, 256) == "tc", "gemma refresh route")
    # zamba2's refresh (tensor cores, d = 80: 96 staged dims) on 4 of its
    # 192 lanes, on bf16-valued points as served
    zamba_refresh = _case(4, 9216, 8192, 80, seed=38)
    zamba_refresh = (zamba_refresh[0].bfloat16().float(), *zamba_refresh[1:])
    model_cases = [
        attn_parity("attn_gemma_dh256_bf16", *gemma_attn, 256 ** -0.5),
        attn_parity("attn_dbrx_g6_bf16", *dbrx_attn, 128 ** -0.5),
        lloyd_parity("lloyd_gemma_refresh_4_lanes", *gemma_refresh,
                     cancel=dot_rounding_bound(gemma_refresh[0],
                                               gemma_refresh[2])),
        centroid_parity("centroid_gemma_refresh_4_lanes", *gemma_refresh),
        lloyd_parity("lloyd_zamba_refresh_4_lanes", *zamba_refresh,
                     cancel=dot_rounding_bound(zamba_refresh[0],
                                               zamba_refresh[2])),
        centroid_parity("centroid_zamba_refresh_4_lanes", *zamba_refresh)]
    cases += model_cases
    emit("models_parity", cases=model_cases,
         seconds=time.perf_counter() - t_models)

    # -- 11b. training: llama3-8b at full width (2 of its 32 layers), its
    # checkpoint and restart, one step with the gradient compressor (the
    # Lloyd kernel at d = 1 on each leaf's sample), the two launchers
    # (train, then serve the checkpoint), the one-device step on a state
    # of whole tensors, the sharded trainer on a 2 x 2 mesh against it,
    # and the Lloyd kernel on the two compressed steps' head-gradient
    # samples against its plain version
    from repro_torch.core.kmeans import landmark_init
    t_train = time.perf_counter()
    train, comp_x = train_llama3_8b()
    torch.cuda.empty_cache()
    train_launcher()
    _, one_device = train_one_device()
    sd, sd_x = train_sharded(one_device)
    del one_device
    torch.cuda.empty_cache()
    # dbrx-132b (1 of 40 layers): the experts over "model" (no kernel)
    train_moe_phase()
    # xlstm-1.3b and zamba2-2.7b (one superblock each): the recurrent
    # blocks over "model" (no kernel)
    train_recurrent_phase()
    comp_w = torch.ones(comp_x.shape[:2], device=comp_x.device)
    comp_c = landmark_init(comp_x, comp_w, COMPRESS_LEVELS)
    train_cases = [lloyd_parity("lloyd_compressor_head", comp_x, comp_w,
                                comp_c)]
    train_cases.append(lloyd_parity(
        "lloyd_compressor_sharded_head", sd_x, comp_w,
        landmark_init(sd_x, comp_w, COMPRESS_LEVELS)))
    cases += train_cases
    emit("train_parity", cases=train_cases,
         seconds=time.perf_counter() - t_train)

    # -- 11c. whisper-base (forward, full-cache decode at decode_32k,
    # training) and the data pipeline (the cluster-balanced sampler, the
    # paper's Table 1 on the surrogates); then the Lloyd kernel at the
    # sampler's shapes against its plain version, on all lanes where the
    # plain version's (B, M, K) distances take under 4 GB, else on 4
    t_new = time.perf_counter()
    model = whisper_model()
    whisper_forward(model)
    serve_whisper_decode_32k(model)
    del model
    torch.cuda.empty_cache()
    whisper_one, whisper_base = train_whisper()
    # its encoder, decoder, cross attention and head over "model" on a
    # 2 x 2 mesh against the one-device step, in bf16 and f32 (no kernel)
    train_whisper_sharded_phase(whisper_one, whisper_base)
    del whisper_base
    torch.cuda.empty_cache()
    sampler = cluster_balanced_sampler()
    table1 = paper_table1()
    sampler_lloyd, rec = [], sampler.pop("lloyd_rec")
    for i, (shape, calls) in enumerate(sorted(rec.shapes.items())):
        bb, mm, kk, dd = shape
        lanes = bb if bb * mm * kk * 4 <= 4e9 else 4
        sampler_lloyd.append((shape, calls, _case(
            lanes, mm, kk, dd, share_x=shape in rec.shared, seed=100 + i)))
    data_cases = [
        lloyd_parity(f"lloyd_sampler_{'x'.join(map(str, shape))}", *inputs,
                     cancel=(dot_rounding_bound(inputs[0], inputs[2])
                             if tiles.lloyd_route(shape[2], shape[3]) == "tc"
                             else None))
        for shape, _, inputs in sampler_lloyd]
    # Table 1's launches (d = 4 and 7) on the inputs each shape's first
    # call was given
    rec = table1.pop("lloyd_rec")
    data_cases += [
        lloyd_parity(f"lloyd_table1_{'x'.join(map(str, shape))}", *inputs,
                     cancel=(dot_rounding_bound(inputs[0], inputs[2])
                             if tiles.lloyd_route(shape[2], shape[3]) == "tc"
                             else None))
        for shape, inputs in sorted(rec.inputs.items())]
    del rec
    data_cases.append(sampler.pop("assign_parity"))
    cases += data_cases
    emit("data_parity", cases=data_cases,
         seconds=time.perf_counter() - t_new)

    # -- 12. kernel times at the paths' shapes ------------------------------
    # ms / plain_ms / library_ms: device time per call, with the inputs in
    # HBM (rotated copies); call_ms: the kernel's time per call with its
    # wrapper's host work.  ``library`` is (function, its inputs).
    # where the card's table has a row for a shape's bucket, the kernel's
    # time at that row too (``row_ms``): the time the tuned paths launch
    def with_row(entry, tk, kernel, inputs, **dims):
        from repro_torch.kernels import autotune, tune_table
        row = tune_table.load_default(tk, kind,
                                      autotune.shape_bucket(tk, **dims))
        if row != autotune.DEFAULT:
            entry.update(row=row.to_dict(), row_ms=device_ms(rotating(
                lambda *t: kernel(*t, row), *inputs)))
        return entry

    # bound_ms / bound_by: repro_torch.roofline's bound of the kernel
    # (``model``) on its route at ``cost_dims``, the launch's dims
    # (kernel_dims of its inputs; the roofline phase reads them)
    def with_bound(entry, model, inputs, route="simt"):
        entry["cost_dims"] = dims = kernel_dims(model, *inputs, route=route)
        entry["bound_ms"], entry["bound_by"] = kernel_bound_ms(
            model, route=route, **dims)
        return entry

    def timed(shape_name, inputs, kernel, plain, model, library=None,
              iters=20, bound_inputs=None, **fields):
        return with_bound(dict(
            shape=shape_name, **fields,
            ms=device_ms(rotating(kernel, *inputs), iters=iters),
            call_ms=call_ms(rotating(kernel, *inputs), iters=iters),
            plain_ms=device_ms(rotating(plain, *inputs), iters=3),
            library_ms=(None if library is None
                        else device_ms(rotating(library[0], *library[1])))),
            model, bound_inputs or inputs, fields.get("route", "simt"))

    # on the tensor-core route also fp32_bound_ms, the bound of the same
    # work on the CUDA cores (the SIMT route's), and where the tensor
    # cores take the shape tc_bound_ms, the bound on their route
    def tc_bounds(entry, model, inputs):
        kk, dd = entry["k"], entry["d"]
        if entry["route"] == "tc":
            entry["fp32_bound_ms"] = kernel_bound_ms(
                model, route="simt", **entry["cost_dims"])[0]
        if dd >= tiles.TC_MIN_D and (model == "assign"
                                     or tiles.sort_clusters_fit(kk)):
            entry["tc_bound_ms"] = kernel_bound_ms(model, route="tc", **(
                entry["cost_dims"] if entry["route"] == "tc"
                else kernel_dims(model, *inputs, route="tc")))[0]
        return entry

    # a Lloyd launch timed on the kernel alone
    def kernel_only_entry(entry, inputs):
        return tc_bounds(with_bound(entry, "lloyd", inputs, entry["route"]),
                         "lloyd", inputs)

    def lloyd_entry(shape_name, xw, wl, cl, routes=False, iters=20):
        bb, mm, dd = xw.shape
        kk = cl.shape[1]
        route = tiles.lloyd_route(kk, dd)
        entry = tc_bounds(timed(
            shape_name, (xw, wl, cl), lloyd.lloyd_step, ref.lloyd_step_ref,
            "lloyd", iters=iters, b=bb, m=mm, k=kk, d=dd, route=route),
            "lloyd", (xw, wl, cl))
        if routes:   # both routes on the same inputs
            entry["route_ms"] = {
                r: device_ms(rotating(
                    lambda *t, r=r: lloyd.route_step(*t, r), xw, wl, cl))
                for r in ("simt", "tc")}
        return with_row(entry, "lloyd", lloyd.lloyd_step, (xw, wl, cl),
                        b=bb, m=mm, k=kk, d=dd)

    # the cuda backend's centroid pass on the assignment kernel's ids;
    # bytes: x, ids and w read once, sums and counts written once
    def centroid_entry(shape_name, xw, wl, cl):
        ids, _ = assign.assign_argmin(xw, cl)
        return centroid_ids_entry(shape_name, xw, ids, wl, cl.shape[1])

    def centroid_ids_entry(shape_name, xw, ids, wl, kk):
        bb, mm, dd = xw.shape
        flat = (ids.long() + kk * torch.arange(bb, device="cuda")[:, None]
                ).reshape(-1)
        wx = (xw.float() * wl.float()[..., None]).reshape(-1, dd)
        return timed(
            shape_name, (xw, ids, wl),
            lambda *t: centroid.centroid_update(*t, kk),
            lambda *t: ref.centroid_update_ref(*t, kk), "centroid",
            library=(lambda f, v: torch.zeros(bb * kk, dd, device="cuda"
                                              ).index_add_(0, f, v),
                     (flat, wx)),
            bound_inputs=(xw, ids, wl, kk), b=bb, m=mm, k=kk, d=dd)

    # the derived plan (``ms``), and the card's row where one applies
    # (``row_ms``, what the search's lookup launches)
    def scan_entry(shape_name, luts, codes):
        from repro_torch.kernels.autotune import DEFAULT
        b, l, m = codes.shape
        return with_row(timed(
            shape_name, (luts, codes),
            lambda *t: scan.adc_scan_cuda(*t, DEFAULT), ref.adc_scan_ref,
            "scan", b=b, l=l, m=m, c=luts.shape[2],
            plan=scan_plan(luts, codes)), "scan", scan.adc_scan_cuda,
            (luts, codes), b=b, l=l, msub=m, c=luts.shape[2])

    c_local = centroid_entry("local", *local)
    c_merge = centroid_entry("merge", *merge)
    c_pq = centroid_entry("pq_200k", *pq200k)
    s_200k = scan_entry("index_200k nprobe=2", *scan200k)
    s_5m = scan_entry("index_5m nprobe=2", *scan5m)
    l_local = lloyd_entry("local", *local)
    l_merge = lloyd_entry("merge", *merge)
    l_pq = lloyd_entry("pq_200k", *pq200k)
    l_refresh4 = lloyd_entry("refresh, 4 of 256 lanes", *refresh)
    l_oocore = [lloyd_entry("oocore_5m fold", *oo_fold),
                lloyd_entry("oocore_5m merge", *oo_merge),
                lloyd_entry("minibatch_500k merge step", *mb_step),
                lloyd_entry("stream_5m merge", *st_merge)]
    # all 256 lanes of a refresh: the plain version's (B, M, K) distances
    # would take 77 GB, so only the kernel is timed there
    xr, wr, cr = (t.repeat(64, *[1] * (t.dim() - 1)) for t in refresh)
    # the served pool's points are bf16 keys upcast to f32: exact in TF32,
    # so the tensor-core route leaves out its lo_x pass
    xb = xr.bfloat16().float()
    l_refresh, l_refresh_bf16 = (
        kernel_only_entry(dict(
            shape=name, b=256, m=9216, k=8192, d=128,
            route=tiles.lloyd_route(8192, 128),
            ms=device_ms(lambda p=p: lloyd.lloyd_step(p, wr, cr), iters=3),
            plain_ms=None, library_ms=None), (p, wr, cr))
        for name, p in (("refresh, 256 lanes", xr),
                        ("refresh, 256 lanes, bf16-valued points", xb)))
    del xr, wr, cr, xb
    # the index builds' coarse fits, at the shapes their runs gave, on
    # both routes
    l_index = []
    for path, _, calls, inputs in index_lloyd:
        e = lloyd_entry(f"{path} coarse", *inputs, routes=True)
        e["calls_per_build"] = calls
        l_index.append(e)
    del index_lloyd
    c_refresh = centroid_entry("refresh values, 4 lanes", *refresh)
    c_oocore = centroid_entry("oocore_5m fold (cuda)", *oo_fold)
    del oo_fold, oo_merge, mb_step, st_merge

    # the Lloyd and centroid kernels at the shapes the mesh paths launched
    # them at that no row above times, with each path's calls
    def mesh_shapes(kind, timed):
        calls, shared = {}, set()
        for path, recs in mesh_paths:
            if len(recs) > kind:
                shared |= recs[kind].shared
                for shape, n in recs[kind].shapes.items():
                    if shape not in timed:
                        calls.setdefault(shape, {})[path] = n
        return sorted(calls.items()), shared

    def dims(entries):
        return {(e["b"], e["m"], e["k"], e["d"]) for e in entries}

    l_mesh = []
    calls, shared = mesh_shapes(0, dims([l_local, l_merge, l_pq, l_refresh4,
                                         *l_index, *l_oocore]))
    for shape, by_path in calls:
        e = lloyd_entry(f"{'+'.join(by_path)} {'x'.join(map(str, shape))}",
                        *_case(*shape, share_x=shape in shared, seed=43))
        e["calls_by_path"] = by_path
        l_mesh.append(e)
    c_mesh = []
    calls, shared = mesh_shapes(2, dims([c_local, c_merge, c_pq, c_refresh,
                                         c_oocore]))
    for shape, by_path in calls:
        e = centroid_entry(f"{'+'.join(by_path)} "
                           f"{'x'.join(map(str, shape))}",
                           *_case(*shape, share_x=shape in shared, seed=44))
        e["calls_by_path"] = by_path
        c_mesh.append(e)
    c_refresh256 = centroid_ids_entry("refresh values, 256 lanes",
                                      *refresh256, 8192)
    del refresh256
    # the gemma refresh (tensor-core route, d = 256, the points streamed):
    # 4 lanes against the plain version, and one launch of the SIMT route
    # it left (the point read from device memory, about 1.7 s); all 64
    # lanes of the 8 superblocks the served launches' own device times
    # (CUDA events around the request's five, on bf16-valued keys); its
    # value update; the dbrx refresh (tensor cores, 32 lanes of llama's
    # shape) the kernel alone
    l_gemma4 = lloyd_entry("gemma refresh, 4 of 64 lanes", *gemma_refresh)
    l_gemma4["simt_once_ms"] = one_launch_ms(
        lambda: lloyd.route_step(*gemma_refresh, "simt"))
    c_gemma4 = centroid_entry("gemma refresh values, 4 lanes",
                              *gemma_refresh)

    def lloyd_kernel_only(name, lanes, inputs, served_ms=None):
        xk, wk, ck = (t.repeat(lanes // t.shape[0], *[1] * (t.dim() - 1))
                      for t in inputs)
        bb, mm, dd = xk.shape
        kk = ck.shape[1]
        ms = (float(np.median(served_ms)) if served_ms else
              device_ms(lambda: lloyd.lloyd_step(xk, wk, ck), iters=3))
        entry = kernel_only_entry(dict(
            shape=name, b=bb, m=mm, k=kk, d=dd,
            route=tiles.lloyd_route(kk, dd), ms=ms,
            plain_ms=None, library_ms=None), (xk, wk, ck))
        if served_ms:
            entry["served_launches_ms"] = served_ms
        if entry["route"] == "simt":
            per_sm, _ = lloyd.simt_occupancy(kk, dd)
            blocks = tiles.lloyd_blocks(bb, mm, kk, dd, sms, per_sm)
            entry["blocks_per_lane"] = blocks
            # each SM that holds a block streams its share of its lane's
            # M x K x d work alone
            entry["one_wave_floor_ms"] = pair_bound_ms(
                1, mm, kk, dd, 0, 0)[0] * sms * bb / min(bb * blocks, sms)
        return entry

    l_gemma = lloyd_kernel_only(
        "gemma refresh, 64 lanes (8 superblocks, served)", 64,
        (gemma_refresh[0].bfloat16().float(), *gemma_refresh[1:]),
        served_ms=[ms for r in gemma_requests for f in r["refreshes"]
                   for ms in f["lloyd_device_ms"]])
    l_dbrx = lloyd_kernel_only("dbrx refresh, 32 lanes", 32, refresh)
    l_compress = lloyd_entry("compressor, the head gradient's sample",
                             comp_x, comp_w, comp_c)
    # the sampler's fit (d = 32): each shape against the plain version on
    # the lanes held above, and where those are fewer than the fit's, all
    # of its lanes on the kernel alone
    l_sampler = []
    for shape, calls, inputs in sampler_lloyd:
        e = lloyd_entry(f"sampler {'x'.join(map(str, inputs[0].shape))}"
                        f"x{shape[2]}", *inputs, iters=5)
        e["calls_per_fit"] = calls
        l_sampler.append(e)
        if inputs[0].shape[0] < shape[0]:
            e = lloyd_kernel_only(f"sampler {shape[0]} lanes", shape[0],
                                  inputs)
            e["calls_per_fit"] = calls
            l_sampler.append(e)
    del sampler_lloyd
    del gemma_refresh
    # the zamba2 refresh (tensor cores, d = 80): 4 lanes against the plain
    # version; all 192 lanes the served launches' own device times; its
    # value update on 4 lanes
    l_zamba4 = lloyd_entry("zamba refresh, 4 of 192 lanes", *zamba_refresh,
                           iters=5)
    c_zamba4 = centroid_entry("zamba refresh values, 4 lanes",
                              *zamba_refresh)
    l_zamba = lloyd_kernel_only(
        "zamba refresh, 192 lanes", 192, zamba_refresh,
        served_ms=[ms for r in zamba_requests for f in r["refreshes"]
                   for ms in f["lloyd_device_ms"]])
    del zamba_refresh
    def sdpa_library(inputs, sc):
        """SDPA over the same centroids with the log(count) bias as a float
        mask (the library yardstick) -> (callable, its inputs)."""
        q_, k_, v_, c_ = inputs
        m_ = torch.where(c_ > 0, c_.clamp_min(1e-9).log(), ref.NEG)
        m_ = m_.repeat_interleave(q_.shape[1] // k_.shape[1], 1)
        m_ = m_[:, :, None, :].to(q_.dtype)

        def lib(qq, kk, vv, mm):
            return torch.nn.functional.scaled_dot_product_attention(
                qq[:, :, None], kk, vv, attn_mask=mm, scale=sc,
                enable_gqa=True)

        return lib, (q_, k_, v_, m_)

    def attn_entry(name, inputs, sc, **dims):
        return timed(name, inputs,
                     lambda *t: cluster_attn.cluster_attn_partial(*t, sc),
                     lambda *t: ref.cluster_attn_decode_ref(*t, sc),
                     "cluster_attn", library=sdpa_library(inputs, sc),
                     **dims)

    sdpa, sdpa_in = sdpa_library(serve_attn, scale)
    sdpa_err = float((sdpa(*sdpa_in)[:, :, 0].float()
                      - cluster_attn.cluster_attn_decode(*serve_attn, scale)
                      ).abs().amax())
    check(sdpa_err <= 2e-2, f"the SDPA yardstick disagrees: {sdpa_err}")
    attn_500k = attn_entry("long_500k (bf16)", serve_attn, scale, b=1, h=32,
                           hkv=8, nc=8192, dh=128, sdpa_max_abs_diff=sdpa_err)
    attn_gemma = attn_entry("gemma3 long_500k, dh=256 (bf16)", gemma_attn,
                            256 ** -0.5, b=1, h=16, hkv=8, nc=8192, dh=256)
    attn_dbrx = attn_entry("dbrx long_500k, g=6 (bf16)", dbrx_attn,
                           128 ** -0.5, b=1, h=48, hkv=8, nc=8192, dh=128)
    attn_zamba = attn_entry("zamba2 long_500k, dh=80 (bf16)", zamba_attn,
                            80 ** -0.5, b=1, h=32, hkv=32, nc=8192, dh=80)
    del gemma_attn, dbrx_attn, zamba_attn
    ragged = attn_case(4, 32, 8, 1000, 128, seed=16, dtype=torch.bfloat16)
    attn_ragged = timed(
        "ragged (bf16)", ragged,
        lambda *t: cluster_attn.cluster_attn_partial(*t, scale),
        lambda *t: ref.cluster_attn_decode_ref(*t, scale),
        "cluster_attn", b=4, h=32, hkv=8, nc=1000, dh=128)
    # the assignment kernel at every shape its paths launched, with each
    # path's calls; at small d also the issue floor of the exact expression
    # (issue_floor_ms); where d >= TC_MIN_D both routes on the same inputs
    # (route_ms) and the bound on the tensor cores' route (tc_bound_ms)
    def assign_entry(shape, calls, shared):
        bb, mm, kk, dd = shape
        if shape == tuple(predict_x.shape[:2]) + tuple(predict_c.shape[1:]):
            name, xa, ca = "predict", predict_x, predict_c
        else:
            name = f"{'+'.join(calls)} {bb}x{mm}x{kk} d={dd}"
            xa, _, ca = _case(bb, mm, kk, dd, share_x=shared, seed=26)
        route = tiles.assign_route(kk, dd)
        entry = tc_bounds(timed(
            name, (xa, ca), assign.assign_argmin, ref.assign_argmin_ref,
            "assign", b=bb, m=mm, k=kk, d=dd, route=route,
            calls_by_path=calls), "assign", (xa, ca))
        if 0 < tiles.register_dim(dd) <= 16:
            entry["issue_floor_ms"] = issue_floor_ms(bb, mm, kk, dd, sms,
                                                     sm_clock_hz)
        if dd >= tiles.TC_MIN_D:
            entry["route_ms"] = {
                r: device_ms(rotating(
                    lambda *t, r=r: assign.route_argmin(*t, r), xa, ca))
                for r in ("simt", "tc")}
        return with_row(entry, "assign", assign.assign_argmin, (xa, ca),
                        b=bb, m=mm, k=kk, d=dd)

    a_shapes = [assign_entry(shape, calls, shape in assign_shared)
                for shape, calls in sorted(assign_calls.items())]
    # the sampler's assignment of every document (1 x 1,048,576 x 1024)
    rec = sampler.pop("assign_rec")
    a_shapes += [assign_entry(shape, {"cluster_balanced_sampler": n},
                              shape in rec.shared)
                 for shape, n in sorted(rec.shapes.items())]
    del rec
    # d = 256 (gemma3's head width; no path assigns there yet): the
    # tensor-core route, its points streamed, against the plain version,
    # and the SIMT route it replaced (the point read from device memory for
    # every center, about 0.5 s a call) on the same inputs
    xa, _, ca = _case(1, 500_000, 1000, 256, seed=26)
    a_256 = tc_bounds(timed(
        "d=256 1x500000x1000", (xa, ca), assign.assign_argmin,
        ref.assign_argmin_ref, "assign", b=1, m=500_000, k=1000, d=256,
        route=tiles.assign_route(1000, 256)), "assign", (xa, ca))
    a_256["route_ms"] = {
        r: device_ms(rotating(lambda *t, r=r: assign.route_argmin(*t, r),
                              xa, ca), iters=3 if r == "simt" else 20)
        for r in ("simt", "tc")}
    a_shapes.append(a_256)
    del xa, ca
    a_pred = next(e for e in a_shapes if e["shape"] == "predict")
    errs = {c["case"]: c for c in cases}
    mesh_runs = {
        "shard_map_500k": sm["replicated"]["launches"],
        "shard_map_500k_distributed": sm["distributed"]["launches"],
        "shard_map_500k_cuda": sm["cuda"]["launches"],
        "shard_map_landmark_exact": sm_exact["launches"]["replicated"],
        "shard_map_landmark_exact_distributed":
            sm_exact["launches"]["distributed"],
        "chunked_dist_50m": cd50["launches"],
        "chunked_dist_one_shard_pin": pin1,
        "stream_5m_sharded": st5s["launches"],
        "index_5m_sharded": ix5s["launches"]}

    def mesh_launches(kernel):
        """A kernel's launches on each mesh path that launched it."""
        return {p: n[kernel] for p, n in mesh_runs.items() if n[kernel]}

    kernels = [
        dict(name="lloyd_step", route="cuda",
             source="src/repro_torch/kernels/csrc/lloyd.cu",
             replaces="src/repro/kernels/lloyd.py:134",
             launches=launches["lloyd_step"],
             max_abs_err=max(errs["lloyd_local"]["max_sum_err"],
                             errs["lloyd_merge"]["max_sum_err"]),
             launches_by_path={
                 "paper_500k": launches["lloyd_step"],
                 "index_200k": index_launches["lloyd_step"],
                 "index_5m": launches5["lloyd_step"],
                 "serve_long_500k": serve_launches["lloyd_step"],
                 "serve_gemma_long_500k": gemma_launches["lloyd_step"],
                 "serve_moe_long_500k": moe_launches["lloyd_step"],
                 "serve_zamba_long_500k": zamba_launches["lloyd_step"],
                 "train_llama3_8b_compressed_step": train[
                     "compressed_step"]["launches"]["lloyd_step"],
                 "train_sharded_compressed_step": sd[
                     "compressed_step"]["launches"]["lloyd_step"],
                 "cluster_balanced_sampler": sampler["launches"][
                     "lloyd_step"],
                 "paper_table1": table1["launches"]["lloyd_step"],
                 "oocore_5m": oo["launches"]["lloyd_step"],
                 "oocore_5m_flush": oo["flush_launches"]["lloyd_step"],
                 "stream_5m": st5["launches"]["lloyd_step"],
                 "stream_drift": drift["launches"]["lloyd_step"],
                 "minibatch_500k": mb["launches"]["lloyd_step"],
                 **mesh_launches("lloyd_step")},
             ms=l_local["ms"], plain_ms=l_local["plain_ms"],
             bound_ms=l_local["bound_ms"], bound_by=l_local["bound_by"],
             library_ms=None,
             shapes=[l_local, l_merge, l_pq, l_refresh4, l_refresh,
                     l_refresh_bf16, l_gemma4, l_gemma,
                     l_dbrx, l_zamba4,
                     l_zamba, l_compress, *l_sampler, *l_index,
                     *l_oocore, *l_mesh]),
        dict(name="assign_argmin", route="cuda",
             source="src/repro_torch/kernels/csrc/assign.cu",
             replaces="src/repro/kernels/assign.py:87",
             launches=launches["assign_argmin"],
             max_abs_err=errs["assign_predict"]["max_dist_err"],
             launches_by_path={
                 "paper_500k": launches["assign_argmin"],
                 "paper_500k_cuda": cuda_launches["assign_argmin"],
                 "index_200k": index_launches["assign_argmin"],
                 "index_5m": launches5["assign_argmin"],
                 "serve_long_500k": serve_launches["assign_argmin"],
                 "serve_zamba_long_500k": zamba_launches["assign_argmin"],
                 "cluster_balanced_sampler": sampler["launches"][
                     "assign_argmin"],
                 "paper_table1": table1["launches"]["assign_argmin"],
                 "oocore_5m": oo["launches"]["assign_argmin"],
                 "oocore_5m_cuda": oo["cuda_launches"]["assign_argmin"],
                 "stream_5m": st5["launches"]["assign_argmin"],
                 "stream_drift": drift["launches"]["assign_argmin"],
                 "minibatch_500k": mb["launches"]["assign_argmin"],
                 **mesh_launches("assign_argmin")},
             ms=a_pred["ms"], plain_ms=a_pred["plain_ms"],
             bound_ms=a_pred["bound_ms"], bound_by=a_pred["bound_by"],
             issue_floor_ms=a_pred["issue_floor_ms"],
             library_ms=None, shapes=a_shapes),
        dict(name="centroid_update", route="cuda",
             source="src/repro_torch/kernels/csrc/centroid.cu",
             replaces="src/repro/kernels/centroid.py:60",
             launches=cuda_launches["centroid_update"],
             max_abs_err=max(errs["centroid_local"]["max_abs_err"],
                             errs["centroid_merge"]["max_abs_err"]),
             ms=c_local["ms"], plain_ms=c_local["plain_ms"],
             bound_ms=c_local["bound_ms"], bound_by=c_local["bound_by"],
             launches_by_path={
                 "paper_500k_cuda": cuda_launches["centroid_update"],
                 "serve_long_500k": serve_launches["centroid_update"],
                 # inside the Lloyd kernel's tensor-core route
                 "serve_long_500k_lloyd": serve_launches[
                     "lloyd_centroid_update"],
                 "serve_gemma_long_500k": gemma_launches["centroid_update"],
                 "serve_moe_long_500k": moe_launches["centroid_update"],
                 "serve_moe_long_500k_lloyd": moe_launches[
                     "lloyd_centroid_update"],
                 "serve_zamba_long_500k": zamba_launches["centroid_update"],
                 "serve_zamba_long_500k_lloyd": zamba_launches[
                     "lloyd_centroid_update"],
                 "cluster_balanced_sampler_lloyd": sampler["launches"][
                     "lloyd_centroid_update"],
                 "index_200k_lloyd": index_launches["lloyd_centroid_update"],
                 "index_5m_lloyd": launches5["lloyd_centroid_update"],
                 "oocore_5m_cuda": oo["cuda_launches"]["centroid_update"],
                 **mesh_launches("centroid_update"),
                 **{f"{p}_lloyd": n for p, n in
                    mesh_launches("lloyd_centroid_update").items()}},
             library_ms=c_local["library_ms"],
             shapes=[c_local, c_merge, c_pq, c_refresh, c_refresh256,
                     c_gemma4, c_zamba4, c_oocore, *c_mesh]),
        dict(name="adc_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/adc_scan.cu",
             replaces="src/repro/kernels/scan.py:105",
             launches=index_launches["adc_scan"],
             launches_by_path={"index_200k": index_launches["adc_scan"],
                               "index_5m": launches5["adc_scan"],
                               **mesh_launches("adc_scan")},
             max_abs_err=errs["scan_index_200k"]["max_abs_err"],
             ms=s_200k["ms"], plain_ms=s_200k["plain_ms"],
             bound_ms=s_200k["bound_ms"], bound_by=s_200k["bound_by"],
             library_ms=None, shapes=[s_200k, s_5m]),
        dict(name="cluster_attn", route="cuda",
             source="src/repro_torch/kernels/csrc/cluster_attn.cu",
             replaces="src/repro/kernels/cluster_attn.py:85",
             launches=serve_launches["cluster_attn"],
             launches_by_path={
                 "serve_long_500k": serve_launches["cluster_attn"],
                 "serve_gemma_long_500k": gemma_launches["cluster_attn"],
                 "serve_moe_long_500k": moe_launches["cluster_attn"],
                 "serve_zamba_long_500k": zamba_launches["cluster_attn"]},
             max_abs_err=max(errs[n]["max_abs_err"] for n in (
                 "attn_long_500k_bf16", "attn_ragged_bf16",
                 "attn_served_layer0", "attn_gemma_dh256_bf16",
                 "attn_dbrx_g6_bf16", "attn_served_gemma_global0",
                 "attn_zamba_dh80_bf16", "attn_dh80_g4_bf16",
                 "attn_served_zamba_attn0")),
             ms=attn_500k["ms"], plain_ms=attn_500k["plain_ms"],
             bound_ms=attn_500k["bound_ms"], bound_by=attn_500k["bound_by"],
             library_ms=attn_500k["library_ms"],
             shapes=[attn_500k, attn_gemma, attn_dbrx, attn_zamba,
                     attn_ragged]),
    ]
    # -- 13. the roofline: repro_torch.roofline's models at section 12's
    # shapes and times, kmeans_lloyd_step, the telemetry helpers ----------
    roofline_phase(kernels, local, log.events, kind, smi)
    emit("done", seconds=time.perf_counter() - t_all)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


# each kernel of the ``kernels`` line and its model in repro_torch.roofline
KERNEL_MODELS = {"lloyd_step": "lloyd", "assign_argmin": "assign",
                 "centroid_update": "centroid", "adc_scan": "scan",
                 "cluster_attn": "cluster_attn"}


def roofline_phase(kernels: list, local, events: list, kind: str,
                   smi: str) -> dict:
    """``kmeans_lloyd_step`` at paper_500k's local shape (its default
    backend: one Lloyd kernel launch) against the plain statistics of its
    own labels at the Lloyd kernel's tolerance (:func:`lloyd_parity`'s)
    and against the plain step, whose counts may differ only in the
    clusters of the points the two label apart; ``predicted_vs_measured``
    for every shape section 12 timed, on its times and ``cost_dims`` (no
    launch); ``calibrate()`` and the ``summarize_events`` totals of
    paper_500k's logged fit."""
    from repro_torch.core import get_backend, kmeans_lloyd_step
    from repro_torch.kernels import ref
    from repro_torch.roofline.analysis import predicted_vs_measured
    from repro_torch.telemetry import calibrate, summarize_events
    t0 = time.perf_counter()
    x, w, c = local
    reset_launches()
    new_c, counts = kmeans_lloyd_step(x, c, w)
    torch.cuda.synchronize()
    launched = read_launches()
    check(launched["lloyd_step"] == 1 and sum(launched.values()) == 1,
          f"kmeans_lloyd_step launched {launched}")
    # the same launch again, for its labels: the plain statistics of them
    be = get_backend(None, device=x.device)
    st = be.step(be.prepare(x, w), c)
    check(torch.equal(st.counts, counts), "kmeans_lloyd_step: a repeated "
          "step is not bit-identical")
    csums, ccounts = ref.centroid_update_ref(x, st.idx, w, c.shape[1])
    want = torch.where((ccounts <= 0)[..., None], c,
                       csums / ccounts.clamp_min(1e-12)[..., None])
    check(torch.equal(counts, ccounts), "kmeans_lloyd_step: counts differ")
    cerr = float(((new_c - want).abs() - 1e-4 * want.abs()).amax())
    check(cerr <= 1e-4 * float(want.abs().amax()),
          f"kmeans_lloyd_step: centers off ({cerr})")
    plain_c, plain_n = kmeans_lloyd_step(x, c, w, backend="torch")
    # the clusters the two steps may count apart: both labels of every
    # point they label apart
    pb = get_backend("torch", device=x.device)
    plain_idx = pb.step(pb.prepare(x, w), c).idx
    apart = st.idx.ne(plain_idx)
    lane = torch.arange(x.shape[0], device=x.device)[:, None].expand_as(apart)
    touched = torch.zeros_like(counts, dtype=torch.bool)
    for labels in (st.idx, plain_idx):
        touched[lane[apart], labels[apart].long()] = True
    moved = int((plain_n != counts).sum())
    check(not bool(((plain_n != counts) & ~touched).any()),
          "kmeans_lloyd_step: counts differ from the plain step's outside "
          "the clusters of the points the two label apart")
    step = dict(shape=list(x.shape) + [c.shape[1]], launches=launched,
                max_center_err=float((new_c - want).abs().amax()),
                max_center_diff_vs_plain_step=float(
                    (new_c - plain_c).abs().amax()),
                points_labelled_apart_from_plain_step=int(apart.sum()),
                clusters_whose_counts_differ_from_plain_step=moved)
    preds = []
    for kd in kernels:
        for e in kd["shapes"]:
            p = predicted_vs_measured(
                KERNEL_MODELS[kd["name"]], e["ms"] / 1e3, device_kind=kind,
                route=e.get("route", "simt"), **e["cost_dims"])
            preds.append(dict(kernel=kd["name"], shape=e["shape"],
                              **{k: p[k] for k in (
                                  "flops", "bytes", "compute_s", "memory_s",
                                  "predicted_s", "dominant", "measured_s",
                                  "efficiency")}))
    calib = calibrate()
    summary = summarize_events(events)
    timers = {e["name"] for e in events if e["kind"] == "timer"}
    check(calib > 0 and set(summary["timers_s"]) == timers
          and sum(summary["event_counts"].values()) == len(events),
          f"calibrate {calib}, summary {summary}")
    out = dict(nvidia_smi=smi, kmeans_lloyd_step=step,
               predicted_vs_measured=preds, calib_mflops=calib,
               paper_500k_summary=summary,
               seconds=time.perf_counter() - t0)
    emit("roofline", **out)
    return out


def stream_sweep(n_seeds: int) -> int:
    """``--stream-sweep N``: only :func:`stream_seed_rows` for seeds 0 to
    N - 1, one JSON line a seed (the sweep PERF.md §6 cites)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    build.build(["lloyd", "assign", "centroid"])
    for seed in range(n_seeds):
        t0 = time.perf_counter()
        row = stream_seed_rows([seed])[0]
        print(json.dumps(dict(row, seconds=time.perf_counter() - t0)),
              flush=True)
    return 0


# the cluster attention's served shapes (B, H, Hkv, Nc, dh), bf16
ATTN_TIME_SHAPES = (("long_500k", (1, 32, 8, 8192, 128)),
                    ("gemma3 dh=256", (1, 16, 8, 8192, 256)),
                    ("dbrx g=6", (1, 48, 8, 8192, 128)),
                    ("zamba2 dh=80", (1, 32, 32, 8192, 80)),
                    ("ragged", (4, 32, 8, 1000, 128)))


def attn_times(src: str) -> int:
    """``--attn-times [SRC]``: only the cluster attention, built from the
    source tree ``SRC`` (default: this checkout's ``src``), held against
    its plain version and timed (three runs of ``device_ms``) in bf16 at
    the served shapes, one JSON line a shape.  Two trees run in turns in
    one call compare two versions of the kernel on one card; a shape a
    tree refuses says so."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(src).resolve()))
    from repro_torch.kernels import build, cluster_attn
    from repro_torch.kernels.tiles import TileError
    from repro_torch.roofline.analysis import kernel_bound_ms, kernel_dims
    build.build(["cluster_attn"])
    for name, dims in ATTN_TIME_SHAPES:
        sc = dims[-1] ** -0.5
        inputs = attn_case(*dims, dtype=torch.bfloat16, seed=15)
        row = dict(shape=name, dims=list(dims),
                   library=build.library_path("cluster_attn").name)
        try:
            row["max_abs_err"] = attn_parity(name, *inputs, sc)["max_abs_err"]
        except TileError as e:
            print(json.dumps(dict(row, refused=str(e))), flush=True)
            continue
        fn = rotating(lambda *t: cluster_attn.cluster_attn_partial(*t, sc),
                      *inputs)
        row.update(ms=[device_ms(fn) for _ in range(3)],
                   bound_ms=kernel_bound_ms("cluster_attn", **kernel_dims(
                       "cluster_attn", *inputs))[0])
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--stream-sweep"]:
        sys.exit(stream_sweep(int(sys.argv[2])))
    if sys.argv[1:2] == ["--attn-times"]:
        sys.exit(attn_times(sys.argv[2] if len(sys.argv) > 2
                            else str(ROOT / "src")))
    sys.exit(main())
