"""The tensor-core argmin on the card: past d = 128 (the streamed
layout) against the plain versions and its times, and the d <= 128
tensor-core shapes' times, so that two versions can be compared within
one call.

    python3 tools/tc_argmin_probe.py [--tree DIR] [PHASES]

PHASES is a comma-separated subset of ``parity`` (the Lloyd and assign
kernels against their plain versions at d = 161 to 1024, f32, bf16, one
point set shared by the lanes, all-zero and duplicated centers, gemma3's
refresh on 4 lanes and a 1 x 500,000 x 1000 assignment at d = 256),
``times`` (gemma3's refresh over 8 and 64 lanes, 4 f32 lanes beside the
plain version and one launch of the SIMT route, a small-K shape on both
routes, the d = 256 assignment on both routes and the plain version) and
``d128`` (the d <= 128 tensor-core shapes of the paths: the llama, dbrx
and zamba2 refreshes, the index coarse fits, the sampler's fits and
assignment, the index builds' assignments); by default
``parity,times,d128``.
``--tree DIR`` imports ``repro_torch`` from ``DIR/src`` (for example a
parent commit unpacked with ``git archive`` into a directory
``.gitignore`` lists; run parent, change, change, parent).  Each result is
one JSON line; the card's name and power limit come first.
"""
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TREE = ROOT
args = sys.argv[1:]
if args and args[0] == "--tree":
    TREE = ROOT / args[1]
    args = args[2:]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(TREE / "src"))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import assign, build, lloyd, ref  # noqa: E402

PHASES = args[0].split(",") if args else ["parity", "times", "d128"]


def emit(**kw):
    print(json.dumps(kw), flush=True)


def guard(name, fn):
    t0 = time.perf_counter()
    try:
        r = fn()
        torch.cuda.synchronize()
        emit(probe=name, ok=True, s=time.perf_counter() - t0, result=r)
        return r
    except Exception as e:  # report and go on
        emit(probe=name, ok=False, error=repr(e)[:3000],
             tb=traceback.format_exc()[-3000:])
        return None


torch.backends.cuda.matmul.allow_tf32 = False
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip()
emit(smi=smi, torch=torch.__version__, tree=str(TREE), phases=PHASES)
t0 = time.perf_counter()
build.build(["lloyd", "assign", "centroid"])
emit(build_s=time.perf_counter() - t0, ptxas={
    n: [ln.strip()[:200] for ln in build.build_log(n).splitlines()
        if "registers" in ln or "spill" in ln or "argmin" in ln
        or "stream" in ln or "split" in ln]
    for n in ("lloyd",)})


def lp(name, x, w, c):
    return cs.lloyd_parity(name, x, w, c,
                           cancel=cs.dot_rounding_bound(x, c))


rot = cs.rotating
dms = cs.device_ms

if "parity" in PHASES:
    for shape, kw in [((1, 300, 50, 200), {}), ((2, 1000, 300, 256), {}),
                      ((2, 500, 300, 161), {}),
                      ((2, 500, 300, 256), dict(dtype=torch.bfloat16)),
                      ((2, 500, 300, 161), dict(dtype=torch.bfloat16)),
                      ((3, 1000, 300, 256), dict(share_x=True)),
                      ((2, 4000, 300, 1024), {})]:
        guard(f"lloyd {shape} {kw}", lambda: lp(
            "x", *cs._case(*shape, seed=5, **kw)))
    g4 = cs._case(4, 9216, 8192, 256, seed=35)
    guard("lloyd gemma 4 lanes f32", lambda: lp("g4", *g4))
    g4b = (g4[0].bfloat16().float(), *g4[1:])
    guard("lloyd gemma 4 lanes bf16-valued", lambda: lp("g4b", *g4b))
    guard("centroid gemma 4 lanes",
          lambda: cs.centroid_parity("c4", *g4))
    del g4, g4b

    def zero():
        zx, zw, _ = cs._case(4, 1024, 1, 256, seed=24)
        zc = torch.zeros((4, 8192, 256), device="cuda")
        zpool = torch.cat([zc, zx], 1)
        zpw = torch.cat([torch.zeros((4, 8192), device="cuda"),
                         torch.ones_like(zw)], 1)
        r = lp("zero", zpool, zpw, zc)
        cs.check(r["labels_at_near_ties"] == 0, "zero centers")
        return r
    guard("lloyd zero centers d=256", zero)

    def ties(dtype):
        x, _, c = cs._case(2, 777, 150, 256, seed=9)
        c = torch.cat([c, c], 1)           # center k + 150 equals center k
        x, c = x.to(dtype), c.to(dtype)
        r = cs.assign_parity("ties", x, c)
        idx, _ = assign.assign_argmin(x, c)
        cs.check(bool((idx < 150).all()), "ties: a duplicate won")
        r2 = lp("ties_lloyd", x, torch.ones(x.shape[:2], device="cuda",
                                            dtype=dtype), c)
        return [r, r2]
    guard("assign ties f32 d=256", lambda: ties(torch.float32))
    guard("assign ties bf16 d=256", lambda: ties(torch.bfloat16))
    ax, _, ac = cs._case(1, 500_000, 1000, 256, seed=26)
    guard("assign 1x500000x1000 d=256", lambda: cs.assign_parity(
        "a256", ax, ac))
    del ax, ac

if "times" in PHASES:
    g4 = cs._case(4, 9216, 8192, 256, seed=35)
    g4b = (g4[0].bfloat16().float(), *g4[1:])

    def lanes(t, n):
        return tuple(v.repeat(n // v.shape[0], *[1] * (v.dim() - 1))
                     for v in t)

    def gemma():
        out = {}
        for n in (8, 64):
            xs = lanes(g4b, n)
            out[f"{n}_lanes_bf16_valued"] = [dms(
                lambda: lloyd.lloyd_step(*xs), iters=5) for _ in range(2)]
            del xs
        xs = lanes(g4, 64)
        out["64_lanes_f32"] = dms(lambda: lloyd.lloyd_step(*xs), iters=3)
        del xs
        out["4_lanes_f32"] = [dms(rot(lloyd.lloyd_step, *g4), iters=20)
                              for _ in range(2)]
        out["4_lanes_f32_plain"] = dms(rot(ref.lloyd_step_ref, *g4), iters=2)
        out["4_lanes_f32_simt_once"] = cs.one_launch_ms(
            lambda: lloyd.route_step(*g4, "simt"))
        return out
    guard("gemma refresh times", gemma)

    def small_k():
        x, w, c = cs._case(16, 16384, 64, 256, seed=40)
        out = {}
        for r in ("simt", "tc", "tc", "simt"):
            out.setdefault(r, []).append(dms(rot(
                lambda *t, r=r: lloyd.route_step(*t, r), x, w, c), iters=5))
        return out
    guard("small K 16x16384x64 d=256", small_k)

    def assign256():
        x, _, c = cs._case(1, 500_000, 1000, 256, seed=26)
        out = {}
        for r in ("tc", "simt", "simt", "tc"):
            out.setdefault(r, []).append(dms(rot(
                lambda *t, r=r: assign.route_argmin(*t, r), x, c),
                iters=10 if r == "tc" else 2))
        out["plain"] = dms(rot(ref.assign_argmin_ref, x, c), iters=2)
        return out
    guard("assign 1x500000x1000 d=256", assign256)

if "d128" in PHASES:
    refresh = cs._case(4, 9216, 8192, 128, seed=19)
    lloyd_cases = {
        "refresh4": refresh,
        "dbrx32": tuple(t.repeat(8, *[1] * (t.dim() - 1)) for t in refresh),
        "zamba4": cs._case(4, 9216, 8192, 80, seed=38),
        "coarse200": cs._case(8, 4096, 819, 64, seed=41),
        "coarse5m": cs._case(8, 8192, 1638, 32, seed=42),
        "sampler_local": cs._case(4, 16384, 3276, 32, seed=44),
        "sampler_merge": cs._case(4, 209_664, 1024, 32, share_x=True,
                                  seed=43)}
    assign_cases = {
        "a200k_65536": cs._case(1, 65536, 256, 64, seed=45)[::2],
        "a200k_3392": cs._case(1, 3392, 256, 64, seed=46)[::2],
        "a5m_262144": cs._case(1, 262_144, 512, 32, seed=47)[::2],
        "a5m_19264": cs._case(1, 19264, 512, 32, seed=48)[::2],
        "sampler_assign": cs._case(1, 1_048_576, 1024, 32, seed=49)[::2]}
    if TREE == ROOT:
        for nm in ("refresh4", "coarse200", "coarse5m", "zamba4"):
            guard(f"parity {nm}", lambda nm=nm: lp(nm, *lloyd_cases[nm]))
        for nm in ("a200k_3392", "a5m_19264"):
            guard(f"parity {nm}",
                  lambda nm=nm: cs.assign_parity(nm, *assign_cases[nm]))
    xr, wr, cr = (t.repeat(64, *[1] * (t.dim() - 1)) for t in refresh)
    xb = xr.bfloat16().float()
    r = {}
    for nm, p in (("refresh256_f32", xr), ("refresh256_bf16", xb)):
        r[nm] = [dms(lambda p=p: lloyd.lloyd_step(p, wr, cr), iters=3)
                 for _ in range(2)]
    for nm, case in lloyd_cases.items():
        r[nm] = [dms(rot(lloyd.lloyd_step, *case),
                     iters=5 if nm == "dbrx32" else 20) for _ in range(2)]
    for nm, case in assign_cases.items():
        r[nm] = [dms(rot(assign.assign_argmin, *case), iters=20)
                 for _ in range(2)]
    emit(d128=str(TREE.name), times=r)
emit(done=True, seconds=time.perf_counter() - t0)
