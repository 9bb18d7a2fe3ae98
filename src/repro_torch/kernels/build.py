"""Build the port's CUDA kernels from the sources in ``csrc/`` at first use.

Each ``<name>.cu`` becomes a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so

The file name carries a hash of the sources (``<name>.cu`` and the shared
``*.cuh`` headers) and the flags, so an edit rebuilds and an unchanged tree
loads what is there.  The compiler's output (``-Xptxas -v``: registers,
shared memory, spills per kernel) is kept beside the library as ``.log``.
The build directory is ``build/kernels`` at the root of the source tree.

A failed build raises with the compiler's output.  Nothing falls back.

:func:`counters` hands the kernels that finish a reduction in their last
block (``centroid.cu``, ``cluster_attn.cu``) their integer arrival counters.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("lloyd", "assign", "centroid", "adc_scan", "cluster_attn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_COUNTERS: dict[tuple, torch.Tensor] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the
    PATH, or ``/usr/local/cuda/bin/nvcc``."""
    candidates = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
                  if os.environ.get("CUDA_HOME") else None,
                  shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("repro_torch kernels: nvcc not found (set CUDA_HOME "
                       "or put nvcc on the PATH); the CUDA kernels are built "
                       "from source at first use")


def library_path(name: str) -> Path:
    """Where ``<name>.cu`` builds to, keyed by its sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Build every named library that is not built yet, one ``nvcc`` per
    source, all started together.  Returns the library paths."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, p in todo.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (exit {proc.returncode})\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        todo[n].with_suffix(".log").write_text(out)
        os.replace(tmp, todo[n])     # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("repro_torch kernel build failed:\n"
                           + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """The compiler's output for the built ``<name>`` library."""
    return library_path(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded ``<name>`` library, built first if needed (cached for the
    life of the process)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build([name])[name]))
    return lib


def counters(device: torch.device, n: int) -> torch.Tensor:
    """``n`` int32 arrival counters on ``device`` for the current stream,
    zero when handed out.  A kernel's last block resets the counters it
    used, so they are zero again for the next launch on that stream; one
    buffer per (device, stream), grown when a launch needs more."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                           device=device)
    return buf
