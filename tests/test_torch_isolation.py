"""The port stands alone: importing it loads neither JAX nor the JAX
package, and no source file of the port (or chip_smoke.py) imports them."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import sys
import repro_torch, repro_torch.api, repro_torch.convert, repro_torch.core
import repro_torch.core.pipeline, repro_torch.kernels, repro_torch.kernels.build
import repro_torch.configs, repro_torch.data, repro_torch.telemetry
import repro_torch.data.source, repro_torch.index, repro_torch.index.ivf
import repro_torch.index.pq, repro_torch.index.spec
import repro_torch.kernels.scan, repro_torch.kernels.centroid
import repro_torch.kernels.cluster_attn, repro_torch.models
import repro_torch.models.lm, repro_torch.models.attention
import repro_torch.models.moe, repro_torch.models.registry
import repro_torch.models.ssm
import repro_torch.stream, repro_torch.stream.kv, repro_torch.serve
import repro_torch.stream.engine, repro_torch.data.synthetic
import repro_torch.serve.engine, repro_torch.launch.serve
import repro_torch.launch.mesh, repro_torch.core.distributed
import repro_torch.stream.distributed
import repro_torch.kernels.autotune, repro_torch.kernels.tune_table
import repro_torch.tree, repro_torch.ckpt, repro_torch.ckpt.checkpoint
import repro_torch.optim, repro_torch.optim.adamw, repro_torch.optim.adafactor
import repro_torch.optim.schedule, repro_torch.train, repro_torch.train.step
import repro_torch.train.compress, repro_torch.train.trainer
import repro_torch.launch.train
import repro_torch.models.encdec, repro_torch.data.pipeline
import repro_torch.train.sharding, repro_torch.launch.dryrun
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print("LOADED", bad)
"""


def test_importing_the_port_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                       text=True, timeout=120, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert "LOADED []" in r.stdout, r.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)\b|from\s+(jax|jaxlib|repro)(\.|\s))",
    re.MULTILINE)


def test_no_source_file_imports_jax_or_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    names = {str(f.relative_to(ROOT / "src")) for f in files[:-1]}
    assert {"repro_torch/data/source.py", "repro_torch/index/ivf.py",
            "repro_torch/index/pq.py", "repro_torch/index/spec.py",
            "repro_torch/kernels/scan.py",
            "repro_torch/kernels/centroid.py",
            "repro_torch/kernels/cluster_attn.py",
            "repro_torch/models/attention.py", "repro_torch/models/lm.py",
            "repro_torch/models/layers.py", "repro_torch/models/registry.py",
            "repro_torch/models/moe.py",
            "repro_torch/stream/kv.py", "repro_torch/stream/engine.py",
            "repro_torch/serve/engine.py",
            "repro_torch/launch/serve.py", "repro_torch/launch/mesh.py",
            "repro_torch/core/distributed.py",
            "repro_torch/stream/distributed.py",
            "repro_torch/configs/llama3_8b.py",
            "repro_torch/kernels/autotune.py",
            "repro_torch/kernels/tune_table.py", "repro_torch/tree.py",
            "repro_torch/ckpt/checkpoint.py", "repro_torch/optim/adamw.py",
            "repro_torch/optim/adafactor.py",
            "repro_torch/optim/schedule.py", "repro_torch/train/step.py",
            "repro_torch/train/compress.py",
            "repro_torch/train/trainer.py",
            "repro_torch/launch/train.py", "repro_torch/models/encdec.py",
            "repro_torch/data/pipeline.py",
            "repro_torch/data/synthetic.py",
            "repro_torch/train/sharding.py",
            "repro_torch/launch/dryrun.py"} <= names
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if _FORBIDDEN.search(f.read_text())]
    assert offenders == []
