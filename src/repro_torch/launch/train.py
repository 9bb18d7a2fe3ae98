"""Training launcher of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --steps 100 --reduced --ckpt-dir CKPT_DIR

Trains with weights drawn from seed 0 and batches from ``token_stream``;
a directory that holds a checkpoint resumes from its newest complete
step.  ``--data-mesh N --model-mesh M`` trains on an N x M mesh of the
first N M CUDA cards (raises when fewer are visible) with the train
state sharded over it by the reference's partition rules: each card
holds its blocks of the parameters, the gradient accumulator and the
optimizer state.  The N data cards compute, each on whole micro-batches
(``--n-micro`` must be a multiple of N); the "model" cards hold their
blocks, and their compute waits for tensor parallelism.  A checkpoint
written on one mesh resumes on another.
"""
from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-sized)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    args = ap.parse_args(argv)

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.step import TrainPlan
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    mesh = make_host_mesh(args.data_mesh, args.model_mesh)
    plan = TrainPlan(n_micro=args.n_micro, q_chunk=min(2048, args.seq))
    tc = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir, log_every=10)
    trainer = Trainer(cfg, shape, mesh, tc, plan=plan)
    state, hist = trainer.run()
    print(f"done: loss {hist[0]:.4f} -> {hist[-1]:.4f} "
          f"({len(hist)} steps this run)")
    return state, hist


if __name__ == "__main__":
    main()
