"""Serving launcher of the port: batched greedy/sampled generation from a
model with weights drawn from a seed, or restored from a trainer's
checkpoint.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --prompt-len 64 --gen 16 --batch 2

Runs on the CUDA device, for any architecture ``build_model`` builds
(dense, gemma3's local/global, MoE, the VLM backbone on text prompts,
xlstm, zamba2, and whisper, whose cross-attention caches stay zero as in
the reference's engine).
The shape is a decode shape of ``prompt-len + gen`` tokens with the full
KV cache.  ``--ckpt-dir`` restores ``params`` from the newest complete
checkpoint of a trainer's directory (``repro_torch.launch.train``) and
raises where it holds none.  ``main`` returns the generated tokens and
the model served.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore params from a trainer checkpoint")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.convert import bind_stacked, stacked_like
    from repro_torch.core.device import derive_seed, resolve_device
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is None:
        raise FileNotFoundError(f"repro_torch.launch.serve: no complete "
                                f"checkpoint in {args.ckpt_dir}")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(None)
    model = build_model(cfg, device=dev)
    if args.ckpt_dir:
        state, _ = ckpt.restore_latest(
            args.ckpt_dir, {"params": stacked_like(cfg)}, device=dev)
        bind_stacked(model, state["params"])
    else:
        model.init_params(0)
    shape = ShapeConfig("serve", args.prompt_len + args.gen, args.batch,
                        "decode")
    eng = ServeEngine(cfg, shape, model,
                      ServeConfig(max_tokens=args.gen,
                                  temperature=args.temperature))
    gen = torch.Generator(device=dev)
    gen.manual_seed(derive_seed(0, 1))
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    out = eng.generate(prompt)
    for b in range(args.batch):
        print(f"[{b}] {out[b].tolist()}")
    return out, model


if __name__ == "__main__":
    main()
