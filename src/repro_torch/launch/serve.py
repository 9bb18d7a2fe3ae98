"""Serving launcher of the port: batched greedy/sampled generation from a
model with weights drawn from a seed.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --prompt-len 64 --gen 16 --batch 2

Runs on the CUDA device, for any architecture ``build_model`` builds
(dense, gemma3's local/global, MoE, the VLM backbone on text prompts,
xlstm and zamba2).
The shape is a decode shape of ``prompt-len + gen`` tokens with the full
KV cache.  ``--ckpt-dir`` is refused: the
checkpoint module is not ported yet (ROADMAP §1).
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

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.device import derive_seed, resolve_device
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    if args.ckpt_dir:
        raise NotImplementedError(
            "repro_torch.launch.serve: --ckpt-dir needs the checkpoint "
            "module, which is not ported yet; see ROADMAP.md §1")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(None)
    model = build_model(cfg, device=dev).init_params(0)
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
    return out


if __name__ == "__main__":
    main()
