"""Model registry of the port: ``build_model(cfg)``, ``cache_kind`` and the
workloads' input specs (the counterpart of :mod:`repro.models.registry`).

``input_specs(cfg, shape)`` gives every data input of a workload step as a
tensor on the ``meta`` device (its shape and dtype, no storage);
``batch_like`` draws a concrete batch of those shapes."""
from __future__ import annotations

import zlib

import torch

from repro_torch.configs import ArchConfig, ShapeConfig
from repro_torch.core.device import derive_seed, resolve_device

from .encdec import EncDecLM
from .lm import DecoderLM


def build_model(cfg: ArchConfig, device=None) -> "DecoderLM | EncDecLM":
    """The model of ``cfg`` on ``device`` (``None``: the CUDA device), its
    weights zero until ``init_params`` or ``load_state_dict``: the
    encoder-decoder (``audio``: whisper) as an :class:`EncDecLM`; the
    families built from the attention block (dense, with or without
    gemma's local/global pattern, MoE and the VLM backbone) and the
    recurrent ones (``ssm``: xlstm; ``hybrid``: zamba2) as a
    :class:`DecoderLM`."""
    if cfg.family == "audio":
        return EncDecLM(cfg, device=device)
    return DecoderLM(cfg, device=device)


def cache_kind(cfg: ArchConfig, shape: ShapeConfig) -> str:
    """Which decode cache the (arch x shape) cell uses: long_500k on
    attention archs (zamba2's shared attention among them) uses the
    paper's clustered-KV compression; xlstm's state is O(1) whatever the
    kind, and the encoder-decoder decodes on the full cache."""
    if shape.kind != "decode":
        return "full"
    if shape.cluster_compression and cfg.family in ("dense", "moe", "vlm",
                                                    "hybrid"):
        return "clustered"
    return "full"


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """The data inputs of the workload step, each a ``meta`` tensor: for
    a train or prefill step ``tokens`` and ``labels`` (B, S) int32, with
    whisper's ``frames`` (B, encoder_ctx, d) or a VLM's ``patches`` (B,
    n_patches, d) in bf16; for a decode step one ``token`` (B, 1) and the
    write position ``pos`` (the caches come from ``init_caches``)."""
    b, s = shape.global_batch, shape.seq_len

    def spec(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        specs = {"tokens": spec((b, s)), "labels": spec((b, s))}
        if cfg.family == "audio":
            specs = {"frames": spec((b, cfg.encoder_ctx, cfg.d_model),
                                    torch.bfloat16), **specs}
        elif cfg.n_patches:
            specs["patches"] = spec((b, cfg.n_patches, cfg.d_model),
                                    torch.bfloat16)
        return specs
    return {"token": spec((b, 1)), "pos": spec(())}


def batch_like(cfg: ArchConfig, shape: ShapeConfig, seed: int = 0, *,
               device=None) -> dict:
    """A concrete batch of :func:`input_specs`' shapes and dtypes on
    ``device`` (``None``: the CUDA device): token ids uniform in [0,
    vocab), ``pos`` = seq_len - 1, frames and patches standard normal
    draws (f32, then cast).  Each input draws from its own generator,
    seeded from ``seed`` and the input's name (the reference folds
    Python's ``hash`` of the name, which varies between processes)."""
    dev = resolve_device(device)
    out = {}
    for name, sds in input_specs(cfg, shape).items():
        gen = torch.Generator(device=dev)
        gen.manual_seed(derive_seed(seed, zlib.crc32(name.encode())))
        if name == "pos":
            out[name] = torch.tensor(shape.seq_len - 1, dtype=torch.int32,
                                     device=dev)
        elif sds.dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab, sds.shape, generator=gen,
                                      dtype=torch.int32, device=dev)
        else:
            out[name] = torch.randn(sds.shape, generator=gen, device=dev
                                    ).to(sds.dtype)
    return out
