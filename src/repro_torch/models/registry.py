"""Model registry of the port: ``build_model(cfg)`` and ``cache_kind``
(the counterpart of :mod:`repro.models.registry`)."""
from __future__ import annotations

from repro_torch.configs import ArchConfig, ShapeConfig

from .lm import DecoderLM

PORTED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid")


def build_model(cfg: ArchConfig, device=None) -> DecoderLM:
    """The model of ``cfg`` on ``device`` (``None``: the CUDA device), its
    weights zero until ``init_params`` or ``load_state_dict``: the
    families built from the attention block (dense, with or without
    gemma's local/global pattern, MoE and the VLM backbone) and the
    recurrent ones (``ssm``: xlstm; ``hybrid``: zamba2).  The
    encoder-decoder family (``audio``) raises ``NotImplementedError``."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"repro_torch: {cfg.name} needs the {cfg.family!r} blocks, which "
            f"are not ported yet; see ROADMAP.md §1")
    return DecoderLM(cfg, device=device)


def cache_kind(cfg: ArchConfig, shape: ShapeConfig) -> str:
    """Which decode cache the (arch x shape) cell uses: long_500k on
    attention archs (zamba2's shared attention among them) uses the
    paper's clustered-KV compression; xlstm's state is O(1) whatever the
    kind."""
    if shape.kind != "decode":
        return "full"
    if shape.cluster_compression and cfg.family in ("dense", "moe", "vlm",
                                                    "hybrid"):
        return "clustered"
    return "full"
