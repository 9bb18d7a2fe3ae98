"""Model registry of the port: ``build_model(cfg)`` and ``cache_kind``
(the counterpart of :mod:`repro.models.registry`)."""
from __future__ import annotations

from repro_torch.configs import ArchConfig, ShapeConfig

from .lm import DecoderLM


def build_model(cfg: ArchConfig, device=None) -> DecoderLM:
    """The model of ``cfg`` on ``device`` (``None``: the CUDA device), its
    weights zero until ``init_params`` or ``load_state_dict``.  Only the
    dense family without a local/global pattern is ported; any other
    raises ``NotImplementedError``."""
    if cfg.family != "dense" or cfg.local_per_global:
        what = "local_per_global" if cfg.local_per_global else cfg.family
        raise NotImplementedError(
            f"repro_torch: {cfg.name} needs the {what!r} blocks, which are "
            f"not ported yet; see ROADMAP.md §1")
    return DecoderLM(cfg, device=device)


def cache_kind(cfg: ArchConfig, shape: ShapeConfig) -> str:
    """Which decode cache the (arch x shape) cell uses: long_500k on
    attention archs uses the paper's clustered-KV compression."""
    if shape.kind != "decode":
        return "full"
    if shape.cluster_compression and cfg.family in ("dense", "moe", "vlm",
                                                    "hybrid"):
        return "clustered"
    return "full"
