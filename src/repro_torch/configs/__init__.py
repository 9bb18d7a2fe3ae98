"""Configurations of the PyTorch port: the paper's named clustering
workloads, and the model architectures and input shapes of the serving
path (a copy of the JAX package's ``repro.configs``, as data).

Every architecture is one ``<arch>.py`` module exporting ``CONFIG``;
``get_config(name)`` resolves dashed CLI ids (``--arch llama3-8b``) for
every id, and ``repro_torch.models.build_model`` builds each.  ``SHAPES``
are the four input-shape workloads; ``cells()`` yields the (arch x shape)
matrix with its skips.
"""
from __future__ import annotations

import dataclasses
import importlib

# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | audio | vlm | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    expert_capacity_factor: float = 1.25

    # attention pattern (gemma3: 5 local : 1 global)
    window: int = 0             # sliding window for local layers
    local_per_global: int = 0   # local layers per global layer (0 = all global)

    # SSM / hybrid
    ssm_state: int = 0
    mlstm_per_slstm: int = 0    # xlstm: 7 mLSTM : 1 sLSTM
    mamba_per_attn: int = 0     # zamba2: mamba layers per shared-attn block

    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_ctx: int = 0        # precomputed frame embeddings (stub frontend)

    # VLM
    n_patches: int = 0          # precomputed patch embeddings (stub frontend)

    # common
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    source: str = ""

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embed/head weight vocab padded to a multiple of 256 so the vocab
        dim shards on the 16-way mesh axes (whisper 51865, internvl2 92553,
        llama4 202048 are ragged; labels always stay < vocab)."""
        return -(-self.vocab // 256) * 256

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        # shrink superblock pattern ratios with the layer count, so the
        # reduced model keeps >= 1 superblock (a 4-layer model with the full
        # 9:1 mamba:attn ratio would have ZERO blocks — caught by tests)
        lpg = 1 if self.local_per_global else 0
        mps = 3 if self.mlstm_per_slstm else 0
        mpa = 2 if self.mamba_per_attn else 0
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            local_per_global=lpg,
            mlstm_per_slstm=mps,
            mamba_per_attn=mpa,
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=512,
            n_experts=min(4, self.n_experts) if self.n_experts else 0,
            experts_per_token=min(2, self.experts_per_token)
            if self.experts_per_token else 0,
            window=min(32, self.window) if self.window else 0,
            ssm_state=min(16, self.ssm_state) if self.ssm_state else 0,
            encoder_layers=min(2, self.encoder_layers) if self.encoder_layers else 0,
            encoder_ctx=min(32, self.encoder_ctx) if self.encoder_ctx else 0,
            n_patches=min(8, self.n_patches) if self.n_patches else 0,
            # CPU smoke tests: the CPU backend lacks some bf16 dot thunks;
            # the full configs stay bf16 (dry-run only lowers, never runs).
            dtype="float32",
        )

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6*N*D)."""
        d, dh = self.d_model, self.dh
        h, kv = self.n_heads, self.n_kv_heads
        attn = d * h * dh + 2 * d * kv * dh + h * dh * d
        if self.family == "ssm":   # mLSTM/sLSTM projections (approx 2x expand)
            per_layer = 2 * (d * 2 * d) + 2 * d * d + 4 * d  # in/out + qkv-ish
        elif self.family == "hybrid":
            dins = 2 * d  # mamba expand 2
            per_layer = d * 2 * dins + dins * (2 * self.ssm_state) + dins * d
        else:
            per_layer = attn + self._ffn_params()
        total = self.n_layers * per_layer
        if self.family == "hybrid" and self.mamba_per_attn:
            n_shared = 1  # weights are shared
            total += n_shared * (attn + 3 * d * self.d_ff)
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.encoder_layers:
            total += self.encoder_layers * (attn + 2 * d * self.d_ff)
            total += self.n_layers * attn  # cross attention
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.n_layers * self.n_experts * 3 * d * self.d_ff
        return dense + self.n_layers * self.experts_per_token * 3 * d * self.d_ff

    def _ffn_params(self) -> int:
        d = self.d_model
        if self.n_experts:
            return self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        return 3 * d * self.d_ff  # SwiGLU


# ---------------------------------------------------------------------------
# Workload shapes (assigned)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode
    # decode-only knobs
    cluster_compression: int = 0   # paper technique: KV cache compression c
    cluster_window: int = 1024     # exact recent window kept alongside centroids


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode",
                             cluster_compression=64, cluster_window=1024),
}

ARCH_IDS = [
    "deepseek-67b", "llama3-8b", "internlm2-20b", "gemma3-12b",
    "llama4-maverick-400b-a17b", "dbrx-132b", "whisper-base",
    "internvl2-2b", "xlstm-1.3b", "zamba2-2.7b",
]


def get_config(name: str) -> ArchConfig:
    mod = importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))
    return mod.CONFIG


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable, note).  The only skip: whisper x long_500k (enc-dec
    specified for 30 s audio; a 500k-token decoder context has no
    meaning).  Attention archs run long_500k *with the paper's clustered-KV
    compression*."""
    if shape.name == "long_500k" and cfg.family == "audio":
        return False, "skipped: enc-dec audio, 30s inputs by construction"
    if shape.name == "long_500k" and cfg.family in ("ssm", "hybrid"):
        return True, "native O(1)-state decode"
    if shape.name == "long_500k":
        return True, f"clustered-KV decode (paper technique, c={shape.cluster_compression})"
    return True, ""


def cells():
    """All (arch, shape, runnable, note) dry-run cells."""
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES.values():
            ok, note = shape_applicable(cfg, s)
            out.append((a, s.name, ok, note))
    return out


from .paper_clustering import (COMPRESSION_SWEEP, PAPER_WORKLOADS,  # noqa: E402
                               workload_spec)

__all__ = ["ARCH_IDS", "ArchConfig", "COMPRESSION_SWEEP", "PAPER_WORKLOADS",
           "SHAPES", "ShapeConfig", "cells", "get_config", "shape_applicable",
           "workload_spec"]
