"""Assigned architecture config: llama4_maverick_400b_a17b."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe", n_layers=48,
    d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128, d_ff=8192,
    vocab=202048, n_experts=128, experts_per_token=1,
    rope_theta=500000.0, source="hf:meta-llama/Llama-4; MoE 128e top-1")
