"""Assigned architecture config: dbrx_132b."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe", n_layers=40, d_model=6144,
    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=10752, vocab=100352,
    n_experts=16, experts_per_token=4, rope_theta=500000.0,
    source="hf:databricks/dbrx-base; 16e top-4 fine-grained")
