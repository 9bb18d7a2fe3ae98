"""Assigned architecture config: zamba2_2_7b."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, head_dim=80, d_ff=10240, vocab=32000,
    ssm_state=64, mamba_per_attn=9,
    source="arXiv:2411.15242; Mamba2 + shared attention blocks")
