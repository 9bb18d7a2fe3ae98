"""Assigned architecture config: deepseek_67b."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b", family="dense", n_layers=95, d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=22016, vocab=102400,
    rope_theta=10000.0, source="arXiv:2401.02954; llama-arch dense")
