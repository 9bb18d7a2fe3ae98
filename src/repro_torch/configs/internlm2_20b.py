"""Assigned architecture config: internlm2_20b."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b", family="dense", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=16384, vocab=92544,
    rope_theta=1000000.0, source="arXiv:2403.17297; GQA")
