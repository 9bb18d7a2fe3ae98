"""Assigned architecture config: llama3_8b."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab=128256,
    rope_theta=500000.0, source="arXiv:2407.21783; GQA 128k vocab")
