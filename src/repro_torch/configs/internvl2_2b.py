"""Assigned architecture config: internvl2_2b."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=8, head_dim=128, d_ff=8192, vocab=92553,
    n_patches=256, rope_theta=1000000.0,
    source="arXiv:2404.16821; InternViT(stub) + InternLM2 backbone")
