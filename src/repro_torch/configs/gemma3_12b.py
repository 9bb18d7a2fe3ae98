"""Assigned architecture config: gemma3_12b."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b", family="dense", n_layers=48, d_model=3840,
    n_heads=16, n_kv_heads=8, head_dim=256, d_ff=15360, vocab=262144,
    window=1024, local_per_global=5, rope_theta=1000000.0,
    tie_embeddings=True,
    source="hf:google/gemma-3; 5:1 local:global, 128k ctx")
