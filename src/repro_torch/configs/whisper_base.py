"""Assigned architecture config: whisper_base."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio", n_layers=6, d_model=512,
    n_heads=8, n_kv_heads=8, head_dim=64, d_ff=2048, vocab=51865,
    encoder_layers=6, encoder_ctx=1500, rope_theta=10000.0,
    source="arXiv:2212.04356; enc-dec, conv frontend stubbed")
