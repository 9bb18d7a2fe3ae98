"""Assigned architecture config: xlstm_1_3b."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm", n_layers=48, d_model=2048,
    n_heads=4, n_kv_heads=4, head_dim=512, d_ff=0, vocab=50304,
    mlstm_per_slstm=7, source="arXiv:2405.04517; xLSTM[7:1] mLSTM+sLSTM")
