"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

12L d_model=768 4H (GQA kv=4) d_ff=0 vocab=50304. d_ff=0: xLSTM blocks carry
their own up/down projections (no separate FFN). Every 4th block is sLSTM
(scalar memory, sequential); the rest are mLSTM (matrix memory, parallel).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    head_dim=192,          # 768 / 4
    mlstm_heads=4,
    slstm_every=4,
    ssm_expand=2,
    tie_embeddings=True,
    source="arXiv:2405.04517; unverified",
)
