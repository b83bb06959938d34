"""hymba-1.5b — parallel attn+mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Each block runs attention heads and mamba heads in parallel on the same
input and fuses (mean of normed outputs). Most attention is sliding-window;
1 global layer every 11 (3 global layers total), per the paper.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1_600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5_504,
    vocab_size=32_001,
    head_dim=64,
    ssm_state=16,
    ssm_expand=2,
    conv_width=4,
    local_window=1_024,
    global_every=11,
    source="arXiv:2411.13676; hf",
)
