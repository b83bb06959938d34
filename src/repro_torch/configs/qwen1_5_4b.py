"""qwen1.5-4b — QKV bias [hf:Qwen/Qwen1.5-0.5B family; hf].

40L d_model=2560 20H (GQA kv=20) d_ff=6912 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2_560,
    n_heads=20,
    n_kv_heads=20,       # MHA (kv == q heads)
    d_ff=6_912,
    vocab_size=151_936,
    head_dim=128,
    qkv_bias=True,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)
