"""gemma2-2b — local+global alternating, logit softcap [arXiv:2408.00118; hf].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2_304,
    n_heads=8,
    n_kv_heads=4,
    d_ff=9_216,
    vocab_size=256_000,
    head_dim=256,
    layer_pattern="local_global",
    local_window=4_096,
    logit_softcap=30.0,
    attn_softcap=50.0,
    post_norm=True,
    tie_embeddings=True,
    act="gelu",
    source="arXiv:2408.00118; hf",
)
