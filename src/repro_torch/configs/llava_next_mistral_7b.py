"""llava-next-mistral-7b — anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000. The vision tower is a
STUB per the assignment: input_specs() provides precomputed patch embeddings
(anyres: base 576 + up to 4 tiles x 576 = 2880 image tokens) which are
prepended to the text embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4_096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=32_000,
    head_dim=128,
    n_image_tokens=2_880,
    rope_theta=1_000_000.0,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)
