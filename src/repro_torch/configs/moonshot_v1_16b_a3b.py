"""moonshot-v1-16b-a3b — kimi/moonlight, 64e top-6 [hf:moonshotai/Moonlight-16B-A3B; hf].

48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6
(+ shared expert, DeepSeek-V3-style fine-grained experts).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2_048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1_408,
    vocab_size=163_840,
    head_dim=128,
    n_experts=64,
    top_k=6,
    moe_d_ff=1_408,
    shared_expert=True,
    rope_theta=50_000.0,
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)
