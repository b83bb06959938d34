"""llama4-scout-17b-a16e — MoE, early fusion [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1
(+ shared expert, per Llama-4).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5_120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8_192,
    vocab_size=202_048,
    head_dim=128,
    n_experts=16,
    top_k=1,
    moe_d_ff=8_192,
    shared_expert=True,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
