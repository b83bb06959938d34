"""whisper-large-v3 — enc-dec, conv frontend (stub) [arXiv:2212.04356; unverified].

32L (decoder) d_model=1280 20H (MHA kv=20) d_ff=5120 vocab=51866; 32 encoder
layers over 1500 audio frames. The conv1d mel frontend is a STUB per the
assignment: input_specs() provides precomputed frame embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1_280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5_120,
    vocab_size=51_866,
    head_dim=64,
    is_encoder_decoder=True,
    n_encoder_layers=32,
    encoder_seq=1_500,
    n_mels=128,
    act="gelu",
    source="arXiv:2212.04356; unverified",
)
