"""Config system: model configs, input shapes, mesh/run configs.

Every assigned architecture gets a ``configs/<id>.py`` exporting ``CONFIG``.
``repro_torch.configs.registry`` resolves ``--arch <id>`` strings.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description covering all assigned families.

    Families: dense | moe | ssm | hybrid | vlm | audio.
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0                 # 0 -> d_model // n_heads
    qkv_bias: bool = False
    o_bias: bool = False
    mlp_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    logit_softcap: float = 0.0        # gemma2: 30.0 final / 50.0 attn
    attn_softcap: float = 0.0
    local_window: int = 0             # sliding-window size for local layers
    layer_pattern: str = "global"     # "global" | "local_global" | custom csv
    global_every: int = 0             # hymba: 1 global layer every k (else local)
    parallel_block: bool = False      # command-r: x + attn(n(x)) + mlp(n(x))
    post_norm: bool = False           # gemma2 sandwich norms

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                 # expert FFN width (d_ff used if 0)
    shared_expert: bool = False       # moonlight-style shared expert
    capacity_factor: float = 1.25

    # --- SSM / xLSTM ---
    ssm_state: int = 0                # mamba state size
    conv_width: int = 4
    ssm_expand: int = 2
    slstm_every: int = 0              # xlstm: sLSTM block every k blocks (0=never)
    mlstm_heads: int = 4

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500           # whisper: 30s of audio -> 1500 frames
    n_mels: int = 128

    # --- VLM ---
    n_image_tokens: int = 0           # stub patch embeddings prepended

    norm_eps: float = 1e-5
    act: str = "silu"                 # silu | gelu
    dtype: str = "bfloat16"
    source: str = ""                  # provenance tag from the assignment

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.resolved_head_dim
        p = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            p += self.vocab_size * d
        per_layer = 0
        # attention (for families that have it)
        if self.family in ("dense", "moe", "vlm", "audio", "hybrid"):
            qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
            per_layer += qkv + (self.n_heads * hd) * d
            if self.qkv_bias:
                per_layer += self.n_heads * hd + 2 * self.n_kv_heads * hd
        if self.family == "moe":
            dff = self.moe_d_ff or self.d_ff
            per_layer += self.n_experts * 3 * d * dff + d * self.n_experts
            if self.shared_expert:
                per_layer += 3 * d * self.d_ff
        elif self.d_ff:
            per_layer += 3 * d * self.d_ff  # swiglu: gate, up, down
        if self.family in ("ssm", "hybrid"):
            dinner = self.ssm_expand * d
            per_layer += d * dinner * 2 + dinner * self.conv_width
            per_layer += dinner * self.ssm_state * 2 + dinner * 2  # B,C,dt,D
            per_layer += dinner * d
        if self.family == "ssm" and self.d_ff == 0:
            # xlstm mLSTM block: qkv + igate/fgate + out
            dinner = self.ssm_expand * d
            per_layer += d * dinner * 3 + dinner * 3 + dinner * d
        per_layer += 2 * d  # norms
        p += self.n_layers * per_layer
        if self.is_encoder_decoder:
            enc_layer = 4 * d * d + 3 * d * self.d_ff + 2 * d
            p += self.n_encoder_layers * enc_layer
            p += self.n_layers * (4 * d * d)  # decoder cross-attention
        return p

    def n_active_params(self) -> int:
        """Active params per token (MoE discounts inactive experts)."""
        if self.family != "moe":
            return self.n_params()
        dff = self.moe_d_ff or self.d_ff
        inactive = (self.n_experts - self.top_k) * 3 * self.d_model * dff
        return self.n_params() - self.n_layers * inactive


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

# Archs allowed to run long_500k (sub-quadratic by construction).
LONG_CONTEXT_ARCHS = ("xlstm-125m", "hymba-1.5b")


def shape_cells(arch: str) -> Tuple[str, ...]:
    """The assigned (shape) cells for an arch, honoring the long_500k rule."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_ARCHS:
        cells.append("long_500k")
    return tuple(cells)


@dataclass(frozen=True)
class RunConfig:
    """Training/serving run hyperparameters + distribution flags."""

    seq_len: int = 4096
    global_batch: int = 256
    microbatch: int = 0            # 0 = no gradient accumulation
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    seed: int = 0

    # distribution
    remat: str = "full"            # "none" | "full" | "dots" (checkpoint policy)
    zero1: bool = False            # shard optimizer state over data axis
    grad_compression: str = "none" # "none" | "topk"
    topk_ratio: float = 0.01
    use_pallas: bool = False       # pallas kernels (TPU only; XLA path on CPU)
    scan_layers: bool = True
    # perf knobs (baseline defaults; see EXPERIMENTS.md §Perf for measured
    # wins — production deployments enable both)
    attn_batch_reshard: bool = False   # reshard batch over (data, model) for
                                       # attention when heads don't divide TP
    decode_grouped: bool = False       # GQA-grouped decode attention (no kv
                                       # expansion -> no KV read amplification)
    decode_cache_anchor: bool = False  # with_sharding_constraint on the
                                       # decode cache update (stops SPMD from
                                       # all-gathering a seq-sharded cache)
    attn_pad_heads: bool = False       # pad q-heads up to a TP multiple so
                                       # attention shards without reshards
                                       # (wastes pad/Hq flops, zero comms)
    decode_slim_mask: bool = False     # single-query decode: the kv_len mask
                                       # subsumes causality; skip the causal
                                       # compare (one less (B,S) mask pass)
    param_dtype_bf16: bool = False     # bf16 master params + moments
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # serving
    page_size: int = 64            # KV page tokens
    max_pages_per_seq: int = 8192

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        name=cfg.name + "-smoke",
    )
    if cfg.family == "moe":
        kw.update(n_experts=min(cfg.n_experts, 4), moe_d_ff=128,
                  top_k=min(cfg.top_k, 2))
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=min(cfg.ssm_state or 8, 8))
    if cfg.is_encoder_decoder:
        kw.update(n_encoder_layers=2, encoder_seq=64)
    if cfg.n_image_tokens:
        kw.update(n_image_tokens=16)
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)
