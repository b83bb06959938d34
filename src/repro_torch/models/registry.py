"""Uniform model interface: init / train_loss / init_cache / prefill /
decode_step.

Port of ``repro/models/registry.py``: dense, moe and vlm
(``models/lm.py``), ssm (``models/xlstm.py``), hybrid (``models/hymba.py``)
and audio (``models/whisper.py``). ``ModelBundle.abstract_params`` and
``axes`` give the dry-run meta params and the sharding rules' logical axes;
``input_specs(cfg, shape)`` gives meta stand-ins for every data input of a
step. ``train_loss``, ``prefill`` and ``decode_step`` pass ``mesh`` and
``batch_axes`` on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import hymba as hymba_lib
from repro_torch.models import lm as lm_lib
from repro_torch.models import whisper as whisper_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.common import abstract_params, param_axes

PyTree = Any

_LIBS = {"ssm": xlstm_lib, "hybrid": hymba_lib, "audio": whisper_lib}


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init: Callable[..., PyTree]
    full_defs: Callable[[], PyTree]
    train_loss: Callable[..., torch.Tensor]
    init_cache: Callable[..., PyTree]
    prefill: Optional[Callable[..., Any]]
    decode_step: Callable[..., Any]

    def abstract_params(self, dtype=torch.float32) -> PyTree:
        return abstract_params(self.full_defs(), dtype)

    def axes(self) -> PyTree:
        return param_axes(self.full_defs())


def get_model(cfg: ModelConfig) -> ModelBundle:
    lib = _LIBS.get(cfg.family, lm_lib)       # dense / moe / vlm: lm
    return ModelBundle(
        cfg=cfg,
        init=lambda gen, dtype=torch.float32: lib.init(gen, cfg, dtype),
        full_defs=lambda: lib.full_defs(cfg),
        train_loss=lambda p, run, batch, **kw:
            lib.train_loss(p, cfg, run, batch, **kw),
        init_cache=lambda batch, max_seq, dtype=torch.bfloat16, device="cuda":
            lib.init_cache(cfg, batch, max_seq, dtype, device),
        prefill=lambda p, run, cache, tokens, **kw:
            lib.prefill(p, cfg, run, cache, tokens, **kw),
        decode_step=lambda p, run, cache, token, pos, **kw:
            lib.decode_step(p, cfg, run, cache, token, pos, **kw),
    )


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                compute_dtype=torch.bfloat16) -> Dict[str, Any]:
    """Meta stand-ins for the step's data inputs, with the reference's keys
    and shapes.

    train/prefill: token batch (+ stub modality embeddings).
    decode: one new token + per-seq position + the KV cache/state.
    """
    B, S = shape.global_batch, shape.seq_len

    def tok(shape_):
        return torch.empty(shape_, dtype=torch.int32, device="meta")

    def emb(n):
        return torch.empty((B, n, cfg.d_model), dtype=compute_dtype,
                           device="meta")

    if shape.kind == "train":
        batch: Dict[str, Any] = {}
        if cfg.family == "vlm":
            s_text = S - cfg.n_image_tokens
            batch["tokens"] = tok((B, s_text))
            batch["labels"] = tok((B, s_text))
            batch["image_embeds"] = emb(cfg.n_image_tokens)
        else:
            batch["tokens"] = tok((B, S))
            batch["labels"] = tok((B, S))
            if cfg.family == "audio":
                batch["audio_embeds"] = emb(cfg.encoder_seq)
        return {"batch": batch}

    if shape.kind == "prefill":
        spec: Dict[str, Any] = {"tokens": tok((B, S))}
        if cfg.family == "vlm":
            spec["tokens"] = tok((B, S - cfg.n_image_tokens))
            spec["extra"] = {"image_embeds": emb(cfg.n_image_tokens)}
        if cfg.family == "audio":
            spec["extra"] = {"audio_embeds": emb(cfg.encoder_seq)}
        return spec

    # decode: one token with a cache of S
    cache = get_model(cfg).init_cache(B, S, device="meta")
    return {"cache": cache, "token": tok((B,)), "pos": tok((B,))}
