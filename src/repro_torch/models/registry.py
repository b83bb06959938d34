"""Uniform model interface: init / train_loss / init_cache / prefill /
decode_step.

Port of ``repro/models/registry.py``: dense, moe and vlm
(``models/lm.py``), ssm (``models/xlstm.py``), hybrid (``models/hymba.py``)
and audio (``models/whisper.py``). The dry-run's ``input_specs`` and the
bundle's abstract params and sharding axes arrive with the launchers
(ROADMAP slice F).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hymba as hymba_lib
from repro_torch.models import lm as lm_lib
from repro_torch.models import whisper as whisper_lib
from repro_torch.models import xlstm as xlstm_lib

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
        decode_step=lambda p, run, cache, token, pos:
            lib.decode_step(p, cfg, run, cache, token, pos),
    )
