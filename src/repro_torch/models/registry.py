"""Uniform model interface: init / train_loss / init_cache / prefill /
decode_step.

Port of ``repro/models/registry.py`` for the families the port has: dense
and vlm (``models/lm.py``) and ssm (``models/xlstm.py``). The ``moe``
family shares the dense bundle and raises ``NotImplementedError`` where its
blocks are built. The dry-run's ``input_specs`` and the bundle's abstract
params and sharding axes arrive with the launchers (ROADMAP slice F).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm as lm_lib
from repro_torch.models import xlstm as xlstm_lib

PyTree = Any

_NOT_PORTED = {"hybrid": "slice E (hymba)",
               "audio": "slice E (whisper)"}


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
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"repro_torch: the {cfg.family} family ({cfg.name}) is not "
            f"ported yet; it comes with {_NOT_PORTED[cfg.family]}")
    lib = xlstm_lib if cfg.family == "ssm" else lm_lib
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
