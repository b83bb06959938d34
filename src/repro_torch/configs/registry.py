"""--arch <id> registry for the ten assigned architectures."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

ARCH_IDS = (
    "xlstm-125m",
    "command-r-plus-104b",
    "gemma2-2b",
    "qwen1.5-4b",
    "qwen1.5-110b",
    "llama4-scout-17b-a16e",
    "moonshot-v1-16b-a3b",
    "hymba-1.5b",
    "llava-next-mistral-7b",
    "whisper-large-v3",
)

_MODULE = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULE:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_MODULE)}")
    return importlib.import_module(_MODULE[arch]).CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
