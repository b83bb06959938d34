"""Decoder-only LM: parameter declarations, per-layer windows, MLP, init.

Port of the parts of ``repro/models/lm.py`` that paged serving runs.
Parameters keep the reference layout: ``{"lm": {...}, "blocks": {...}}``
with every ``blocks`` leaf stacked on a leading layer axis, so the tests
hand both packages the same weights (``params_from_numpy``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (ParamDef, act_fn, init_params,
                                       init_stacked)

PyTree = Any


# ---------------------------------------------------------------------------
# parameter declarations
# ---------------------------------------------------------------------------

def attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    defs = {
        "wq": ParamDef((d, cfg.n_heads, hd), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((cfg.n_heads, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        defs.update({
            "bq": ParamDef((cfg.n_heads, hd), ("heads", "head_dim"), "zeros"),
            "bk": ParamDef((cfg.n_kv_heads, hd), ("kv_heads", "head_dim"), "zeros"),
            "bv": ParamDef((cfg.n_kv_heads, hd), ("kv_heads", "head_dim"), "zeros"),
        })
    return defs


def mlp_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamDef((d, ff), ("embed", "mlp")),
        "w_up": ParamDef((d, ff), ("embed", "mlp")),
        "w_down": ParamDef((ff, d), ("mlp", "embed")),
    }


def block_defs(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.family == "moe":
        raise NotImplementedError("repro_torch: MoE blocks are not ported yet")
    defs: Dict[str, Any] = {"ln1": ParamDef((cfg.d_model,), ("embed",), "zeros"),
                            "attn": attn_defs(cfg)}
    if not cfg.parallel_block:
        defs["ln2"] = ParamDef((cfg.d_model,), ("embed",), "zeros")
    if cfg.post_norm:
        defs["pn1"] = ParamDef((cfg.d_model,), ("embed",), "zeros")
        defs["pn2"] = ParamDef((cfg.d_model,), ("embed",), "zeros")
    defs["mlp"] = mlp_defs(cfg)
    return defs


def lm_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    defs = {"embed": ParamDef((cfg.vocab_size, d), ("vocab", "embed")),
            "final_norm": ParamDef((d,), ("embed",), "zeros")}
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, cfg.vocab_size), ("embed", "vocab"))
    if cfg.n_image_tokens:
        defs["mm_proj"] = ParamDef((d, d), ("embed", None))
    return defs


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer sliding window (0 = global attention)."""
    w = np.zeros((cfg.n_layers,), np.int32)
    if cfg.layer_pattern == "local_global" and cfg.local_window:
        w[0::2] = cfg.local_window           # even layers local (gemma2)
    elif cfg.global_every and cfg.local_window:
        w[:] = cfg.local_window              # hymba: local everywhere ...
        w[0::cfg.global_every] = 0           # ... except every k-th global
    return w


# ---------------------------------------------------------------------------
# block pieces
# ---------------------------------------------------------------------------

def _mlp_apply(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    act = act_fn(cfg.act)
    h = act(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def init(gen: torch.Generator, cfg: ModelConfig,
         dtype=torch.float32) -> PyTree:
    """Random weights on ``gen``'s device, drawn in ``dtype``."""
    return {"lm": init_params(gen, lm_defs(cfg), dtype=dtype),
            "blocks": init_stacked(gen, block_defs(cfg), cfg.n_layers,
                                   dtype=dtype)}


def params_from_numpy(tree: PyTree, device, dtype=None) -> PyTree:
    """Nested dict of numpy arrays (e.g. the JAX package's params through
    ``np.asarray``) -> the same nested dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)
