"""Hymba: parallel attention + Mamba heads in every block.

Port of ``repro/models/hymba.py``. Both paths read the same normed input;
their normed outputs are averaged. Most attention layers are
sliding-window, one in every ``global_every`` global (``lm.layer_windows``).
The reference scans a per-layer window array, and a traced window keeps
its flash kernel off, so the port's full-sequence forward runs the plain
attention too (``use_pallas`` is turned off, as for gemma2).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import lm as lm_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (ParamDef, init_params, init_stacked,
                                       remat, rms_norm, softmax_xent,
                                       stack_defs)

PyTree = Any


def block_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "ln1": ParamDef((d,), ("embed",), "zeros"),
        "ln2": ParamDef((d,), ("embed",), "zeros"),
        "attn": lm_lib.attn_defs(cfg),
        "mamba": ssm_lib.mamba_defs(cfg),
        "fuse_a": ParamDef((d,), ("embed",), "zeros"),
        "fuse_m": ParamDef((d,), ("embed",), "zeros"),
        "mlp": lm_lib.mlp_defs(cfg),
    }


def full_defs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"lm": lm_lib.lm_defs(cfg),
            "blocks": stack_defs(block_defs(cfg), cfg.n_layers, "layers")}


def init(gen: torch.Generator, cfg: ModelConfig,
         dtype=torch.float32) -> PyTree:
    """Random weights on ``gen``'s device, drawn in ``dtype``."""
    return {"lm": init_params(gen, lm_lib.lm_defs(cfg), dtype=dtype),
            "blocks": init_stacked(gen, block_defs(cfg), cfg.n_layers,
                                   dtype=dtype)}


def apply_block(p, cfg: ModelConfig, run: RunConfig, x, *, window,
                mesh=None, batch_axes=("data",), cache=None, pos=None):
    """cache: dict(k, v, ssm, conv) of one layer, or None. Returns (x,
    new_cache)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    attn_cache = None if cache is None else {"k": cache["k"], "v": cache["v"]}
    a, new_attn = lm_lib._attn_apply(p["attn"], cfg, h, window=window,
                                     cache=attn_cache, pos=pos, run=run,
                                     mesh=mesh, batch_axes=batch_axes)
    mamba_state = None if cache is None else (cache["ssm"], cache["conv"])
    m, new_mamba = ssm_lib.mamba_mix(p["mamba"], cfg, h, mamba_state)
    fused = 0.5 * (rms_norm(a, p["fuse_a"], cfg.norm_eps) +
                   rms_norm(m, p["fuse_m"], cfg.norm_eps))
    x = x + fused
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + lm_lib._mlp_apply(p["mlp"], cfg, h2)
    new_cache = None
    if cache is not None:
        new_cache = {"k": new_attn["k"], "v": new_attn["v"],
                     "ssm": new_mamba[0], "conv": new_mamba[1]}
    return x, new_cache


def forward_train(params, cfg: ModelConfig, run: RunConfig, batch,
                  mesh=None, batch_axes=("data",)):
    """Returns (logits (B, S, V), 0). ``run.remat`` other than "none"
    checkpoints each block with nothing saved: the reference's
    ``jax.checkpoint`` here has no policy, so "dots" runs as "full"."""
    run = run.replace(use_pallas=False)
    x = lm_lib._embed(params, cfg, run, batch)
    win = lm_lib.layer_windows(cfg)
    layers = lm_lib._unbind(params["blocks"], cfg.n_layers)
    mode = "none" if run.remat == "none" else "full"
    for i in range(cfg.n_layers):
        x = remat(lambda p, h, w=int(win[i]): apply_block(
            p, cfg, run, h, window=w, mesh=mesh, batch_axes=batch_axes)[0],
            mode, layers[i], x)
    x = rms_norm(x, params["lm"]["final_norm"], cfg.norm_eps)
    return lm_lib._unembed(params, cfg, x), torch.zeros((), device=x.device)


def train_loss(params, cfg: ModelConfig, run: RunConfig, batch,
               mesh=None, batch_axes=("data",)):
    logits, _ = forward_train(params, cfg, run, batch, mesh, batch_axes)
    return softmax_xent(logits, batch["labels"], batch.get("loss_mask"))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cuda") -> Dict[str, Any]:
    hd = cfg.resolved_head_dim
    di, N, L = ssm_lib.d_inner(cfg), cfg.ssm_state, cfg.n_layers
    z = lambda s, dt: torch.zeros(s, dtype=dt, device=device)
    return {"k": z((L, batch, max_seq, cfg.n_kv_heads, hd), dtype),
            "v": z((L, batch, max_seq, cfg.n_kv_heads, hd), dtype),
            "ssm": z((L, batch, di, N), torch.float32),
            "conv": z((L, batch, cfg.conv_width - 1, di), dtype)}


def _run_layers(params, cfg: ModelConfig, run: RunConfig, x, cache, pos,
                mesh, batch_axes):
    win = lm_lib.layer_windows(cfg)
    new = []
    for i in range(cfg.n_layers):
        x, c = apply_block(lm_lib._layer(params["blocks"], i), cfg, run, x,
                           window=int(win[i]), mesh=mesh,
                           batch_axes=batch_axes,
                           cache=lm_lib._layer(cache, i), pos=pos)
        new.append(c)
    return x, lm_lib._stack_caches(new)


def prefill(params, cfg: ModelConfig, run: RunConfig, cache, tokens,
            mesh=None, batch_axes=("data",), extra=None):
    """Full-prompt pass writing the KV caches and the SSM states. tokens:
    (B, S). Returns (logits (B, V), cache, lengths (B,) int32)."""
    B, S = tokens.shape
    x = lm_lib._embed(params, cfg, run, {"tokens": tokens})
    pos0 = torch.zeros((B,), dtype=torch.int32, device=x.device)
    x, new_cache = _run_layers(params, cfg, run, x, cache, pos0, mesh,
                               batch_axes)
    x = rms_norm(x[:, -1:], params["lm"]["final_norm"], cfg.norm_eps)
    return (lm_lib._unembed(params, cfg, x)[:, 0], new_cache,
            torch.full((B,), S, dtype=torch.int32, device=x.device))


def decode_step(params, cfg: ModelConfig, run: RunConfig, cache, token, pos,
                mesh=None, batch_axes=("data",)):
    """One decode step. token: (B,) int; pos: (B,) int current lengths.
    Returns (logits (B, V), new_cache)."""
    x = lm_lib._embed(params, cfg, run, {"tokens": token[:, None]})
    x, new_cache = _run_layers(params, cfg, run, x, cache, pos, mesh,
                               batch_axes)
    x = rms_norm(x, params["lm"]["final_norm"], cfg.norm_eps)
    return lm_lib._unembed(params, cfg, x)[:, 0], new_cache
