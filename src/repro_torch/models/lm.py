"""Generic decoder-only LM stack: the dense and VLM families.

Port of ``repro/models/lm.py``. Parameters keep the reference layout:
``{"lm": {...}, "blocks": {...}}`` with every ``blocks`` leaf stacked on a
leading layer axis, so the tests hand both packages the same weights
(``params_from_numpy``). The reference's ``lax.scan`` over layers is a
plain Python loop; a per-layer window is a Python int.

Under ``run.use_pallas`` the full-sequence forward (``forward_train``,
``train_loss``) runs attention through the flash-attention kernel
(``kernels/flash_attention``: CUDA on the card, its plain version on the
CPU). ``prefill`` and ``decode_step`` use the plain attention, as in the
reference. The MoE family is not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import (ParamDef, act_fn, apply_rope,
                                       attention, gqa_attention, init_params,
                                       init_stacked, rms_norm, softcap,
                                       softmax_xent, stack_defs)

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

def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Repeat kv heads (axis 2) to the q-head count, as the reference's
    plain path does; the kernel keeps the grouped form."""
    g = n_heads // k.shape[2]
    return torch.repeat_interleave(k, g, dim=2) if g > 1 else k


def _pallas_ok(run: Optional[RunConfig], q: torch.Tensor) -> bool:
    """Use the flash kernel when enabled and the sequence fits its blocks:
    the reference's TPU rule. (Its ``B * S <= 4096`` clause exists for
    interpret mode; on the CPU the kernel's wrapper takes the plain version
    anyway.)"""
    if run is None or not run.use_pallas:
        return False
    S = q.shape[1]
    return not (S % 128 and S % 64)


def attention_with_knobs(q, ke, ve, *, causal=True, window=0,
                         attn_softcap=0.0, run: Optional[RunConfig] = None,
                         flash: Callable = flash_attention):
    """Full-sequence attention; q (B, S, Hq, d), ke/ve expanded to Hq.

    With ``run.use_pallas`` the flash kernel replaces the plain path; its
    (B, H, S, d) operands are transposed views. ``flash`` is there so a
    check can wrap the kernel call. The reference's mesh knobs
    (``attn_pad_heads``, ``attn_batch_reshard``) act only with a mesh, so
    they are no-ops here as there.
    """
    if _pallas_ok(run, q):
        out = flash(q.transpose(1, 2), ke.transpose(1, 2), ve.transpose(1, 2),
                    causal=causal, window=int(window), softcap=attn_softcap)
        return out.transpose(1, 2)
    return attention(q, ke, ve, causal=causal, window=window,
                     attn_softcap=attn_softcap)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) @ w (d, H, k) -> (B, S, H, k)."""
    d, H, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, H * k)).reshape(*x.shape[:2], H, k)


def _qkv(p, cfg: ModelConfig, x: torch.Tensor):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return q, k, v


def _out_proj(p, out: torch.Tensor) -> torch.Tensor:
    """out (B, S, H, k) @ wo (H, k, d) -> (B, S, d)."""
    H, k, d = p["wo"].shape
    return out.reshape(*out.shape[:2], H * k) @ \
        p["wo"].to(out.dtype).reshape(H * k, d)


def _write_prefix(cache_t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A copy of cache_t (B, Smax, ...) with positions [0, S) set to x."""
    out = cache_t.clone()
    out[:, :x.shape[1]] = x.to(out.dtype)
    return out


def _attn_apply(p, cfg: ModelConfig, x, *, window, cache=None, pos=None,
                run: Optional[RunConfig] = None,
                flash: Callable = flash_attention):
    """x: (B, S, d). cache: dict(k, v) of (B, Smax, Hkv, hd) or None.

    Returns (out (B, S, d), new_cache).
    """
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x)
    dev = x.device
    if cache is None:
        # train / prefill from scratch: positions 0..S
        positions = torch.arange(S, device=dev)[None]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        out = attention_with_knobs(
            q, _expand_kv(k, cfg.n_heads), _expand_kv(v, cfg.n_heads),
            causal=True, window=window,
            attn_softcap=cfg.attn_softcap, run=run, flash=flash)
        new_cache = None
    elif S > 1:
        # prefill: full-sequence attention, K/V written to positions [0, S)
        positions = torch.arange(S, device=dev)[None]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        out = attention(q, _expand_kv(k, cfg.n_heads),
                        _expand_kv(v, cfg.n_heads), causal=True,
                        window=window, attn_softcap=cfg.attn_softcap)
        new_cache = {"k": _write_prefix(cache["k"], k),
                     "v": _write_prefix(cache["v"], v)}
    else:
        # decode: S == 1, written at each sequence's position `pos` by a
        # compare-select, as the reference does
        pos = pos.long()
        positions = pos[:, None] + torch.arange(S, device=dev)[None]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        write = (torch.arange(cache["k"].shape[1], device=dev)
                 [None, :, None, None] == pos[:, None, None, None])
        ck = torch.where(write, k[:, :1].to(cache["k"].dtype), cache["k"])
        cv = torch.where(write, v[:, :1].to(cache["v"].dtype), cache["v"])
        # decode_slim_mask: for S == 1 the kv_len mask is the causal mask
        causal = not (run is not None and run.decode_slim_mask and S == 1)
        if run is not None and run.decode_grouped:
            # grouped-query form: no expansion of the cache
            kk, vv = ck.to(x.dtype), cv.to(x.dtype)
        else:
            kk = _expand_kv(ck.to(x.dtype), cfg.n_heads)
            vv = _expand_kv(cv.to(x.dtype), cfg.n_heads)
        out = gqa_attention(q, kk, vv, causal=causal, q_offset=pos,
                            window=window, attn_softcap=cfg.attn_softcap,
                            kv_len=pos + S)
        new_cache = {"k": ck, "v": cv}
    return _out_proj(p, out), new_cache


def _mlp_apply(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    act = act_fn(cfg.act)
    h = act(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(x.dtype)


def apply_block(p, cfg: ModelConfig, run: RunConfig, x, *, window,
                cache=None, pos=None, flash: Callable = flash_attention):
    """One transformer block. Returns (x, new_cache)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, new_cache = _attn_apply(p["attn"], cfg, h, window=window, cache=cache,
                               pos=pos, run=run, flash=flash)
    if cfg.parallel_block:
        return x + a + _mlp_apply(p["mlp"], cfg, h), new_cache
    if cfg.post_norm:
        a = rms_norm(a, p["pn1"], cfg.norm_eps)
    x = x + a
    m = _mlp_apply(p["mlp"], cfg, rms_norm(x, p["ln2"], cfg.norm_eps))
    if cfg.post_norm:
        m = rms_norm(m, p["pn2"], cfg.norm_eps)
    return x + m, new_cache


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def full_defs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"lm": lm_defs(cfg),
            "blocks": stack_defs(block_defs(cfg), cfg.n_layers, "layers")}


def _layer(tree: PyTree, i: int) -> PyTree:
    """Layer ``i`` of a tree stacked on a leading layer axis."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


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


def _embed(params, cfg: ModelConfig, run: RunConfig, batch) -> torch.Tensor:
    dt = getattr(torch, run.compute_dtype)
    emb = params["lm"]["embed"]
    x = emb[batch["tokens"].long()].to(dt)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    if cfg.n_image_tokens and "image_embeds" in batch:
        img = batch["image_embeds"].to(dt) @ params["lm"]["mm_proj"].to(dt)
        x = torch.cat([img, x], dim=1)
    return x


def _unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ params["lm"]["embed"].to(x.dtype).T
    else:
        logits = x @ params["lm"]["lm_head"].to(x.dtype)
    return softcap(logits, cfg.logit_softcap)


def forward_train(params, cfg: ModelConfig, run: RunConfig, batch, *,
                  flash: Callable = flash_attention
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. batch: tokens (B, S) [, image_embeds].

    Returns (logits (B, S, V), aux loss). The aux loss is MoE's; the dense
    families give 0. Run it under ``torch.no_grad()``: the kernel has no
    backward, as the reference kernel has none.
    """
    x = _embed(params, cfg, run, batch)
    win = layer_windows(cfg)
    if not (win == 0).all():
        # The reference scans a per-layer window array over mixed
        # local/global layers; a traced window keeps its flash kernel off,
        # so gemma2 runs the plain attention. So does the port.
        run = run.replace(use_pallas=False)
    for i in range(cfg.n_layers):
        x, _ = apply_block(_layer(params["blocks"], i), cfg, run, x,
                           window=int(win[i]), flash=flash)
    x = rms_norm(x, params["lm"]["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x), torch.zeros((), device=x.device)


def train_loss(params, cfg: ModelConfig, run: RunConfig, batch, *,
               flash: Callable = flash_attention) -> torch.Tensor:
    """Mean next-token cross-entropy (+ z-loss) of ``forward_train``'s
    logits against ``batch["labels"]`` (optional ``loss_mask``)."""
    logits, aux = forward_train(params, cfg, run, batch, flash=flash)
    if cfg.n_image_tokens and "image_embeds" in batch:
        logits = logits[:, cfg.n_image_tokens:]
    return softmax_xent(logits, batch["labels"], batch.get("loss_mask")) \
        + 0.01 * aux


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cuda") -> PyTree:
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _stack_caches(caches) -> PyTree:
    return {k: torch.stack([c[k] for c in caches]) for k in ("k", "v")}


def decode_step(params, cfg: ModelConfig, run: RunConfig, cache, token, pos):
    """One decode step. token: (B,) int; pos: (B,) int current lengths.

    Returns (logits (B, V), new_cache); ``cache`` is left as it was.
    """
    x = _embed(params, cfg, run, {"tokens": token[:, None]})
    win = layer_windows(cfg)
    new = []
    for i in range(cfg.n_layers):
        x, c = apply_block(_layer(params["blocks"], i), cfg, run, x,
                           window=int(win[i]), cache=_layer(cache, i),
                           pos=pos)
        new.append(c)
    x = rms_norm(x, params["lm"]["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x)[:, 0], _stack_caches(new)


def prefill(params, cfg: ModelConfig, run: RunConfig, cache, tokens,
            extra=None):
    """Fill cache positions [0, S) and return last-position logits.

    tokens: (B, S). Returns (logits (B, V), cache, lengths (B,) int32);
    the cache length is the embedded length (vlm: image tokens first).
    """
    B = tokens.shape[0]
    batch = {"tokens": tokens, **(extra or {})}
    x = _embed(params, cfg, run, batch)
    win = layer_windows(cfg)
    homogeneous = bool((win == 0).all())
    new = []
    for i in range(cfg.n_layers):
        x, c = _prefill_block(_layer(params["blocks"], i), cfg, x,
                              0 if homogeneous else int(win[i]),
                              _layer(cache, i))
        new.append(c)
    emb_len = x.shape[1]
    x = rms_norm(x, params["lm"]["final_norm"], cfg.norm_eps)
    logits = _unembed(params, cfg, x[:, -1:])
    return (logits[:, 0], _stack_caches(new),
            torch.full((B,), emb_len, dtype=torch.int32, device=x.device))


def _prefill_block(p, cfg: ModelConfig, x, window, cache_l):
    """Block application that also writes the full-sequence K/V into the
    cache; the attention is the plain one, as in the reference."""
    S = x.shape[1]
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(p["attn"], cfg, h)
    positions = torch.arange(S, device=x.device)[None]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = attention(q, _expand_kv(k, cfg.n_heads), _expand_kv(v, cfg.n_heads),
                    causal=True, window=window, attn_softcap=cfg.attn_softcap)
    new_cache = {"k": _write_prefix(cache_l["k"], k),
                 "v": _write_prefix(cache_l["v"], v)}
    a = _out_proj(p["attn"], out)
    if cfg.post_norm:
        a = rms_norm(a, p["pn1"], cfg.norm_eps)
    if cfg.parallel_block:
        return x + a + _mlp_apply(p["mlp"], cfg, h), new_cache
    x = x + a
    m = _mlp_apply(p["mlp"], cfg, rms_norm(x, p["ln2"], cfg.norm_eps))
    if cfg.post_norm:
        m = rms_norm(m, p["pn2"], cfg.norm_eps)
    return x + m, new_cache
