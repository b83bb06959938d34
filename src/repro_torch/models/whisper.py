"""Whisper-style encoder-decoder backbone (the conv mel frontend is a
stub).

Port of ``repro/models/whisper.py``. The input is precomputed frame
embeddings (B, encoder_seq, d), the product of the stubbed conv1d
frontend; positions are sinusoidal. Decoder blocks: causal
self-attention, cross-attention to the encoder output, MLP (tanh-gelu).

Under ``run.use_pallas`` the full-sequence attentions (the encoder's, and
the decoder's self- and cross-attention in ``forward_train``) go through
``lm.attention_with_knobs``, which follows the reference's kernel rule:
the kernel where the query length fits its blocks, and the reference's
refusal where the keys' length does not (1,500 encoder frames against a
decoder length that is a multiple of 64). ``prefill`` and
``decode_step`` use the plain attention, as in the reference. Two caches:
the self-attention's (written at ``pos``) and the cross-attention's K/V
(written once at prefill, carried unchanged).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.common import (ParamDef, attention, embed_lookup,
                                       gqa_attention, init_params, init_stacked, remat,
                                       rms_norm, sinusoidal_positions,
                                       softmax_xent, stack_defs)
from repro_torch.models.lm import (_expand_kv, _layer, _mlp_apply,
                                   _out_proj, _proj, _stack_caches, _unbind,
                                   _write_prefix, attention_with_knobs,
                                   mlp_defs)

PyTree = Any


def _proj_defs(cfg: ModelConfig, n_kv: int) -> Dict[str, ParamDef]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": ParamDef((d, cfg.n_heads, hd), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, n_kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, n_kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((cfg.n_heads, hd, d), ("heads", "head_dim", "embed")),
    }


def enc_block_defs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln1": ParamDef((cfg.d_model,), ("embed",), "zeros"),
            "attn": _proj_defs(cfg, cfg.n_kv_heads),
            "ln2": ParamDef((cfg.d_model,), ("embed",), "zeros"),
            "mlp": mlp_defs(cfg)}


def dec_block_defs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln1": ParamDef((cfg.d_model,), ("embed",), "zeros"),
            "self_attn": _proj_defs(cfg, cfg.n_kv_heads),
            "ln_x": ParamDef((cfg.d_model,), ("embed",), "zeros"),
            "cross_attn": _proj_defs(cfg, cfg.n_kv_heads),
            "ln2": ParamDef((cfg.d_model,), ("embed",), "zeros"),
            "mlp": mlp_defs(cfg)}


def full_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "embed": ParamDef((cfg.vocab_size, d), ("vocab", "embed")),
        "lm_head": ParamDef((d, cfg.vocab_size), ("embed", "vocab")),
        "final_norm": ParamDef((d,), ("embed",), "zeros"),
        "enc_norm": ParamDef((d,), ("embed",), "zeros"),
        "enc": stack_defs(enc_block_defs(cfg), cfg.n_encoder_layers, "layers"),
        "dec": stack_defs(dec_block_defs(cfg), cfg.n_layers, "layers"),
    }


def init(gen: torch.Generator, cfg: ModelConfig,
         dtype=torch.float32) -> PyTree:
    """Random weights on ``gen``'s device, drawn in ``dtype``."""
    top = {k: v for k, v in full_defs(cfg).items() if k not in ("enc", "dec")}
    out = init_params(gen, top, dtype=dtype)
    out["enc"] = init_stacked(gen, enc_block_defs(cfg), cfg.n_encoder_layers,
                              dtype=dtype)
    out["dec"] = init_stacked(gen, dec_block_defs(cfg), cfg.n_layers,
                              dtype=dtype)
    return out


def _with_positions(x: torch.Tensor, d: int) -> torch.Tensor:
    return x + sinusoidal_positions(x.shape[1], d, x.device).to(x.dtype)[None]


def _embed(params, run: RunConfig, tokens: torch.Tensor) -> torch.Tensor:
    return embed_lookup(tokens, params["embed"]).to(
        getattr(torch, run.compute_dtype))


def encode(params, cfg: ModelConfig, run: RunConfig, audio_embeds,
           mesh=None, batch_axes=("data",)):
    """audio_embeds: (B, S_enc, d) from the stub frontend."""
    x = _with_positions(audio_embeds.to(getattr(torch, run.compute_dtype)),
                        cfg.d_model)
    for i in range(cfg.n_encoder_layers):
        p = _layer(params["enc"], i)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = (_proj(h, p["attn"][w]) for w in ("wq", "wk", "wv"))
        a = attention_with_knobs(q, _expand_kv(k, cfg.n_heads),
                                 _expand_kv(v, cfg.n_heads), causal=False,
                                 run=run, mesh=mesh, batch_axes=batch_axes)
        x = x + _out_proj(p["attn"], a)
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + _mlp_apply(p["mlp"], cfg, h)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_block(p, cfg: ModelConfig, run: RunConfig, x, enc_out=None,
               cache=None, pos=None, mesh=None, batch_axes=("data",)):
    """Decoder block; cache: dict(k, v, ck, cv) of one layer (the cross K/V
    precomputed) or None. Returns (x, new_cache)."""
    B, S, _ = x.shape
    nh = cfg.n_heads
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    sa = p["self_attn"]
    q, kh, vh = (_proj(h, sa[w]) for w in ("wq", "wk", "wv"))
    if cache is None:
        a = attention_with_knobs(q, _expand_kv(kh, nh), _expand_kv(vh, nh),
                                 causal=True, run=run, mesh=mesh,
                                 batch_axes=batch_axes)
        new_cache = None
    else:
        pos = pos.long()
        write = (torch.arange(cache["k"].shape[1], device=x.device)
                 [None, :, None, None] == pos[:, None, None, None])
        ck = torch.where(write, kh[:, :1].to(cache["k"].dtype), cache["k"])
        cv = torch.where(write, vh[:, :1].to(cache["v"].dtype), cache["v"])
        a = gqa_attention(q, _expand_kv(ck.to(h.dtype), nh),
                          _expand_kv(cv.to(h.dtype), nh), causal=True,
                          q_offset=pos, kv_len=pos + S)
        new_cache = {"k": ck, "v": cv}
    x = x + _out_proj(sa, a)
    # cross attention
    h = rms_norm(x, p["ln_x"], cfg.norm_eps)
    xa = p["cross_attn"]
    qx = _proj(h, xa["wq"])
    if cache is None:
        kx, vx = _proj(enc_out, xa["wk"]), _proj(enc_out, xa["wv"])
        ax = attention_with_knobs(qx, _expand_kv(kx, nh), _expand_kv(vx, nh),
                                  causal=False, run=run, mesh=mesh,
                                  batch_axes=batch_axes)
    else:
        kx, vx = cache["ck"].to(h.dtype), cache["cv"].to(h.dtype)
        new_cache.update({"ck": cache["ck"], "cv": cache["cv"]})
        ax = attention(qx, _expand_kv(kx, nh), _expand_kv(vx, nh),
                       causal=False)
    x = x + _out_proj(xa, ax)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _mlp_apply(p["mlp"], cfg, h), new_cache


def forward_train(params, cfg: ModelConfig, run: RunConfig, batch,
                  mesh=None, batch_axes=("data",)):
    """batch: audio_embeds (B, S_enc, d), tokens (B, S_dec), labels.
    Returns (logits (B, S_dec, V), 0). ``run.remat`` other than "none"
    checkpoints each decoder block with nothing saved (the reference's
    ``jax.checkpoint`` here has no policy)."""
    enc_out = encode(params, cfg, run, batch["audio_embeds"], mesh,
                     batch_axes)
    x = _with_positions(_embed(params, run, batch["tokens"]), cfg.d_model)
    layers = _unbind(params["dec"], cfg.n_layers)
    mode = "none" if run.remat == "none" else "full"
    for i in range(cfg.n_layers):
        x = remat(lambda p, h, e: _dec_block(p, cfg, run, h, enc_out=e,
                                             mesh=mesh,
                                             batch_axes=batch_axes)[0],
                  mode, layers[i], x, enc_out)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"].to(x.dtype), torch.zeros((), device=x.device)


def train_loss(params, cfg: ModelConfig, run: RunConfig, batch,
               mesh=None, batch_axes=("data",)):
    logits, _ = forward_train(params, cfg, run, batch, mesh, batch_axes)
    return softmax_xent(logits, batch["labels"], batch.get("loss_mask"))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cuda") -> Dict[str, Any]:
    hd, L = cfg.resolved_head_dim, cfg.n_layers
    z = lambda s: torch.zeros(s, dtype=dtype, device=device)
    return {"k": z((L, batch, max_seq, cfg.n_kv_heads, hd)),
            "v": z((L, batch, max_seq, cfg.n_kv_heads, hd)),
            "ck": z((L, batch, cfg.encoder_seq, cfg.n_kv_heads, hd)),
            "cv": z((L, batch, cfg.encoder_seq, cfg.n_kv_heads, hd))}


def prefill(params, cfg: ModelConfig, run: RunConfig, cache, tokens,
            mesh=None, batch_axes=("data",), extra=None):
    """Encode the audio and run the decoder prompt, writing the self- and
    cross-attention K/V. extra: {"audio_embeds": (B, S_enc, d)}. Returns
    (logits (B, V), cache, lengths (B,) int32)."""
    B, S = tokens.shape
    nh = cfg.n_heads
    enc_out = encode(params, cfg, run, extra["audio_embeds"], mesh,
                     batch_axes)
    x = _with_positions(_embed(params, run, tokens), cfg.d_model)
    new = []
    for i in range(cfg.n_layers):
        p, c = _layer(params["dec"], i), _layer(cache, i)
        kx = _proj(enc_out, p["cross_attn"]["wk"])
        vx = _proj(enc_out, p["cross_attn"]["wv"])
        ckx, cvx = kx.to(c["ck"].dtype), vx.to(c["cv"].dtype)
        # self-attention over the whole prompt, K/V written at [0, S)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        sa = p["self_attn"]
        q, kh, vh = (_proj(h, sa[w]) for w in ("wq", "wk", "wv"))
        a = attention(q, _expand_kv(kh, nh), _expand_kv(vh, nh), causal=True)
        x2 = x + _out_proj(sa, a)
        h2 = rms_norm(x2, p["ln_x"], cfg.norm_eps)
        qx = _proj(h2, p["cross_attn"]["wq"])
        ax = attention(qx, _expand_kv(kx, nh), _expand_kv(vx, nh),
                       causal=False)
        x2 = x2 + _out_proj(p["cross_attn"], ax)
        h3 = rms_norm(x2, p["ln2"], cfg.norm_eps)
        x = x2 + _mlp_apply(p["mlp"], cfg, h3)
        new.append({"k": _write_prefix(c["k"], kh),
                    "v": _write_prefix(c["v"], vh), "ck": ckx, "cv": cvx})
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = x @ params["lm_head"].to(x.dtype)
    return (logits[:, 0], _stack_caches(new),
            torch.full((B,), S, dtype=torch.int32, device=x.device))


def decode_step(params, cfg: ModelConfig, run: RunConfig, cache, token, pos,
                mesh=None, batch_axes=("data",)):
    """One decode step. token: (B,) int; pos: (B,) int current lengths. The
    position's sinusoid comes from a table of the self-attention cache's
    length, as in the reference. Returns (logits (B, V), new_cache)."""
    x = _embed(params, run, token[:, None])
    table = sinusoidal_positions(cache["k"].shape[2], cfg.d_model, x.device)
    # the positions (B,) as one plain vector: DTensor cannot index a table
    # by a vector sharded over two mesh axes
    idx = pos.full_tensor() if isinstance(pos, DTensor) else pos
    x = x + table[idx.long()][:, None].to(x.dtype)
    new = []
    for i in range(cfg.n_layers):
        x, c = _dec_block(_layer(params["dec"], i), cfg, run, x,
                          cache=_layer(cache, i), pos=pos, mesh=mesh,
                          batch_axes=batch_axes)
        new.append(c)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"].to(x.dtype))[:, 0], _stack_caches(new)
