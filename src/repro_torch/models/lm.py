"""Generic decoder-only LM stack: the dense, MoE and VLM families.

Port of ``repro/models/lm.py``. Parameters keep the reference layout:
``{"lm": {...}, "blocks": {...}}`` with every ``blocks`` leaf stacked on a
leading layer axis, so the tests hand both packages the same weights
(``params_from_numpy``). The reference's ``lax.scan`` over layers is a
plain Python loop; a per-layer window is a Python int.

Under ``run.use_pallas`` the full-sequence passes (``forward_train``,
``train_loss`` and ``prefill``) run attention through the flash-attention
kernel (``kernels/flash_attention``: CUDA on the card, its plain version on
the CPU); the reference's ``prefill`` keeps the plain attention, and on the
CPU the two agree to the f32 bar. ``decode_step`` uses the plain
attention. A MoE block (``models/moe.py``) replaces the MLP; its aux loss
is summed over the layers and ``train_loss`` adds ``0.01 *`` the sum.

With a ``mesh`` the params, batch and cache are DTensors (placed by
``distributed/sharding.py``, the caller in ``implicit_replication``) and
the plain ops run under DTensor's sharding rules, GSPMD's counterpart; the
ops it cannot shard run in local regions (``distributed/regions.py``), and
the MoE layer in its expert-parallel region. The reference's three mesh
knobs act: ``attn_pad_heads`` pads q heads to a multiple of ``model`` and
shards them, ``attn_batch_reshard`` spreads the batch over (batch axes,
``model``) around attention, ``decode_cache_anchor`` lays the updated
cache out as ``cache_shardings`` does.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.distributed import regions
from repro_torch.distributed import sharding as shlib
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (ParamDef, act_fn, apply_rope,
                                       attention, embed_lookup,
                                       gqa_attention, init_params,
                                       init_stacked, remat, rms_norm,
                                       softcap, softmax_xent, stack_defs)
# re-exported: the tests and older callers take it from here
from repro_torch.models.common import params_from_numpy  # noqa: F401

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
    defs: Dict[str, Any] = {"ln1": ParamDef((cfg.d_model,), ("embed",), "zeros"),
                            "attn": attn_defs(cfg)}
    if not cfg.parallel_block:
        defs["ln2"] = ParamDef((cfg.d_model,), ("embed",), "zeros")
    if cfg.post_norm:
        defs["pn1"] = ParamDef((cfg.d_model,), ("embed",), "zeros")
        defs["pn2"] = ParamDef((cfg.d_model,), ("embed",), "zeros")
    if cfg.family == "moe":
        defs["moe"] = moe_lib.moe_defs(cfg)
    else:
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
    plain path does (each head ``g`` times in a row: a broadcast and a
    reshape, which DTensor shards); the kernel keeps the grouped form."""
    B, S, Hkv, D = k.shape
    g = n_heads // Hkv
    if g == 1:
        return k
    return k[:, :, :, None].expand(B, S, Hkv, g, D).reshape(B, S, Hkv * g, D)


def _pallas_ok(run: Optional[RunConfig], q: torch.Tensor) -> bool:
    """Use the flash kernel when enabled and the sequence fits its blocks:
    the reference's TPU rule. (Its ``B * S <= 4096`` clause exists for
    interpret mode; on the CPU the kernel's wrapper takes the plain version
    anyway.)"""
    if run is None or not run.use_pallas:
        return False
    S = q.shape[1]
    return not (S % 128 and S % 64)


def _check_blocks(Sq: int, Sk: int) -> None:
    """The reference's kernel asserts that its blocks (128 where Sq allows,
    else 64, each at most its length) divide both lengths; ``_pallas_ok``
    looks at Sq only, so a cross-attention over keys of another length
    (Whisper's 1,500 frames) fails there. The port raises the same error
    before anything launches."""
    block = 128 if Sq % 128 == 0 else 64
    block_q, block_k = min(block, Sq), min(block, Sk)
    if Sq % block_q or Sk % block_k:
        raise AssertionError(f"seq ({Sq},{Sk}) must divide blocks "
                             f"({block_q},{block_k})")


def attention_with_knobs(q, ke, ve, *, causal=True, window=0,
                         attn_softcap=0.0, run: Optional[RunConfig] = None,
                         mesh=None, batch_axes=("data",),
                         pre_resharded: bool = False,
                         flash: Callable = flash_attention):
    """Full-sequence attention; q (B, S, Hq, d), ke/ve expanded to Hq.

    With ``run.use_pallas`` the flash kernel replaces the plain path; its
    (B, H, S, d) operands are transposed views. ``flash`` is there so a
    check can wrap the kernel call. With a mesh (DTensor operands) the
    kernel runs on local shards, heads over ``model`` where they divide,
    and two strategies serve archs whose heads do not divide TP:
      * ``attn_pad_heads``: pad heads to a TP multiple -> shard over
        ``model``, no reshard collectives, pad/Hq wasted flops;
      * ``attn_batch_reshard`` (``pre_resharded``): the caller spread the
        batch over (batch_axes + model); attention is pure data parallel;
        reshard back after.
    """
    use_kernel = _pallas_ok(run, q)
    if use_kernel:
        _check_blocks(q.shape[1], ke.shape[1])

    def fn(q, k, v):
        if use_kernel:
            return flash(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal, window=int(window),
                         softcap=attn_softcap).transpose(1, 2)
        return attention(q, k, v, causal=causal, window=window,
                         attn_softcap=attn_softcap)

    if not isinstance(q, DTensor):
        return fn(q, ke, ve)
    if pre_resharded:
        out = regions.attention(q, ke, ve, fn, heads_over_model=False,
                                batch=tuple(batch_axes) + ("model",))
        back = shlib.placements((tuple(batch_axes), None, None, None), mesh)
        return out.redistribute(mesh, back)
    pad_heads = run is not None and run.attn_pad_heads and \
        "model" in mesh.mesh_dim_names
    H, tp = q.shape[2], shlib.mesh_axis_size(mesh, "model")
    pad_to = -(-H // tp) * tp if pad_heads and H % tp else None
    return regions.attention(q, ke, ve, fn, batch=batch_axes,
                             heads_over_model=pad_heads or H % tp == 0,
                             pad_to=pad_to)


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
    return shlib.batch_only(out.reshape(*out.shape[:2], H * k) @
                            p["wo"].to(out.dtype).reshape(H * k, d))


def _write_prefix(cache_t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A copy of cache_t (B, Smax, ...) with positions [0, S) set to x."""
    if isinstance(cache_t, DTensor):
        return regions.write_prefix(cache_t, x)
    out = cache_t.clone()
    out[:, :x.shape[1]] = x.to(out.dtype)
    return out


def _attn_apply(p, cfg: ModelConfig, x, *, window, cache=None, pos=None,
                run: Optional[RunConfig] = None, mesh=None,
                batch_axes=("data",), flash: Callable = flash_attention):
    """x: (B, S, d). cache: dict(k, v) of (B, Smax, Hkv, hd) or None.

    Returns (out (B, S, d), new_cache).
    """
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x)
    dev = x.device
    # mesh knob: when heads don't divide TP (attention would replicate over
    # `model`), spread the *batch* over (batch_axes + model) just for the
    # attention op: pure data-parallel attention, two reshards per layer
    reshard = (run is not None and run.attn_batch_reshard
               and isinstance(x, DTensor) and cache is None)
    if reshard:
        spread = shlib.placements(
            (tuple(batch_axes) + ("model",), None, None, None), mesh)
        q, k, v = (t.redistribute(mesh, spread) for t in (q, k, v))
    if cache is None:
        # train / prefill from scratch: positions 0..S
        positions = torch.arange(S, device=dev)[None]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        out = attention_with_knobs(
            q, _expand_kv(k, cfg.n_heads), _expand_kv(v, cfg.n_heads),
            causal=True, window=window, attn_softcap=cfg.attn_softcap,
            run=run, mesh=mesh, batch_axes=batch_axes,
            pre_resharded=reshard, flash=flash)
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
        if run is not None and run.decode_cache_anchor and \
                isinstance(ck, DTensor):
            # mesh knob: anchor the updated cache to its own layout, so the
            # (tiny) broadcast operand is resharded, never the whole
            # sequence-sharded cache
            sh = shlib.cache_shardings(
                cfg, mesh, ShapeConfig("t", "decode", cache["k"].shape[1], B))
            inner = shlib.drop_leading(sh["k"])
            ck, cv = ck.redistribute(mesh, inner), cv.redistribute(mesh, inner)
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
    return shlib.batch_only(h @ p["w_down"].to(x.dtype))


def _ffn(p, cfg: ModelConfig, run: RunConfig, h: torch.Tensor, mesh=None,
         batch_axes=("data",)):
    """The block's MLP, or its MoE layer. Returns (out, aux loss)."""
    if cfg.family == "moe":
        return moe_lib.moe_apply(h, p["moe"], cfg, run, mesh, batch_axes)
    return _mlp_apply(p["mlp"], cfg, h), torch.zeros((), device=h.device)


def apply_block(p, cfg: ModelConfig, run: RunConfig, x, *, window,
                mesh=None, batch_axes=("data",), cache=None, pos=None,
                flash: Callable = flash_attention):
    """One transformer block. Returns (x, new_cache, aux loss)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, new_cache = _attn_apply(p["attn"], cfg, h, window=window, cache=cache,
                               pos=pos, run=run, mesh=mesh,
                               batch_axes=batch_axes, flash=flash)
    if cfg.parallel_block:
        m, aux = _ffn(p, cfg, run, h, mesh, batch_axes)
        return x + a + m, new_cache, aux
    if cfg.post_norm:
        a = rms_norm(a, p["pn1"], cfg.norm_eps)
    x = x + a
    m, aux = _ffn(p, cfg, run, rms_norm(x, p["ln2"], cfg.norm_eps), mesh,
                  batch_axes)
    if cfg.post_norm:
        m = rms_norm(m, p["pn2"], cfg.norm_eps)
    return x + m, new_cache, aux


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


def _unbind(tree: PyTree, n: int) -> list:
    """The ``n`` layers of a tree stacked on a leading layer axis."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def init(gen: torch.Generator, cfg: ModelConfig,
         dtype=torch.float32) -> PyTree:
    """Random weights on ``gen``'s device, drawn in ``dtype``."""
    return {"lm": init_params(gen, lm_defs(cfg), dtype=dtype),
            "blocks": init_stacked(gen, block_defs(cfg), cfg.n_layers,
                                   dtype=dtype)}


def _embed(params, cfg: ModelConfig, run: RunConfig, batch) -> torch.Tensor:
    dt = getattr(torch, run.compute_dtype)
    emb = params["lm"]["embed"]
    x = embed_lookup(batch["tokens"], emb).to(dt)
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


def forward_train(params, cfg: ModelConfig, run: RunConfig, batch,
                  mesh=None, batch_axes=("data",), *,
                  flash: Callable = flash_attention
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. batch: tokens (B, S) [, image_embeds].

    Returns (logits (B, S, V), aux loss): the sum of the MoE layers' aux
    losses (0 for the dense families). Under ``run.use_pallas`` a call
    that needs a gradient raises (``kernels.refuse_grad``): the kernel has
    no backward, as the reference kernel has none, so a training step
    takes use_pallas=False.
    ``run.remat`` checkpoints each block (``common.remat``), as the
    reference's ``jax.checkpoint`` over its layer scan does.
    """
    x = _embed(params, cfg, run, batch)
    win = layer_windows(cfg)
    if not (win == 0).all():
        # The reference scans a per-layer window array over mixed
        # local/global layers; a traced window keeps its flash kernel off,
        # so gemma2 runs the plain attention. So does the port.
        run = run.replace(use_pallas=False)
    # one unbind per stacked leaf: its backward stacks the layers' grads once
    layers = _unbind(params["blocks"], cfg.n_layers)
    auxs = []
    for i in range(cfg.n_layers):
        x, aux = remat(lambda p, h, w=int(win[i]): apply_block(
            p, cfg, run, h, window=w, mesh=mesh, batch_axes=batch_axes,
            flash=flash)[::2], run.remat, layers[i], x)
        auxs.append(aux)
    x = rms_norm(x, params["lm"]["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x), torch.stack(auxs).sum()


def train_loss(params, cfg: ModelConfig, run: RunConfig, batch,
               mesh=None, batch_axes=("data",), *,
               flash: Callable = flash_attention) -> torch.Tensor:
    """Mean next-token cross-entropy (+ z-loss) of ``forward_train``'s
    logits against ``batch["labels"]`` (optional ``loss_mask``)."""
    logits, aux = forward_train(params, cfg, run, batch, mesh, batch_axes,
                                flash=flash)
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
    """Per-layer cache dicts -> one dict of layer-stacked tensors."""
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def decode_step(params, cfg: ModelConfig, run: RunConfig, cache, token, pos,
                mesh=None, batch_axes=("data",)):
    """One decode step. token: (B,) int; pos: (B,) int current lengths.

    Returns (logits (B, V), new_cache); ``cache`` is left as it was.
    """
    x = _embed(params, cfg, run, {"tokens": token[:, None]})
    win = layer_windows(cfg)
    new = []
    for i in range(cfg.n_layers):
        x, c, _ = apply_block(_layer(params["blocks"], i), cfg, run, x,
                              window=int(win[i]), mesh=mesh,
                              batch_axes=batch_axes, cache=_layer(cache, i),
                              pos=pos)
        new.append(c)
    x = rms_norm(x, params["lm"]["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x)[:, 0], _stack_caches(new)


def prefill(params, cfg: ModelConfig, run: RunConfig, cache, tokens,
            mesh=None, batch_axes=("data",), extra=None):
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
        x, c = _prefill_block(_layer(params["blocks"], i), cfg, run, x,
                              0 if homogeneous else int(win[i]),
                              _layer(cache, i), mesh, batch_axes)
        new.append(c)
    emb_len = x.shape[1]
    x = rms_norm(x, params["lm"]["final_norm"], cfg.norm_eps)
    logits = _unembed(params, cfg, x[:, -1:])
    return (logits[:, 0], _stack_caches(new),
            torch.full((B,), emb_len, dtype=torch.int32, device=x.device))


def _prefill_block(p, cfg: ModelConfig, run: RunConfig, x, window,
                   cache_l, mesh=None, batch_axes=("data",)):
    """Block application that also writes the full-sequence K/V into the
    cache; under ``run.use_pallas`` the attention is the flash kernel's
    (the reference's is always the plain one)."""
    S = x.shape[1]
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(p["attn"], cfg, h)
    positions = torch.arange(S, device=x.device)[None]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = attention_with_knobs(
        q, _expand_kv(k, cfg.n_heads), _expand_kv(v, cfg.n_heads),
        causal=True, window=window, attn_softcap=cfg.attn_softcap, run=run,
        mesh=mesh, batch_axes=batch_axes)
    new_cache = {"k": _write_prefix(cache_l["k"], k),
                 "v": _write_prefix(cache_l["v"], v)}
    a = _out_proj(p["attn"], out)
    if cfg.post_norm:
        a = rms_norm(a, p["pn1"], cfg.norm_eps)
    if cfg.parallel_block:
        return x + a + _ffn(p, cfg, run, h, mesh, batch_axes)[0], new_cache
    x = x + a
    m, _ = _ffn(p, cfg, run, rms_norm(x, p["ln2"], cfg.norm_eps), mesh,
                batch_axes)
    if cfg.post_norm:
        m = rms_norm(m, p["pn2"], cfg.norm_eps)
    return x + m, new_cache
