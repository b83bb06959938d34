"""Dense GQA LM running over a paged KV pool with the paged-attention kernel.

Port of ``repro/serving/paged_lm.py``: the real-model backend of the serving
engine. Decode reads and writes the (L, P, Hkv, page, d) page pools through
page tables; attention runs ``repro_torch.kernels.paged_attention`` (the
CUDA kernel on the card, its plain version on the CPU).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models import lm as lm_lib
from repro_torch.models.common import apply_rope, rms_norm, softcap


def init_pools(cfg: ModelConfig, n_pages: int, page_size: int,
               dtype=torch.float32, device="cuda") -> Dict[str, torch.Tensor]:
    hd = cfg.resolved_head_dim
    shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page_size, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _last_writer(key: torch.Tensor) -> torch.Tensor:
    """For each row b, the last row b' >= b whose write key equals key[b].

    Rows that write one pool slot all take the last writer's values, so the
    scatter is deterministic whatever order the device applies it in, and
    the last writer wins, as the reference's ``.at[].set`` does on the CPU.
    """
    idx = torch.arange(key.shape[0], device=key.device)
    same = key[:, None] == key[None, :]
    return torch.where(same, idx[None, :], -1).amax(dim=1)


@torch.no_grad()
def paged_decode_step(params, cfg: ModelConfig, run: RunConfig,
                      pools: Dict[str, torch.Tensor], token: torch.Tensor,
                      pos: torch.Tensor, page_table: torch.Tensor, *,
                      page_size: int,
                      attention: Callable = paged_attention
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """token/pos: (B,); page_table: (B, n_slots) int32. Returns (logits,
    pools).

    pos is the index of the *new* token; attention covers [0, pos]. Unlike
    the reference, which returns new pools, this writes the new token's k/v
    into ``pools`` in place and returns the same dict. ``attention`` is
    there so a check can run the plain version on the same inputs.

    Decode ignores per-layer sliding windows, as the reference does.
    """
    if cfg.parallel_block:
        raise ValueError("paged_lm: sequential blocks only")
    B = token.shape[0]
    dt = getattr(torch, run.compute_dtype)
    lm = params["lm"]
    x = lm["embed"][token.long()[:, None]].to(dt)               # (B, 1, d)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    pos = pos.long()
    pid = page_table.long()[torch.arange(B, device=pos.device),
                            pos // page_size]                    # (B,)
    off = pos % page_size
    src = _last_writer(pid * page_size + off)
    lengths = (pos + 1).to(torch.int32)
    page_table = page_table.to(torch.int32).contiguous()
    hd = cfg.resolved_head_dim
    blocks = params["blocks"]
    for li in range(cfg.n_layers):
        p = lm_lib._layer(blocks, li)
        pa = p["attn"]
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q = (h @ pa["wq"].to(dt).reshape(cfg.d_model, -1)
             ).reshape(B, 1, cfg.n_heads, hd)
        k = (h @ pa["wk"].to(dt).reshape(cfg.d_model, -1)
             ).reshape(B, 1, cfg.n_kv_heads, hd)
        v = (h @ pa["wv"].to(dt).reshape(cfg.d_model, -1)
             ).reshape(B, 1, cfg.n_kv_heads, hd)
        if cfg.qkv_bias:
            q = q + pa["bq"].to(dt)
            k = k + pa["bk"].to(dt)
            v = v + pa["bv"].to(dt)
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
        # write the new token's k/v into the pools
        pk, pv = pools["k"][li], pools["v"][li]
        pk[pid, :, off] = k[src, 0].to(pk.dtype)
        pv[pid, :, off] = v[src, 0].to(pv.dtype)
        a = attention(q[:, 0].float().contiguous(), pk.float(), pv.float(),
                      page_table, lengths, softcap=cfg.attn_softcap)
        a = a.to(dt).reshape(B, 1, cfg.n_heads * hd)
        attn_out = a @ pa["wo"].to(dt).reshape(cfg.n_heads * hd, cfg.d_model)
        if cfg.post_norm:
            attn_out = rms_norm(attn_out, p["pn1"], cfg.norm_eps)
        x = x + attn_out
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        m = lm_lib._mlp_apply(p["mlp"], cfg, h2)
        if cfg.post_norm:
            m = rms_norm(m, p["pn2"], cfg.norm_eps)
        x = x + m
    x = rms_norm(x, lm["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ lm["embed"].to(dt).T
    else:
        logits = x @ lm["lm_head"].to(dt)
    return softcap(logits[:, 0], cfg.logit_softcap), pools
