"""Plain PyTorch version of paged decode attention.

Computes what the CUDA kernel (``csrc/paged_attention_sm90.cu``) computes,
with the reference Pallas kernel's conventions:

* the scale is ``1/sqrt(d)``, then an optional tanh softcap;
* keys at positions ``>= length`` are masked out, and page-table slots that
  start at or past the length are never read (their ids may be garbage);
* a sequence of length 0 gets zeros (``acc = 0, l -> max(l, 1e-30)``),
  as the kernel does, not the mean of ``v``.
"""
from __future__ import annotations

import math

import torch


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_table: torch.Tensor,
                        lengths: torch.Tensor,
                        softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Hq, d); pages: (P, Hkv, page, d); page_table: (B, n_slots);
    lengths: (B,). Returns (B, Hq, d) in q's dtype."""
    B, Hq, d = q.shape
    P, Hkv, page, _ = k_pages.shape
    g = Hq // Hkv
    n_slots = page_table.shape[1]
    lengths = lengths.long()
    slot_start = torch.arange(n_slots, device=q.device) * page
    live = slot_start[None, :] < lengths[:, None]              # (B, n_slots)
    ids = page_table.long()
    if bool(((ids < 0) | (ids >= P))[live].any()):
        raise IndexError("paged_attention: page id out of range inside a "
                         "sequence's length")
    ids = torch.where(live, ids, torch.zeros_like(ids))
    S = n_slots * page
    k = k_pages[ids].transpose(1, 2).reshape(B, Hkv, S, d).float()
    v = v_pages[ids].transpose(1, 2).reshape(B, Hkv, S, d).float()
    qg = q.float().reshape(B, Hkv, g, d)
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k) / math.sqrt(d)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    valid = (torch.arange(S, device=q.device)[None, :]
             < lengths[:, None])[:, None, None, :]               # (B,1,1,S)
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v) / torch.clamp(l, min=1e-30)
    return out.reshape(B, Hq, d).to(q.dtype)
