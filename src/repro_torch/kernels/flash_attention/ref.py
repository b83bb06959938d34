"""Plain PyTorch version of blocked (flash) attention.

Computes what the CUDA kernels (``csrc/flash_attention_f32_sm90.cu`` for
float32, ``csrc/flash_attention_sm90.cu`` for bfloat16) compute, with the
reference Pallas kernel's conventions:

* the scale is ``1/sqrt(d)``, then an optional tanh softcap, then the mask;
* the causal mask keeps ``q_pos >= k_pos`` with both positions counted
  from 0: top-left alignment when ``Sq != Sk`` (not the bottom-right
  alignment of SDPA's ``is_causal``);
* a window > 0 keeps ``q_pos - k_pos < window``;
* masked logits are -1e30;
* GQA maps q-head ``h`` to kv-head ``h // (Hq // Hkv)``.

A query row that sees no key at all is the one case where they differ, as
the Pallas kernel differs from its own oracle there: this version gives
the mean of ``v`` over every key, a kernel the mean over the keys (those
below Sk) of the key tiles its q tile visited, or 0 when it visited none.
That depends on the tiles (q rows x keys): float32 128 x 32 at head_dim
<= 128, 64 x 16 above; bfloat16 128 x 128 at head_dim <= 128, 128 x 64
above (``ops.kernel_config``).
"""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Hq, Sq, d); k/v: (B, Hkv, Sk, d). Returns (B, Hq, Sq, d) in
    q's dtype; the math is float32."""
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qg = q.float().reshape(B, Hkv, g, Sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) / math.sqrt(d)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(B, Hq, Sq, d).to(q.dtype)
