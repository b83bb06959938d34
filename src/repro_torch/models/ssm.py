"""Selective state-space (Mamba/S6) layer, chunked.

Port of ``repro/models/ssm.py``. The selective scan runs chunk by chunk
(a loop carrying the (B, di, N) float32 state) with an inclusive scan
*inside* each chunk by the reference's ``associative_scan`` recursion and
combine: 16 levels of whole-tensor ops for a chunk of 256, so the kernels
launched per chunk grow with log2 of its length and the bytes moved with
its length. The state math is float32 where the reference casts.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import regions
from repro_torch.distributed import sharding as shlib
from repro_torch.models.common import ParamDef
# the depthwise causal conv over a carried state, the same as xLSTM's
from repro_torch.models.xlstm import _causal_conv

PyTree = Any


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def mamba_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, di, n = cfg.d_model, d_inner(cfg), cfg.ssm_state
    return {
        "w_in": ParamDef((d, 2 * di), ("embed", "inner")),
        "conv": ParamDef((cfg.conv_width, di), (None, "inner")),
        "w_bcdt": ParamDef((di, 2 * n + 1), ("inner", None)),
        "dt_bias": ParamDef((di,), ("inner",), "zeros"),
        "a_log": ParamDef((di, n), ("inner", None), "ones"),
        "d_skip": ParamDef((di,), ("inner",), "ones"),
        "w_out": ParamDef((di, d), ("inner", "embed")),
    }


def _combine(a1, b1, a2, b2):
    """The reference's combine: (a1, b1) then (a2, b2)."""
    return a2 * a1, a2 * b1 + b2


def _interleave(even, odd):
    """Positions 0, 2, 4, ... from ``even`` and 1, 3, ... from ``odd`` along
    axis 1 (``even`` as long as ``odd`` or one longer)."""
    n = even.shape[1] + odd.shape[1]
    if even.shape[1] > odd.shape[1]:
        odd = torch.cat([odd, torch.zeros_like(odd[:, :1])], 1)
    return torch.stack([even, odd], 2).flatten(1, 2)[:, :n]


def _inclusive_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along axis 1 of the pairs (a, b) under ``_combine``,
    by the odd-even recursion of ``jax.lax.associative_scan``: combine
    neighbours, scan the half as long, fill in the even positions. O(L)
    work in 2 log2(L) levels."""
    L = a.shape[1]
    if L < 2:
        return a, b
    odd = _inclusive_scan(*_combine(a[:, 0:-1:2], b[:, 0:-1:2],
                                    a[:, 1::2], b[:, 1::2]))
    n_even = (L - 1) // 2               # even positions after the first
    ea, eb = _combine(odd[0][:, :n_even], odd[1][:, :n_even],
                      a[:, 2::2], b[:, 2::2])
    return (_interleave(torch.cat([a[:, :1], ea], 1), odd[0]),
            _interleave(torch.cat([b[:, :1], eb], 1), odd[1]))


def selective_scan(u, dt, A, Bc, Cc, h0, chunk: int = 256):
    """u: (B, S, di); dt: (B, S, di); A: (di, N); Bc, Cc: (B, S, N); h0:
    (B, di, N).

    h_t = exp(dt_t ⊙ A) h_{t-1} + (dt_t u_t) B_t ;  y_t = h_t · C_t.
    Returns (y (B, S, di), h_final). A ragged tail is zero-padded (dt = 0
    there, so the padded steps leave h as it was).
    """
    B, S, di = u.shape
    pad = (-S) % chunk
    if pad:
        u, dt, Bc, Cc = (F.pad(t, (0, 0, 0, pad)) for t in (u, dt, Bc, Cc))
    h, ys = h0, []
    for c0 in range(0, S + pad, chunk):
        ub, dtb = u[:, c0:c0 + chunk], dt[:, c0:c0 + chunk]
        Bb, Cb = Bc[:, c0:c0 + chunk], Cc[:, c0:c0 + chunk]
        da = torch.exp(dtb[..., None] * A)                   # (B,L,di,N)
        bx = (dtb * ub)[..., None] * Bb[:, :, None, :]       # (B,L,di,N)
        a_cum, b_cum = _inclusive_scan(da, bx)
        hs = a_cum * h[:, None] + b_cum                      # (B,L,di,N)
        ys.append(torch.einsum("bldn,bln->bld", hs, Cb))
        h = hs[:, -1]
    return torch.cat(ys, dim=1)[:, :S], h


def mamba_mix(p, cfg: ModelConfig, h: torch.Tensor, state=None):
    """Mamba mixer on the normed input h: (B, S, d).

    state: (ssm_h (B, di, N) float32, conv (B, W-1, di)) or None.
    Returns (y (B, S, d), new_state).
    """
    B, S, _ = h.shape
    di, N = d_inner(cfg), cfg.ssm_state
    up = h @ p["w_in"].to(h.dtype)
    xi, z = torch.chunk(up, 2, dim=-1)
    conv_state = state[1] if state is not None else None
    xc, new_conv = _causal_conv(xi, p["conv"].to(h.dtype), conv_state)
    xc = F.silu(xc)
    # over a mesh the product sums the inner dim's shards: reduce it here
    # (the small (B, S, 2N+1) result), as GSPMD does
    bcdt = shlib.batch_only(xc @ p["w_bcdt"].to(h.dtype))
    Bc = bcdt[..., :N].float()
    Cc = bcdt[..., N:2 * N].float()
    dt = F.softplus(bcdt[..., 2 * N].float()[..., None]
                    + p["dt_bias"].float())
    A = -torch.exp(p["a_log"].float())
    h0 = state[0] if state is not None else torch.zeros(
        (B, di, N), dtype=torch.float32, device=h.device)
    if S == 1 and state is not None:
        da = torch.exp(dt[:, 0, :, None] * A)
        hs = da * h0 + (dt[:, 0] * xc[:, 0].float())[..., None] \
            * Bc[:, 0, None, :]
        y = torch.einsum("bdn,bn->bd", hs, Cc[:, 0])[:, None]
        h_fin = hs
    else:
        y, h_fin = regions.selective_scan(selective_scan, xc.float(), dt,
                                          A, Bc, Cc, h0)
    y = y.to(h.dtype) + xc * p["d_skip"].to(h.dtype)
    y = y * F.silu(z)
    return y @ p["w_out"].to(h.dtype), (h_fin, new_conv)
