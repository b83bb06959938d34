"""Shared model components: param declaration, norms, rope.

Port of ``repro/models/common.py``. Parameters are declared as ``ParamDef``
trees (nested dicts) and materialized into nested dicts of tensors drawn
from an explicit ``torch.Generator``. The numerics keep the reference's
dtypes: norms and rope run in float32 and cast back.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

PyTree = Any


class ParamDef(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis names, len == len(shape)
    init: str = "normal"              # normal | zeros | ones
    scale: float = 1.0                # stddev multiplier for normal


def _make(gen: torch.Generator, d: ParamDef, lead: Tuple[int, ...],
          dtype) -> torch.Tensor:
    shape, device = lead + tuple(d.shape), gen.device
    if d.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    fan_in = d.shape[0] if d.shape else 1
    std = d.scale / math.sqrt(max(fan_in, 1))
    x = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return x.mul_(std)


def _materialize(gen, defs: PyTree, lead, dtype) -> PyTree:
    # sorted keys: the same leaf order as a JAX tree flatten of the dict
    if isinstance(defs, ParamDef):
        return _make(gen, defs, lead, dtype)
    return {k: _materialize(gen, defs[k], lead, dtype) for k in sorted(defs)}


def init_params(gen: torch.Generator, defs: PyTree,
                dtype=torch.float32) -> PyTree:
    """Materialize a ParamDef tree on ``gen``'s device: zeros/ones, or
    normal with std ``scale / sqrt(fan_in)`` drawn from ``gen``."""
    return _materialize(gen, defs, (), dtype)


def init_stacked(gen: torch.Generator, defs: PyTree, n: int,
                 dtype=torch.float32) -> PyTree:
    """Per-layer weights for ``n`` layers, stacked on a leading axis."""
    return _materialize(gen, defs, (n,), dtype)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S). Half-split
    rotation in float32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                      # (D/2,)
    ang = positions[..., None].float() * freqs                  # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
