"""Shared model components: param declaration, norms, rope, attention, loss.

Port of ``repro/models/common.py``. Parameters are declared as ``ParamDef``
trees (nested dicts and lists), from which come the weights (the same trees
of tensors drawn from an explicit ``torch.Generator``), their logical
sharding axes (``param_axes``) and, for the dry-run, meta tensors of their
shapes (``abstract_params``). The numerics keep the
reference's dtypes: norms, rope, attention and the loss run in float32 and
cast back.
The reference's ``scan_or_unroll`` is a plain loop over layers at the
call sites.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils import checkpoint as ckpt

from repro_torch.distributed import regions
from repro_torch.distributed import sharding as shlib

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
    if isinstance(defs, (list, tuple)):
        return type(defs)(_materialize(gen, d, lead, dtype) for d in defs)
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


def _map_defs(fn: Callable, defs: PyTree) -> PyTree:
    if isinstance(defs, ParamDef):
        return fn(defs)
    if isinstance(defs, (list, tuple)):
        return type(defs)(_map_defs(fn, d) for d in defs)
    return {k: _map_defs(fn, v) for k, v in defs.items()}


def abstract_params(defs: PyTree, dtype=torch.float32) -> PyTree:
    """Meta tensors of the params' shapes (dry-runs; no allocation)."""
    return _map_defs(lambda d: torch.empty(d.shape, dtype=dtype,
                                           device="meta"), defs)


def param_axes(defs: PyTree) -> PyTree:
    """Each param's logical axis names (a tuple per leaf)."""
    return _map_defs(lambda d: d.axes, defs)


def params_from_numpy(tree: PyTree, device, dtype=None) -> PyTree:
    """A tree of dicts, lists and tuples of numpy arrays (e.g. the JAX
    package's params through ``np.asarray``) -> the same tree of tensors on
    ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    t = torch.from_numpy(np.array(tree, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def stack_defs(defs: PyTree, n: int, axis_name: Optional[str] = None) -> PyTree:
    """Prepend a layer axis to every def."""
    if isinstance(defs, ParamDef):
        return ParamDef((n,) + defs.shape, (axis_name,) + defs.axes,
                        defs.init, defs.scale)
    return {k: stack_defs(v, n, axis_name) for k, v in defs.items()}


# ---------------------------------------------------------------------------
# rematerialization
# ---------------------------------------------------------------------------

# the products without batch dimensions: what the reference's
# dots_with_no_batch_dims_saveable keeps (a 3-D x @ 2-D w folds into mm;
# the einsums over heads are bmm and are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn: Callable, mode: str, *args):
    """``fn(*args)`` under the reference's checkpoint policies: "none" runs
    it; "full" saves only its inputs (``nothing_saveable``) and recomputes
    the rest in the backward; "dots" also saves the outputs of its
    matrix products (``dots_with_no_batch_dims_saveable``). Values and
    gradients are the same in every mode; only what the backward keeps
    differs. Without autograd every mode just runs ``fn``."""
    if mode == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if mode == "full":
        return ckpt.checkpoint(fn, *args, use_reentrant=False)
    if mode == "dots":
        return ckpt.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"remat: unknown mode {mode!r} (none, full, dots)")


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


# ---------------------------------------------------------------------------
# attention (plain PyTorch; kernels/flash_attention is the kernel path)
# ---------------------------------------------------------------------------

def _scale(head_dim: int) -> float:
    return 1.0 / math.sqrt(head_dim)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  q_offset: Any = 0,
                  window: int = 0,
                  attn_softcap: float = 0.0,
                  kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped-query attention, full-materialization path.

    q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D). q_offset: int or (B,) tensor,
    the absolute position of q[0] (decode). window > 0 keeps keys with
    ``q_pos - k_pos < window``. kv_len: (B,) valid kv length (decode
    caches). Masked logits are -1e30; the math is float32 and the result
    is cast to q's dtype. Returns (B, Sq, Hq, D).
    """
    if isinstance(k, DTensor):
        return regions.gqa_attention(q, k, v, causal=causal,
                                     q_offset=q_offset, window=int(window),
                                     attn_softcap=attn_softcap,
                                     kv_len=kv_len)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    dev = q.device
    window = int(window)
    qh = q.reshape(B, Sq, Hkv, g, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qh.float(),
                          k.float()) * _scale(D)
    logits = softcap(logits, attn_softcap)
    off = torch.as_tensor(q_offset, device=dev).reshape(-1, 1)
    q_pos = off + torch.arange(Sq, device=dev)[None]             # (B|1, Sq)
    k_pos = torch.arange(Sk, device=dev)[None]                   # (1, Sk)
    mask = torch.ones((q_pos.shape[0], Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= q_pos[:, :, None] >= k_pos[:, None, :]
    if window > 0:
        mask &= (q_pos[:, :, None] - k_pos[:, None, :]) < window
    if kv_len is not None:
        mask &= k_pos[:, None, :] < kv_len.reshape(-1, 1, 1)
    logits = torch.where(mask[:, None, None], logits,
                         torch.tensor(-1e30, device=dev))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True,
                      window: int = 0,
                      attn_softcap: float = 0.0,
                      chunk: int = 1024) -> torch.Tensor:
    """Flash-style online-softmax attention over kv chunks (memory
    O(Sq * chunk)), carrying (acc, row max, row sum) across chunks. Sk is
    zero-padded to a multiple of ``chunk``; padded keys are masked."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if Sk % chunk:
        pad = chunk - Sk % chunk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    n_chunks = k.shape[1] // chunk
    g = Hq // Hkv
    dev = q.device
    qh = (q.float() * _scale(D)).reshape(B, Sq, Hkv, g, D)
    q_pos = torch.arange(Sq, device=dev)
    acc = torch.zeros((B, Hkv, g, Sq, D), dtype=torch.float32, device=dev)
    m = torch.full((B, Hkv, g, Sq), -math.inf, dtype=torch.float32,
                   device=dev)
    s = torch.zeros((B, Hkv, g, Sq), dtype=torch.float32, device=dev)
    neg = torch.tensor(-1e30, device=dev)
    for ci in range(n_chunks):
        kb = k[:, ci * chunk:(ci + 1) * chunk].float()
        vb = v[:, ci * chunk:(ci + 1) * chunk].float()
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qh, kb)
        logits = softcap(logits, attn_softcap)
        k_pos = ci * chunk + torch.arange(chunk, device=dev)
        mask = (k_pos[None, :] < Sk).expand(Sq, chunk)
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        if window > 0:
            mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
        logits = torch.where(mask, logits, neg)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        s = s * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
        m = m_new
    out = acc / torch.clamp(s[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)


def attention(q, k, v, *, causal=True, window=0, attn_softcap=0.0,
              chunk_threshold: int = 8192) -> torch.Tensor:
    """Dispatch: full path for short sequences, chunked online softmax for
    long ones; DTensor operands (a decode against a laid-out cache) go to
    ``regions.gqa_attention``."""
    if isinstance(k, DTensor):
        return gqa_attention(q, k, v, causal=causal, window=window,
                             attn_softcap=attn_softcap)
    if q.shape[1] >= chunk_threshold or k.shape[1] > chunk_threshold:
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 attn_softcap=attn_softcap)
    return gqa_attention(q, k, v, causal=causal, window=window,
                         attn_softcap=attn_softcap)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def embed_lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``. F.embedding: its backward sums a row's gradients
    in a fixed order (indexing's backward accumulates in no fixed order, on
    either device); a DTensor table is looked up in a local region."""
    if isinstance(table, DTensor):
        return shlib.batch_only(regions.embedding(tokens, table))
    return F.embedding(tokens.long(), table)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 z_loss: float = 1e-4) -> torch.Tensor:
    """Mean cross-entropy over valid positions, with optional z-loss.
    DTensor logits go through ``regions.xent`` (vocab over ``model``)."""
    if isinstance(logits, DTensor):
        return regions.xent(logits, labels, mask, z_loss)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse.square()
    if mask is None:
        return loss.mean()
    mask = mask.float()
    return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------

def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """(n, d) float32: sin at even columns, cos at odd, angles
    ``pos / 10000^(2i/d)`` in float64 (the reference builds the table in
    numpy the same way)."""
    pos = np.arange(n)[:, None]
    dim = np.arange(0, d, 2)[None]
    ang = pos / np.power(10000.0, dim / d)
    out = np.zeros((n, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out).to(device)
