"""Public wrapper of paged decode attention.

A CUDA tensor goes to the hand-written kernel (``csrc/paged_attention.cu``),
or the call raises; a CPU tensor goes to the plain version (``ref.py``).
``paged_attention.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.paged_attention.ref import paged_attention_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256      # gemma2's head_dim
MAX_GROUP = 8           # query heads per kv head


@functools.cache
def _launcher():
    from repro_torch.kernels import _build
    fn = _build.load("paged_attention").paged_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_pages, v_pages, page_table, lengths) -> None:
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"paged_attention: {name} on {t.device}, "
                             f"q on {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged_attention: dtype {q.dtype} not supported "
                        f"(float32, bfloat16)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_attention: q, k_pages, v_pages must share "
                        "one dtype")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention: page_table and lengths must be "
                        "int32")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k_pages.shape)}, v {tuple(v_pages.shape)}")
    B, Hq, d = q.shape
    P, Hkv, page, dk = k_pages.shape
    if dk != d or Hkv == 0 or Hq % Hkv or Hq // Hkv > MAX_GROUP \
            or d > MAX_HEAD_DIM or P == 0 or page == 0:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} against pages "
                         f"{tuple(k_pages.shape)} (need Hq % Hkv == 0, "
                         f"Hq/Hkv <= {MAX_GROUP}, d <= {MAX_HEAD_DIM})")
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or page_table.shape[1] == 0 or tuple(lengths.shape) != (B,):
        raise ValueError(f"paged_attention: page_table "
                         f"{tuple(page_table.shape)}, lengths "
                         f"{tuple(lengths.shape)} for batch {B}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor, *,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Hq, d); pages: (P, Hkv, page, d) of q's dtype (float32 or
    bfloat16); page_table: (B, n_slots) int32; lengths: (B,) int32.

    Returns (B, Hq, d). See ``ref.py`` for the semantics.
    """
    _check(q, k_pages, v_pages, page_table, lengths)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table, lengths,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    B, Hq, d = q.shape
    P, Hkv, page, _ = k_pages.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    err = _launcher()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, d, page, page_table.shape[1], P,
        1.0 / math.sqrt(d), float(softcap), _DTYPE_CODE[q.dtype],
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention: kernel launch failed with "
                           f"CUDA error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
