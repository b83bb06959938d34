"""Public wrapper of blocked (flash) attention.

A CUDA tensor goes to the hand-written kernel (``csrc/flash_attention.cu``),
or the call raises; a CPU tensor goes to the plain version (``ref.py``).
``flash_attention.launches`` counts the kernel's launches.

The kernel takes strides, so q, k, v and the output may be views (the
model's ``(B, S, H, d) -> (B, H, S, d)`` transposes) as long as the last
dimension is contiguous. The output has q's layout.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.flash_attention.ref import attention_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256      # gemma2's head_dim


@functools.cache
def _launcher():
    from repro_torch.kernels import _build
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window) -> None:
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"q on {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported "
                        f"(float32, bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share one dtype")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, Hq, _, d = q.shape
    Bk, Hkv, _, dk = k.shape
    if Bk != B or dk != d or Hkv == 0 or Hq % Hkv or d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} against k/v "
                         f"{tuple(k.shape)} (need one batch and head_dim, "
                         f"Hq % Hkv == 0, d <= {MAX_HEAD_DIM})")
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"flash_attention: window must be an int >= 0, "
                         f"got {window!r}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"in its last dimension")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Hq, Sq, d); k/v: (B, Hkv, Sk, d), one dtype (float32 or
    bfloat16). Returns (B, Hq, Sq, d). See ``ref.py`` for the semantics."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)       # q's strides where q is dense
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.addressof(strides), B, Hq, Hkv, Sq, Sk, d, int(causal),
        window, 1.0 / math.sqrt(d), float(softcap), _DTYPE_CODE[q.dtype],
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention: kernel launch failed with "
                           f"CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
