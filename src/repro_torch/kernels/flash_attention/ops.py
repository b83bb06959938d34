"""Public wrapper of blocked (flash) attention.

A CPU tensor goes to the plain version (``ref.py``). A CUDA tensor goes to
one of two hand-written kernels, chosen by dtype, or the call raises:

* bfloat16 -> ``csrc/flash_attention_sm90.cu``: wgmma products fed by TMA,
  for head_dim a multiple of 16 up to 256, with TMA's layout rule
  (``_sm90_layout_ok``);
* float32 -> ``csrc/flash_attention_f32_sm90.cu``: every product as three
  TF32 tensor-core products (3xTF32: the float32 tolerance rules out a
  single TF32 product, not the split one), for any head_dim up to 256
  (``_check_kernel``) and any strides.

``flash_attention.launches`` counts the launches of both kernels,
``flash_attention.launches_bf16`` those of the bfloat16 one.

The kernels take strides, so q, k, v and the output may be views (the
model's ``(B, S, H, d) -> (B, H, S, d)`` transposes) as long as the last
dimension is contiguous. The output has q's layout.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.flash_attention.ref import attention_ref

MAX_HEAD_DIM = 256      # gemma2's head_dim
# the source of each route's kernel, by dtype (csrc/<name>.cu)
SOURCES = {torch.float32: "flash_attention_f32_sm90",
           torch.bfloat16: "flash_attention_sm90"}


@functools.cache
def _launcher(dtype: torch.dtype):
    """The C entry of ``dtype``'s kernel; both take the same arguments."""
    from repro_torch.kernels import _build
    name = SOURCES[dtype]
    fn = getattr(_build.load(name), f"{name}_launch")
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def kernel_config(dtype: torch.dtype, d: int) -> dict:
    """The launch configuration of ``dtype``'s kernel at head_dim ``d``: q
    rows per block, keys per tile, dynamic shared memory bytes (builds the
    kernel; needs the CUDA toolkit)."""
    from repro_torch.kernels import _build
    name = SOURCES[dtype]
    vals = [ctypes.c_int() for _ in range(3)]
    getattr(_build.load(name), f"{name}_config")(
        ctypes.c_int(d), *(ctypes.byref(x) for x in vals))
    return dict(zip(("block_q", "block_k", "smem_bytes"),
                    (x.value for x in vals)))


def _sm90_layout_ok(t: torch.Tensor) -> bool:
    """TMA's rule for a bfloat16 operand: a 16-byte aligned base, and the
    stride of every non-innermost dimension longer than 1 a multiple of 16
    bytes (8 elements)."""
    return t.data_ptr() % 16 == 0 and all(
        n <= 1 or (st * t.element_size()) % 16 == 0
        for n, st in zip(t.shape[:-1], t.stride()[:-1]))


def _check(q, k, v, window) -> None:
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"q on {q.device}")
    if q.dtype not in SOURCES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported "
                        f"(float32, bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share one dtype")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, Hq, _, d = q.shape
    Bk, Hkv, _, dk = k.shape
    if Bk != B or dk != d or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} against k/v "
                         f"{tuple(k.shape)} (need one batch and head_dim, "
                         f"Hq % Hkv == 0)")
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"flash_attention: window must be an int >= 0, "
                         f"got {window!r}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"in its last dimension")


def _check_kernel(q, k) -> None:
    """What only the card's kernels cannot take, checked before a launch
    (the plain version computes it): head_dim past ``MAX_HEAD_DIM``."""
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} against k/v "
                         f"{tuple(k.shape)} (the kernels need d <= "
                         f"{MAX_HEAD_DIM})")


def _check_sm90(q, k, v) -> None:
    d = q.shape[-1]
    if d % 16:
        raise ValueError(f"flash_attention: the bfloat16 kernel takes "
                         f"head_dim a multiple of 16 up to {MAX_HEAD_DIM}, "
                         f"got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _sm90_layout_ok(t):
            raise ValueError(
                f"flash_attention: {name} (strides {tuple(t.stride())}, "
                f"address {t.data_ptr():#x}) does not fit TMA: the bfloat16 "
                f"kernel needs a 16-byte aligned base and every stride but "
                f"the last a multiple of 8 elements")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Hq, Sq, d); k/v: (B, Hkv, Sk, d), one dtype (float32 or
    bfloat16). Returns (B, Hq, Sq, d). See ``ref.py`` for the semantics.
    Raises where a gradient is needed (``refuse_grad``)."""
    refuse_grad("flash_attention", q, k, v)
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    _check_kernel(q, k)
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        _check_sm90(q, k, v)
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)       # q's strides where q is dense
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ctypes.addressof(strides), B, Hq, Hkv, Sq, Sk, d, int(causal),
            window, 1.0 / math.sqrt(d), float(softcap))
    err = _launcher(q.dtype)(*args, q.device.index,
                             torch.cuda.current_stream(q.device).cuda_stream)
    if err < 0:
        raise RuntimeError(f"flash_attention: TMA tensor map encoding "
                           f"failed with CUresult {-err}")
    if err:
        raise RuntimeError(f"flash_attention: kernel launch failed with "
                           f"CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.launches_bf16 += bf16
    return out


flash_attention.launches = 0
flash_attention.launches_bf16 = 0
