"""Public wrapper of the chunkwise-parallel mLSTM scan.

A CUDA tensor goes to the hand-written kernel (``csrc/mlstm_scan.cu``), or
the call raises; a CPU tensor goes to the plain version (``ref.py``).
``mlstm_scan.launches`` counts the kernel's launches.

The kernel takes (batch, head, seq) strides, so q, k, v, lf and li may be
views as long as the last dimension of q, k and v is contiguous. The output
is a new contiguous (B, H, S, dh) tensor in q's dtype.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 512      # the float32 C tile (dh x 64) must fit shared memory
MAX_CHUNK = 256         # one thread per chunk row for the gate scalars


@functools.cache
def _launcher():
    from repro_torch.kernels import _build
    fn = _build.load("mlstm_scan").mlstm_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, lf, li, chunk) -> int:
    """Validates the inputs; returns the chunk length the scan uses."""
    for name, t in (("k", k), ("v", v), ("lf", lf), ("li", li)):
        if t.device != q.device:
            raise ValueError(f"mlstm_scan: {name} on {t.device}, q on "
                             f"{q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"mlstm_scan: dtype {q.dtype} not supported "
                        f"(float32, bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("mlstm_scan: q, k, v must share one dtype")
    if lf.dtype != torch.float32 or li.dtype != torch.float32:
        raise TypeError("mlstm_scan: the gates lf, li must be float32")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"mlstm_scan: q, k, v must share one (B, H, S, dh) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if lf.shape != q.shape[:3] or li.shape != q.shape[:3]:
        raise ValueError(f"mlstm_scan: lf, li must be (B, H, S) = "
                         f"{tuple(q.shape[:3])}, got {tuple(lf.shape)}, "
                         f"{tuple(li.shape)}")
    S, dh = q.shape[2], q.shape[3]
    chunk = min(int(chunk), S)
    if chunk < 1 or S % chunk:
        raise ValueError(f"mlstm_scan: S={S} must be a positive multiple of "
                         f"chunk={chunk}")
    if chunk > MAX_CHUNK or dh > MAX_HEAD_DIM:
        raise ValueError(f"mlstm_scan: chunk={chunk}, dh={dh}; the kernel "
                         f"takes chunk <= {MAX_CHUNK} and dh <= "
                         f"{MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if dh > 1 and t.stride(-1) != 1:
            raise ValueError(f"mlstm_scan: {name} must be contiguous in its "
                             f"last dimension")
    return chunk


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lf: torch.Tensor, li: torch.Tensor, *,
               chunk: int = 128) -> torch.Tensor:
    """q, k, v: (B, H, S, dh), float32 or bfloat16; lf, li: (B, H, S)
    float32 log-forget and log-input gates. The scan starts from a zero
    state. Returns h (B, H, S, dh) in q's dtype; see ``ref.py``."""
    chunk = _check(q, k, v, lf, li, chunk)
    if q.device.type == "cpu":
        return mlstm_scan_ref(q, k, v, lf, li, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_scan: no kernel for {q.device}")
    B, H, S, dh = q.shape
    out = torch.empty((B, H, S, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 15)(
        *(s for t in (q, k, v, lf, li) for s in t.stride()[:3]))
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lf.data_ptr(),
        li.data_ptr(), out.data_ptr(), ctypes.addressof(strides), B, H, S,
        dh, chunk, dh ** -0.5, _DTYPE_CODE[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"mlstm_scan: kernel launch failed with CUDA "
                           f"error {err}")
    mlstm_scan.launches += 1
    return out


mlstm_scan.launches = 0
