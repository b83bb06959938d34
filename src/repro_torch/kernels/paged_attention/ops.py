"""Public wrapper of paged decode attention.

A CPU tensor goes to the plain version (``ref.py``). A CUDA tensor goes to
one of two hand-written kernels, chosen by shape (``_sm90_ok``), or the call
raises:

* ``csrc/paged_attention_sm90.cu``: pages split across blocks, whole pages
  fed by bulk TMA copies, for pools with 16-byte aligned bases and rows,
  pages of at most 256 keys and 32 KiB; the run of pages per block comes
  from ``_pages_per_split``, which never reads ``lengths``;
* ``csrc/paged_attention.cu``: one block per (kv head, sequence), for any
  other shape.

``paged_attention.launches`` counts the calls that launched a kernel,
``paged_attention.launches_sm90`` those of the first route.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256      # gemma2's head_dim
MAX_GROUP = 8           # query heads per kv head
SM90_MAX_PAGE = 256             # keys per page on the sm90 route
SM90_MAX_PAGE_BYTES = 32768     # one page of K (or V) for one kv head
SPLIT_BLOCKS_PER_SM = 4         # blocks _pages_per_split aims to give an SM


@functools.cache
def _launcher():
    from repro_torch.kernels import _build
    fn = _build.load("paged_attention").paged_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _launcher_sm90():
    from repro_torch.kernels import _build
    fn = _build.load("paged_attention_sm90").paged_attention_sm90_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def sm90_plan(g: int, d: int, page: int, dtype: torch.dtype) -> Optional[dict]:
    """The sm90 kernel's ring stages and dynamic shared memory bytes for a
    shape, or None where it does not take it (builds the kernel; needs the
    CUDA toolkit)."""
    from repro_torch.kernels import _build
    stages, smem = ctypes.c_int(), ctypes.c_int()
    ok = _build.load("paged_attention_sm90").paged_attention_sm90_plan(
        ctypes.c_int(g), ctypes.c_int(d), ctypes.c_int(page),
        ctypes.c_int(_DTYPE_CODE[dtype]), ctypes.byref(stages),
        ctypes.byref(smem))
    return {"stages": stages.value, "smem_bytes": smem.value} if ok else None


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _pages_per_split(B: int, Hkv: int, n_slots: int, n_sm: int) -> int:
    """Pages each block of the sm90 route walks: the fewest splits of the
    n_slots slots that give ``SPLIT_BLOCKS_PER_SM`` blocks per SM over the
    B x Hkv (sequence, kv head) pairs, and one split where those pairs
    already fill the card. The lengths are not an argument: reading them
    would stall the serving loop on the device."""
    pairs = B * Hkv
    n_split = min(n_slots, max(1, -(-SPLIT_BLOCKS_PER_SM * n_sm // pairs)))
    return -(-n_slots // n_split)


def _sm90_ok(k_pages: torch.Tensor, v_pages: torch.Tensor) -> bool:
    """Whether the sm90 kernel takes these pools: bulk copies need 16-byte
    aligned pages, the compute reads 16-byte vectors of a row, and a stage
    of the shared-memory ring holds one page of K and one of V."""
    _, _, page, d = k_pages.shape
    row = d * k_pages.element_size()
    return (k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0
            and row % 16 == 0 and page <= SM90_MAX_PAGE
            and page * row <= SM90_MAX_PAGE_BYTES)


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

    Returns (B, Hq, d). See ``ref.py`` for the semantics. Raises where a
    gradient is needed (``refuse_grad``).
    """
    refuse_grad("paged_attention", q, k_pages, v_pages)
    _check(q, k_pages, v_pages, page_table, lengths)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table, lengths,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    if q.shape[0] == 0:
        return torch.empty_like(q)
    sm90 = _sm90_ok(k_pages, v_pages)
    if sm90:
        out = _run_sm90(q, k_pages, v_pages, page_table, lengths, softcap)
    else:
        out = _run_simt(q, k_pages, v_pages, page_table, lengths, softcap)
    paged_attention.launches += 1
    paged_attention.launches_sm90 += sm90
    return out


def _run_sm90(q, k_pages, v_pages, page_table, lengths, softcap,
              pages_per_split=None):
    """Launches ``csrc/paged_attention_sm90.cu`` on checked CUDA inputs
    (B >= 1) and returns the output; ``pages_per_split`` (None:
    ``_pages_per_split``'s choice) lets a measurement pick the split."""
    B, Hq, d = q.shape
    P, Hkv, page, _ = k_pages.shape
    n_slots = page_table.shape[1]
    out = torch.empty_like(q)
    dev = q.device.index
    pps = pages_per_split or _pages_per_split(B, Hkv, n_slots, _sm_count(dev))
    n_split = -(-n_slots // pps)
    ws = (torch.empty((B, Hq, n_split, d + 2), dtype=torch.float32,
                      device=q.device) if n_split > 1 else None)
    err = _launcher_sm90()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), B, Hq, Hkv, d, page, n_slots,
        P, pps, 1.0 / math.sqrt(d), float(softcap), _DTYPE_CODE[q.dtype], dev,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention: sm90 kernel launch failed with "
                           f"CUDA error {err}")
    return out


def _run_simt(q, k_pages, v_pages, page_table, lengths, softcap):
    """Launches ``csrc/paged_attention.cu`` on checked CUDA inputs (B >= 1)
    and returns the output."""
    B, Hq, d = q.shape
    P, Hkv, page, _ = k_pages.shape
    out = torch.empty_like(q)
    err = _launcher()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, d, page, page_table.shape[1], P, 1.0 / math.sqrt(d),
        float(softcap), _DTYPE_CODE[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention: kernel launch failed with "
                           f"CUDA error {err}")
    return out


paged_attention.launches = 0
paged_attention.launches_sm90 = 0
