"""Public wrapper of paged decode attention.

A CPU tensor goes to the plain version (``ref.py``). A CUDA tensor goes to
the hand-written kernel ``csrc/paged_attention_sm90.cu``, or the call
raises. The kernel takes every shape the wrapper accepts up to a head dim of
``KERNEL_MAX_HEAD_DIM``: any g = Hq / Hkv (the query rows of a kv head in
group tiles of ``tile_rows``), any page size, any row width in bytes, any
pool base address. Each sequence's pages are split across blocks; the run of
pages per block comes from ``_pages_per_split``, which never reads
``lengths``.

``paged_attention.launches`` counts the calls that launched the kernel.
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
SPLIT_BLOCKS_PER_SM = 4         # blocks _pages_per_split aims to give an SM
MAX_TILE_ROWS = 8               # query rows of a group tile
MAX_LANE_FLOATS = 64            # a lane's floats of a tile's q rows
KERNEL_MAX_HEAD_DIM = 2048      # a row in registers: 16 vectors a lane (f32)


@functools.cache
def _launcher_sm90():
    from repro_torch.kernels import _build
    fn = _build.load("paged_attention_sm90").paged_attention_sm90_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def tile_rows(g: int, d: int, elt: int) -> int:
    """Query rows per group tile for g rows per kv head, head dim d and elt
    bytes per element: the power of two >= g up to ``MAX_TILE_ROWS``,
    halved while the tile's q would pass ``MAX_LANE_FLOATS`` floats in a
    lane that holds the fewest 16-byte vectors of a row that let 32 lanes
    cover it. The g rows run as ``ceil(g / tile_rows)`` tiles.

    The kernel's ``make_plan`` refuses a tile that breaks the same rule
    (its ``kMaxRows``, ``kMaxLaneFloats``), and its launch switch holds
    one instance per (rows, vectors per lane) pair that this choice gives;
    tests/test_torch_paged_attention.py holds the three together."""
    vec, nv = 16 // elt, -(-d * elt // 16)
    nvl = _pow2_at_least(-(-nv // 32))
    rows = min(MAX_TILE_ROWS, _pow2_at_least(g))
    while rows > 1 and rows * nvl * vec > MAX_LANE_FLOATS:
        rows //= 2
    return rows


def _bulk_copies(k_pages: torch.Tensor, v_pages: torch.Tensor) -> bool:
    """Whether the kernel fills its ring stages from these pools by bulk
    copies (both bases and the row width multiples of 16 bytes) rather than
    by the producer warp's 2-byte loads."""
    row = k_pages.shape[-1] * k_pages.element_size()
    return (k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0
            and row % 16 == 0)


def sm90_plan(g: int, d: int, page: int,
              dtype: torch.dtype) -> Optional[dict]:
    """The kernel's plan for a shape: query rows per group tile and tiles,
    16-byte vectors of a row per lane, keys per ring stage, ring stages and
    dynamic shared memory bytes. None where the kernel does not take the
    shape (builds the kernel; needs the CUDA toolkit)."""
    from repro_torch.kernels import _build
    rows = tile_rows(g, d, torch.empty((), dtype=dtype).element_size())
    vals = [ctypes.c_int() for _ in range(4)]
    ok = _build.load("paged_attention_sm90").paged_attention_sm90_plan(
        ctypes.c_int(rows), ctypes.c_int(d), ctypes.c_int(page),
        ctypes.c_int(_DTYPE_CODE[dtype]), *(ctypes.byref(x) for x in vals))
    if not ok:
        return None
    return {"tile_rows": rows, "tiles": -(-g // rows),
            **dict(zip(("vectors_per_lane", "keys_per_stage", "stages",
                        "smem_bytes"), (x.value for x in vals)))}


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _pages_per_split(B: int, Hkv: int, n_slots: int, n_sm: int) -> int:
    """Pages each block walks: the fewest splits of the n_slots slots that
    give ``SPLIT_BLOCKS_PER_SM`` blocks per SM over the B x Hkv blocks of one
    split (the caller passes the kv heads times the group tiles), and one
    split where those blocks already fill the card. The lengths are not an
    argument: reading them would stall the serving loop on the device."""
    pairs = B * Hkv
    n_split = min(n_slots, max(1, -(-SPLIT_BLOCKS_PER_SM * n_sm // pairs)))
    return -(-n_slots // n_split)


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
    if dk != d or Hkv == 0 or Hq % Hkv or P == 0 or page == 0:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} against pages "
                         f"{tuple(k_pages.shape)} (need one head dim, "
                         f"Hq % Hkv == 0, pages)")
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or page_table.shape[1] == 0 or tuple(lengths.shape) != (B,):
        raise ValueError(f"paged_attention: page_table "
                         f"{tuple(page_table.shape)}, lengths "
                         f"{tuple(lengths.shape)} for batch {B}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")


def _check_kernel(d: int) -> None:
    """What only the card's kernel cannot take: a head dim whose row one
    lane group cannot hold in registers."""
    if d > KERNEL_MAX_HEAD_DIM:
        raise ValueError(f"paged_attention: the kernel takes head_dim <= "
                         f"{KERNEL_MAX_HEAD_DIM}, got {d}")


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
    _check_kernel(q.shape[2])
    if q.shape[0] == 0:
        return torch.empty_like(q)
    out = _run_sm90(q, k_pages, v_pages, page_table, lengths, softcap)
    paged_attention.launches += 1
    return out


def _run_sm90(q, k_pages, v_pages, page_table, lengths, softcap,
         pages_per_split=None):
    """Launches ``csrc/paged_attention_sm90.cu`` on checked CUDA inputs
    (B >= 1) and returns the output; ``pages_per_split`` (None:
    ``_pages_per_split``'s choice) lets a measurement pick the split."""
    B, Hq, d = q.shape
    P, Hkv, page, _ = k_pages.shape
    n_slots = page_table.shape[1]
    rows = tile_rows(Hq // Hkv, d, q.element_size())
    out = torch.empty_like(q)
    dev = q.device.index
    pps = pages_per_split or _pages_per_split(
        B, Hkv * -(-(Hq // Hkv) // rows), n_slots, _sm_count(dev))
    n_split = -(-n_slots // pps)
    ws = (torch.empty((B, Hq, n_split, d + 2), dtype=torch.float32,
                      device=q.device) if n_split > 1 else None)
    err = _launcher_sm90()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), B, Hq, Hkv, d, page, n_slots,
        P, pps, rows, int(_bulk_copies(k_pages, v_pages)),
        1.0 / math.sqrt(d), float(softcap), _DTYPE_CODE[q.dtype], dev,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention: kernel launch failed with "
                           f"CUDA error {err}")
    return out


paged_attention.launches = 0
