"""Public wrapper of paged decode attention.

A CPU tensor goes to the plain version (``ref.py``). A CUDA tensor goes to
the hand-written kernel ``csrc/paged_attention_sm90.cu``, or the call
raises. The kernel takes every shape the wrapper accepts: any batch and
number of kv heads (every block index in the grid's x dimension,
``paged_block``), any g = Hq / Hkv, any head dim, any page size, any row
width in bytes, any pool base address. Three routes (``group_tile_rows``):
g >= 8 at d <= 256 the mma route (``mma_route``: every query row of a kv
head in a row tile of up to 64 rows, the products on the tensor cores);
else up to d = 2048 the register route (query rows in group tiles of
``tile_rows``); past it the wide route (``wide_route``: d in slices of
``WIDE_COLS`` columns taken by the CTAs of a thread-block cluster, which
sum their partial scores over distributed shared memory, ``wide_plan``).
Each sequence's pages are
split across blocks; the run of pages per block comes from
``_pages_per_split``, which never reads ``lengths``.

``paged_attention.launches`` counts the calls that launched the kernel,
``paged_attention.launches_mma`` those of them on the mma route.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
SPLIT_BLOCKS_PER_SM = 4         # blocks _pages_per_split aims to give an SM
MAX_TILE_ROWS = 8               # query rows of a group tile
MAX_LANE_FLOATS = 64            # a lane's floats of a tile's q rows
WIDE_COLS = 2048                # the wide route's columns of d per CTA
CLUSTER_MAX = 8                 # its CTAs a cluster (the portable limit)
MMA_MIN_GROUP = 8               # the mma route: g >= 8 ...
MMA_MAX_D = 256                 # ... at d <= 256
MMA_MAX_ROWS = 64               # its query rows of a row tile


# the C entry's arguments (csrc/paged_attention_sm90.cu)
LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])


@functools.cache
def _launcher_sm90():
    from repro_torch.kernels import _build
    fn = _build.load("paged_attention_sm90").paged_attention_sm90_launch
    fn.argtypes = LAUNCH_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def _lane_vectors(d: int, elt: int) -> int:
    """16-byte vectors of a row a lane holds where 32 lanes cover it: the
    power of two >= ceil(vectors / 32)."""
    nv = -(-d * elt // 16)
    return _pow2_at_least(-(-nv // 32))


def wide_route(d: int, elt: int) -> bool:
    """Whether head dim d at elt bytes per element takes the kernel's wide
    route: one query row would pass a lane's ``MAX_LANE_FLOATS`` floats (d
    > 2048 in every type). The kernel source's ``wide_route`` is the same
    rule."""
    return _lane_vectors(d, elt) * (16 // elt) > MAX_LANE_FLOATS


def n_slices(d: int, elt: int) -> int:
    """Output column slices per (group tile, split): ``WIDE_COLS`` each on
    the wide route, one on the register route."""
    return -(-d // WIDE_COLS) if wide_route(d, elt) else 1


def wide_plan(d: int, cluster: int = CLUSTER_MAX) -> tuple:
    """The wide route at head dim d: (slices of ``WIDE_COLS`` columns, CTAs
    a cluster, slices with the last group's padding). A cluster holds at
    most ``cluster`` CTAs; past that the slices go in groups of one cluster
    each, the last padded to a whole cluster with CTAs that own no column
    (the source's ``wide_plan``)."""
    n_sl = -(-d // WIDE_COLS)
    n_cl = min(n_sl, cluster)
    return n_sl, n_cl, -(-n_sl // n_cl) * n_cl


def paged_block(x: int, n_tiles: int, n_sl: int, n_split: int,
                Hkv: int) -> tuple:
    """The (b, kv head, group tile, slice, split) of the block at index
    ``x`` of the grid's x dimension, as the kernel decodes it: x = slice +
    n_sl * (tile + n_tiles * (split + n_split * (h + Hkv * b))), with n_sl
    the grid's slices (``wide_plan``'s padded count on the wide route, 1
    elsewhere). The slices of one (b, kv head, split, tile) are next to
    each other, so a cluster of ``wide_plan``'s CTAs (which divides n_sl)
    is consecutive slices of one tile, a CTA's rank in it its slice %
    cluster; then the tiles of one (b, kv head, split)."""
    x, sl = divmod(x, n_sl)
    x, tile = divmod(x, n_tiles)
    x, split = divmod(x, n_split)
    b, h = divmod(x, Hkv)
    return b, h, tile, sl, split


def tile_rows(g: int, d: int, elt: int) -> int:
    """Query rows per group tile of the register and wide routes for g rows
    per kv head, head dim d and elt bytes per element (the mma route's
    shapes take ``mma_tile_rows``): the power of two >= g up to
    ``MAX_TILE_ROWS``,
    halved while the tile's q would pass ``MAX_LANE_FLOATS`` floats in a
    lane that holds the fewest 16-byte vectors of a row that let 32 lanes
    cover it; on the wide route (no row in registers) not halved. The g
    rows run as ``ceil(g / tile_rows)`` tiles.

    The kernel's ``make_plan`` refuses a tile that breaks the same rule
    (its ``kMaxRows``, ``kMaxLaneFloats``), and its launch switch holds
    one instance per (rows, vectors per lane) pair that this choice gives;
    tests/test_torch_paged_attention.py holds the three together."""
    vec, nvl = 16 // elt, _lane_vectors(d, elt)
    rows = min(MAX_TILE_ROWS, _pow2_at_least(g))
    if wide_route(d, elt):
        return rows
    while rows > 1 and rows * nvl * vec > MAX_LANE_FLOATS:
        rows //= 2
    return rows


def mma_route(g: int, d: int, elt: int) -> bool:
    """Whether g query rows per kv head at head dim d take the kernel's mma
    route, in every type (elt bytes per element): g >= ``MMA_MIN_GROUP`` (g
    = 8 included: at 64/8 heads, d = 128, the route ran 1.5x (float32) and
    3.0x (bfloat16, float16) faster than the register route on the H100)
    at d <= ``MMA_MAX_D``. The kernel source's ``mma_route`` is the same
    rule."""
    return elt > 0 and g >= MMA_MIN_GROUP and 1 <= d <= MMA_MAX_D


def mma_tile_rows(g: int) -> int:
    """Query rows of the mma route's row tile: g rounded up to whole m16
    tiles, at most ``MMA_MAX_ROWS`` (g = 71: a tile of 64 rows and one of
    7). The source's ``mma_tile_rows``."""
    return min(MMA_MAX_ROWS, -(-g // 16) * 16)


def mma_shape(rows: int, d: int) -> tuple:
    """(head dim of the kernel instance, m16 tiles a warp holds) for a row
    tile of ``rows`` at head dim d: 64, 128 or 256; two m16 tiles where d
    <= 128 and the tile has 32 rows or more, else one. The source's
    ``mma_shape``; its launch switch has an instance for each pair."""
    dinst = 64 if d <= 64 else 128 if d <= 128 else 256
    return dinst, 2 if dinst <= 128 and rows >= 32 else 1


def mma_row_groups(rows: int, mw: int) -> int:
    """Row groups of a tile with ``rows`` live rows and ``mw`` m16 tiles a
    warp: ceil(rows / (16 mw)) rounded up to 1, 2 or 4. The four consumer
    warps are row groups x key groups (the source's ``mma_row_groups``)."""
    n16 = -(-rows // 16)
    n = -(-n16 // mw)
    return 4 if n > 2 else n


def group_tile_rows(g: int, d: int, elt: int) -> int:
    """The ``tile_rows`` argument of the kernel's C entry, which also picks
    the route: ``mma_tile_rows`` (more than ``MAX_TILE_ROWS``) on the mma
    route, else ``tile_rows``."""
    return mma_tile_rows(g) if mma_route(g, d, elt) else tile_rows(g, d, elt)


def _bulk_copies(k_pages: torch.Tensor, v_pages: torch.Tensor) -> bool:
    """Whether the kernel fills its ring stages from these pools by bulk
    copies (both bases and the row width multiples of 16 bytes) rather than
    by the producer warp's 2-byte loads."""
    row = k_pages.shape[-1] * k_pages.element_size()
    return (k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0
            and row % 16 == 0)


def sm90_plan(g: int, d: int, page: int, dtype: torch.dtype,
              rows: Optional[int] = None) -> Optional[dict]:
    """The kernel's plan for a shape: its route ("mma", "registers", or
    "wide" past d = 2048), query rows per tile and tiles, output slices
    and CTAs a cluster (1 off the wide route), 16-byte vectors of a row per
    lane (0 on the mma and wide routes), keys per ring stage (the wide
    route: per chunk), ring stages, dynamic shared memory bytes and m16
    tiles a warp (the mma route; else 0). ``rows``
    (None: ``group_tile_rows``) asks for another route's tile, e.g.
    ``mma_tile_rows(g)`` at g <= 8. ``source_mma_route`` is the kernel
    source's own route rule for (g, d, dtype), which must equal
    ``mma_route``. None where the kernel does not take the shape (builds
    the kernel; needs the CUDA toolkit)."""
    from repro_torch.kernels import _build
    elt = torch.empty((), dtype=dtype).element_size()
    rows = rows or group_tile_rows(g, d, elt)
    lib = _build.load("paged_attention_sm90")
    vals = [ctypes.c_int() for _ in range(5)]
    ok = lib.paged_attention_sm90_plan(
        ctypes.c_int(rows), ctypes.c_int(g), ctypes.c_int(d),
        ctypes.c_int(page), ctypes.c_int(_DTYPE_CODE[dtype]),
        *(ctypes.byref(x) for x in vals))
    if not ok:
        return None
    return {"route": {1: "registers", 2: "wide", 3: "mma"}[ok],
            "tile_rows": rows, "tiles": -(-g // rows),
            "slices": n_slices(d, elt),
            "cluster": wide_plan(d)[1] if ok == 2 else 1,
            **dict(zip(("vectors_per_lane", "keys_per_stage", "stages",
                        "smem_bytes", "warp_m16"), (x.value for x in vals))),
            "source_mma_route": bool(lib.paged_attention_sm90_mma_route(
                ctypes.c_int(g), ctypes.c_int(d),
                ctypes.c_int(_DTYPE_CODE[dtype])))}


def wide_clusters(rows: int, d: int, dtype: torch.dtype,
                  device: int = 0) -> dict:
    """The wide route for ``rows`` query rows a tile at head dim d > 2048
    on ``device``: CTAs a cluster and the most such clusters the card holds
    at once (``cudaOccupancyMaxActiveClusters``; builds the kernel)."""
    from repro_torch.kernels import _build
    lib = _build.load("paged_attention_sm90")
    vals = [ctypes.c_int() for _ in range(2)]
    err = lib.paged_attention_sm90_wide_clusters(
        ctypes.c_int(rows), ctypes.c_int(d),
        ctypes.c_int(_DTYPE_CODE[dtype]), ctypes.c_int(device),
        *(ctypes.byref(x) for x in vals))
    if err:
        raise RuntimeError(f"paged_attention: cluster occupancy query "
                           f"failed with CUDA error {err}")
    return {"cluster": vals[0].value, "max_active_clusters": vals[1].value}


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
                        f"(float32, bfloat16, float16)")
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


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor, *,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Hq, d); pages: (P, Hkv, page, d) of q's dtype (float32,
    bfloat16 or float16); page_table: (B, n_slots) int32; lengths: (B,)
    int32.

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
    out = _run_sm90(q, k_pages, v_pages, page_table, lengths, softcap)
    paged_attention.launches += 1
    if mma_route(q.shape[1] // k_pages.shape[1], q.shape[2],
                 q.element_size()):
        paged_attention.launches_mma += 1
    return out


def _run_sm90(q, k_pages, v_pages, page_table, lengths, softcap,
              pages_per_split=None, launcher=None, rows=None):
    """Launches ``csrc/paged_attention_sm90.cu`` on checked CUDA inputs
    (B >= 1) and returns the output; ``pages_per_split`` (None:
    ``_pages_per_split``'s choice) lets a measurement pick the split,
    ``launcher`` another build's C entry of the same signature, and
    ``rows`` (None: ``group_tile_rows``) another route's tile rows, e.g.
    ``tile_rows`` for a build that has no mma route."""
    B, Hq, d = q.shape
    P, Hkv, page, _ = k_pages.shape
    n_slots = page_table.shape[1]
    rows = rows or group_tile_rows(Hq // Hkv, d, q.element_size())
    out = torch.empty_like(q)
    dev = q.device.index
    pps = pages_per_split or _pages_per_split(
        B, Hkv * -(-(Hq // Hkv) // rows) * n_slices(d, q.element_size()),
        n_slots, _sm_count(dev))
    n_split = -(-n_slots // pps)
    ws = (torch.empty((B, Hq, n_split, d + 2), dtype=torch.float32,
                      device=q.device) if n_split > 1 else None)
    err = (launcher or _launcher_sm90())(
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
paged_attention.launches_mma = 0
