"""Public wrapper of blocked (flash) attention.

A CPU tensor goes to the plain version (``ref.py``). A CUDA tensor goes to
one of two hand-written kernels, chosen by dtype, or the call raises:

* bfloat16 and float16 -> ``csrc/flash_attention_sm90.cu``: wgmma products
  fed by TMA where its layout rule holds (``_sm90_layout_ok``), else by the
  producer warpgroup's own loads (``_sm90_unit``: the aligned 16-byte words
  of a row realigned in registers, whole rows where they fit, else half
  rows, at every unit);
* float32 -> ``csrc/flash_attention_f32_sm90.cu``: every product as three
  TF32 tensor-core products (3xTF32: the float32 tolerance rules out a
  single TF32 product, not the split one).

Both take any head_dim, any sequence length and any layout whose last
dimension is contiguous: a block's batch x head is the grid's x, and its
(q tile, slice) one index spread over the grid's y and z (``flash_grid``,
``flash_block``), so the grid's 65,535 blocks a dimension bound no q
length. Past d = 256 both kernels cut d into slices taken by the CTAs of a
thread-block cluster, which sum their partial S over distributed shared
memory, so S is computed once per cluster: the 2-byte kernel in slices of
``SLICE_COLS`` columns, one cluster of up to ``SM90_CLUSTER_MAX`` CTAs
(``sm90_wide_plan``; past that reach it streams q and K for every slice,
``sm90_route``), the float32 kernel in slices of ``f32_wide_cols`` (128
columns, or 256 where only then one cluster covers d) in clusters of up to
``CLUSTER_MAX`` (``f32_wide_plan``).

``flash_attention.launches`` counts the launches of both kernels,
``flash_attention.launches_bf16`` and ``flash_attention.launches_f16`` those
of the 2-byte kernel by type.

The kernels take strides, so q, k, v and the output may be views (the
model's ``(B, S, H, d) -> (B, H, S, d)`` transposes) as long as the last
dimension is contiguous. The output has q's layout.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.flash_attention.ref import attention_ref

# the source of each route's kernel, by dtype (csrc/<name>.cu)
SOURCES = {torch.float32: "flash_attention_f32_sm90",
           torch.bfloat16: "flash_attention_sm90",
           torch.float16: "flash_attention_sm90"}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
SLICE_COLS = 256        # the 2-byte route's columns per CTA past d = 256
SM90_CLUSTER_MAX = 16   # the 2-byte route's CTAs a cluster (9-16 non-portable)
F32_WIDE_COLS = 128     # the float32 route's columns per CTA past d = 256
CLUSTER_MAX = 8         # the float32 route's CTAs a cluster (portable)
GRID_YZ = 65535         # blocks the grid's y (and z) dimension holds


@functools.cache
def _launcher(dtype: torch.dtype):
    """The C entry of ``dtype``'s kernel; both take the same arguments."""
    from repro_torch.kernels import _build
    name = SOURCES[dtype]
    fn = getattr(_build.load(name), f"{name}_launch")
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
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


def f32_wide_cols(d: int) -> int:
    """The float32 route's slice width past d = 256: ``F32_WIDE_COLS``, or
    twice that where then one cluster of ``CLUSTER_MAX`` CTAs covers d and
    otherwise would not (1024 < d <= 2048: there the 128-column slices take
    groups of clusters that stage q and K for every key tile, 2.89x slower
    at d = 1280; past 2048 both take groups, and 128 ran 1.89x faster at d
    = 2304; an H100 at 700 W, benchmarks_torch/wide_variants.py). The
    source's ``wide_cols``."""
    reach = F32_WIDE_COLS * CLUSTER_MAX
    return 2 * F32_WIDE_COLS if reach < d <= 2 * reach else F32_WIDE_COLS


def q_rows_per_block(dtype: torch.dtype, d: int) -> int:
    """A block's q rows, as ``kernel_config`` gives them: 128, or 64 on the
    float32 route at 128 < d <= 256; past d = 256 the float32 CTA's at its
    slice width (``f32_wide_cols``: 128 rows at 128 columns, 64 at 256)."""
    if dtype != torch.float32 or d <= 128:
        return 128
    return 128 if d > 256 and f32_wide_cols(d) == 128 else 64


def f32_wide_plan(d: int, cols: Optional[int] = None,
                  cluster: int = CLUSTER_MAX) -> tuple:
    """The float32 route past d = 256: (slices of ``cols`` columns (None:
    ``f32_wide_cols``), CTAs a cluster, slices with the last group's
    padding). A cluster holds at most ``cluster`` CTAs; past that the
    slices go in groups of one cluster each, the last padded to a whole
    cluster with CTAs that own no column (the source's ``wide_plan``)."""
    cols = cols or f32_wide_cols(d)
    n_sl = -(-d // cols)
    ncl = min(n_sl, cluster)
    return n_sl, ncl, -(-n_sl // ncl) * ncl


def sm90_route(d: int) -> str:
    """The 2-byte kernel's route at head dim ``d``: "plain" (d <= 256, one
    CTA), "cluster" (past it, one cluster of ``SLICE_COLS``-column slices,
    up to ``SM90_CLUSTER_MAX`` of them) or "stream" (past that reach: each
    CTA streams q and K over d for its own output slice; the source's
    ``route_of``)."""
    if d <= SLICE_COLS:
        return "plain"
    return "cluster" if d <= SLICE_COLS * SM90_CLUSTER_MAX else "stream"


def sm90_wide_plan(d: int) -> dict:
    """The 2-byte kernel past d = 256: its route, columns per CTA, slices
    and CTAs a cluster (the slices on the cluster route, where each CTA
    owns one and S is summed once over all; 1 on the streaming route,
    where each CTA recomputes S for its slice)."""
    n_sl = -(-d // SLICE_COLS)
    route = sm90_route(d)
    return {"route": route, "cols": SLICE_COLS, "slices": n_sl,
            "cluster": n_sl if route == "cluster" else 1}


def flash_cluster(dtype: torch.dtype, d: int) -> int:
    """CTAs a cluster along the grid's y: the float32 route's past d = 256,
    the 2-byte route's past d = 256 up to its cluster's reach, else 1."""
    if d <= 256:
        return 1
    if dtype == torch.float32:
        return f32_wide_plan(d)[1]
    return sm90_wide_plan(d)["cluster"]


def flash_grid(dtype: torch.dtype, B: int, Hq: int, Sq: int,
               d: int) -> tuple:
    """Both kernels' grid (x, y, z) for these shapes, and its q tiles (of
    ``q_rows_per_block`` rows) and slices: x = B * Hq; y and z hold the
    n_qt * slices (tile, slice) indices over y + ny * z, ny = that up to
    ``GRID_YZ``, else ``GRID_YZ`` rounded down to a multiple of the cluster
    (``flash_cluster``), so the cluster dims (1, cluster, 1) divide the
    grid (the sources' ``grid_of``). Slices: ``SLICE_COLS`` columns past d
    = 256 on the 2-byte route (a whole cluster, unpadded);
    ``f32_wide_plan``'s padded slices on the float32 route."""
    n_qt = -(-Sq // q_rows_per_block(dtype, d))
    if dtype == torch.float32:
        n_sl = f32_wide_plan(d)[2] if d > 256 else 1
    else:
        n_sl = -(-d // SLICE_COLS) if d > SLICE_COLS else 1
    step = flash_cluster(dtype, d)
    n = n_qt * n_sl
    ny = n if n <= GRID_YZ else GRID_YZ - GRID_YZ % step
    return (B * Hq, ny, -(-n // ny)), n_qt, n_sl


def flash_block(x: int, y: int, z: int, ny: int, n_qt: int,
                n_sl: int, cluster: int = 1) -> Optional[tuple]:
    """The (b * Hq + h, q tile, slice) of block (x, y, z), as the kernels
    decode it, or None for a block past the last index (the grid's
    rounding; it exits at once). lin = y + ny * z; index t holds q tile
    n_qt - 1 - t. Without a cluster (``cluster`` 1: d <= 256 and the 2-byte
    streaming route) lin = t + n_qt * slice; in clusters (both routes past
    d = 256, ``flash_cluster``) lin = slice + n_sl * t, so a cluster's CTAs
    (``cluster`` consecutive y) are consecutive slices of one q tile, and a
    CTA's rank in it is its slice % cluster. A (x, y, z) grid runs x
    fastest, then y and z: the heaviest causal tiles first."""
    lin = y + ny * z
    if lin >= n_qt * n_sl:
        return None
    if cluster > 1:
        return x, n_qt - 1 - lin // n_sl, lin % n_sl
    return x, n_qt - 1 - lin % n_qt, lin // n_qt


def _clusters(dtype: torch.dtype, d: int, device: int, keys) -> dict:
    from repro_torch.kernels import _build
    name = SOURCES[dtype]
    vals = [ctypes.c_int() for _ in range(3)]
    err = getattr(_build.load(name), f"{name}_clusters")(
        ctypes.c_int(d), ctypes.c_int(device),
        *(ctypes.byref(x) for x in vals))
    if err:
        raise RuntimeError(f"flash_attention: cluster occupancy query failed "
                           f"with CUDA error {err}")
    return dict(zip(keys, (x.value for x in vals)))


def f32_clusters(d: int, device: int = 0) -> dict:
    """The float32 route at d > 256 on ``device``: its slice width, CTAs a
    cluster, and the most such clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``; builds the kernel)."""
    return _clusters(torch.float32, d, device,
                     ("cols", "cluster", "max_active_clusters"))


def sm90_clusters(d: int, device: int = 0) -> dict:
    """The 2-byte route at head dim ``d`` on ``device``: its route (0
    plain, 1 cluster, 2 stream, as ``sm90_route``), CTAs a cluster, and on
    the cluster route the most such clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``, else 0; builds the kernel)."""
    return _clusters(torch.bfloat16, d, device,
                     ("route", "cluster", "max_active_clusters"))


def _aligned(t: torch.Tensor, unit: int) -> bool:
    """The base and the stride of every non-innermost dimension longer than
    1 are multiples of ``unit`` bytes."""
    return t.data_ptr() % unit == 0 and all(
        n <= 1 or (st * t.element_size()) % unit == 0
        for n, st in zip(t.shape[:-1], t.stride()[:-1]))


def _sm90_layout_ok(t: torch.Tensor) -> bool:
    """TMA's rule for a 2-byte operand: a 16-byte aligned base, and the
    stride of every non-innermost dimension longer than 1 a multiple of 16
    bytes (8 elements)."""
    return _aligned(t, 16)


def _sm90_unit(q, k, v) -> int:
    """How a kernel reads q, k and v, in bytes per copy (the C entries'
    ``unit``). 2-byte types: 16 where TMA reads all three
    (``_sm90_layout_ok``); else the widest of 8, 4 and 2 bytes that every
    base, every stride of a dimension longer than 1 and a row of d
    elements are multiples of, for the producer warpgroup's own loads.
    float32: 16 where k's and v's rows may be copied 16 bytes at a time,
    else 4."""
    if q.dtype == torch.float32:
        return 16 if _aligned(k, 16) and _aligned(v, 16) else 4
    if all(_sm90_layout_ok(t) for t in (q, k, v)):
        return 16
    row = q.shape[-1] * q.element_size()
    return next(u for u in (8, 4, 2)
                if row % u == 0 and all(_aligned(t, u) for t in (q, k, v)))


def _check(q, k, v, window) -> None:
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"q on {q.device}")
    if q.dtype not in SOURCES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported "
                        f"(float32, bfloat16, float16)")
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


def _launch_args(q, k, v, out, *, causal, window, softcap) -> tuple:
    """The C entry's arguments up to the device and stream, and the strides
    array they point to (the caller keeps it alive through the call)."""
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    return strides, (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), ctypes.addressof(strides), B, Hq, Hkv,
                     Sq, Sk, d, int(causal), window, 1.0 / math.sqrt(d),
                     float(softcap), _DTYPE_CODE[q.dtype],
                     _sm90_unit(q, k, v))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Hq, Sq, d); k/v: (B, Hkv, Sk, d), one dtype (float32,
    bfloat16 or float16). Returns (B, Hq, Sq, d). See ``ref.py`` for the
    semantics. Raises where a gradient is needed (``refuse_grad``)."""
    refuse_grad("flash_attention", q, k, v)
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    out = torch.empty_like(q)       # q's strides where q is dense
    if out.numel() == 0:
        return out
    strides, args = _launch_args(q, k, v, out, causal=causal, window=window,
                                 softcap=softcap)
    err = _launcher(q.dtype)(*args, q.device.index,
                             torch.cuda.current_stream(q.device).cuda_stream)
    if err < 0:
        raise RuntimeError(f"flash_attention: TMA tensor map encoding "
                           f"failed with CUresult {-err}")
    if err:
        raise RuntimeError(f"flash_attention: kernel launch failed with "
                           f"CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.launches_bf16 += q.dtype == torch.bfloat16
    flash_attention.launches_f16 += q.dtype == torch.float16
    return out


flash_attention.launches = 0
flash_attention.launches_bf16 = 0
flash_attention.launches_f16 = 0
