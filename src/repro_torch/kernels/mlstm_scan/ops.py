"""Public wrapper of the chunkwise-parallel mLSTM scan.

A CUDA tensor goes to the hand-written kernel ``csrc/mlstm_scan_sm90.cu``
(three passes: the gate scalars, the state entering each chunk, the outputs;
3xTF32 tensor-core products), or the call raises; a CPU tensor goes to the
plain version (``ref.py``). The kernel takes every shape the wrapper
accepts: past chunk ``BLOCK_CHUNK`` or dh ``BLOCK_DH`` (what one block of
its scalar and outputs passes covers) the outputs pass runs in
thread-block clusters whose CTAs split the output columns and take q.k^T
once between them, the chunk's keys in slices of ``CLUSTER_KEYS``
(``plan``'s ``sliced``). ``mlstm_scan.launches`` counts the calls that
launched it.

The kernel takes (batch, head, seq) strides, so q, k, v, lf and li may be
views as long as the last dimension of q, k and v is contiguous. The output
is a new contiguous (B, H, S, dh) tensor in q's dtype; the float32 workspace
(gate scalars, and the states entering chunks 1 .. S/chunk - 1, B H dh^2
floats each) is allocated per call.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
BLOCK_DH = 512          # one outputs block's columns: 8 warps x 8 n tiles
BLOCK_CHUNK = 256       # one scalar block's rows, one P tile's keys
OUTPUT_TILES = (1, 2, 4, 6, 8)  # output n tiles per warp: 64 x this >= dh
CLUSTER_TILES = (1, 2, 4, 6, 8)  # the cluster pass's: 64 x this columns
MAX_CLUSTER = 8         # CTAs a cluster (the portable limit)
FRESH_DH = 1280         # past it a cluster CTA holds 256 columns at most and
FRESH_TILES = 4         # (at this many n tiles or fewer) adds each 32-wide
                        # slice of q.C_prev's products in fresh accumulators
CLUSTER_KEYS = 128      # the cluster pass's key slice (one P tile)
MAX_SMEM = 232448       # dynamic shared memory one block may have on sm_90
# as in the source: the states pass's slice, rows and stages; the output
# block's rows, slice and stages
KS, STATE_ROWS, STATE_STAGES = 32, 64, 3
ROWS, OUT_KS, OUT_STAGES, OUT_THREADS = 64, 32, 2, 512
S_KS = 64               # the cluster pass's S jobs: contraction per stage


def plan(S: int, dh: int, chunk: int) -> dict:
    """The kernel's tiling for an accepted shape: ``nt`` output n tiles per
    warp, ``dhp`` the states' row stride (64 nt, or dh rounded up to 128
    past ``BLOCK_DH``), ``bn`` the state block's columns (96 at dhp = 384:
    768 blocks at xLSTM-125m's layer shape, three resident on each SM, fill
    two whole waves), ``lp`` the keys of a P tile, the dynamic shared memory
    of the state and output passes, and the number of chunks. Inside both
    limits an outputs block holds all 64 nt columns. Past chunk
    ``BLOCK_CHUNK`` or dh ``BLOCK_DH`` (``sliced``) the outputs pass runs in
    thread-block clusters of ``cluster`` CTAs (one per ``BLOCK_DH`` columns,
    or past dh ``FRESH_DH`` one per 256, at most ``MAX_CLUSTER``; past that
    ``ctas`` CTAs a row tile in groups of ``cluster``, each group taking S
    anew): the CTAs share dh's 8-column
    units evenly, ``cols`` columns at most, 8 column warps of ``nt`` unit
    tiles each (``nt`` from ``CLUSTER_TILES``; 1 only at dh <= 64, where a
    CTA splits its row tile's q once for every job), so no CTA computes
    more than ``padded`` columns past dh; each rank takes S over its share
    of dh's
    units (``cluster_columns(dh, cluster)``), and the keys go in
    ``key_slices`` slices of ``CLUSTER_KEYS``. The source's ``make_plan``
    is the same rule and checks it."""
    sliced = dh > BLOCK_DH or chunk > BLOCK_CHUNK
    least = next((n for n in OUTPUT_TILES if 64 * n >= dh), OUTPUT_TILES[-1])
    dhp = -(-dh // 128) * 128 if dh > BLOCK_DH else 64 * least
    bn = 96 if dhp == 384 else 128 if dhp >= 256 else 64
    p = {"dhp": dhp, "bn": bn, "n_chunks": S // chunk,
         "row_tiles": -(-chunk // ROWS), "sliced": sliced,
         "smem_states": 4 * STATE_STAGES * (KS * (STATE_ROWS + 8)
                                            + KS * (bn + 8) + KS)}
    if not sliced:
        lp = -(-chunk // 64) * 64                    # keys of a P tile
        return {**p, "nt": least, "lp": lp,
                "smem_outputs": outputs_smem(64 * least, lp)}
    ctas = -(-dh // (64 * FRESH_TILES if dh > FRESH_DH else BLOCK_DH))
    cluster = min(ctas, MAX_CLUSTER)
    ctas = -(-ctas // cluster) * cluster
    units = -(-dh // 8)
    col_warps = OUT_THREADS // 64
    nt = -(-(-(-units // ctas)) // col_warps)
    if nt > 1:
        nt += nt % 2                   # 1 (dh <= 64), 2, 4, 6 or 8
    return {**p, "nt": nt, "lp": CLUSTER_KEYS, "cluster": cluster,
            "ctas": ctas, "groups": ctas // cluster,
            "cols": 8 * -(-units // ctas), "padded": 8 * units - dh,
            "key_slices": -(-chunk // CLUSTER_KEYS),
            "smem_outputs": cluster_smem(nt)}


def cluster_stage(nt: int, vd: int = 0) -> int:
    """The floats of one stage of the cluster pass's CTA of 64 nt columns:
    a C slice (and n), q and k raw, or vd v rows (by default the whole key
    slice at nt <= 2, 64 at nt <= 4, else 32)."""
    vd = vd or (CLUSTER_KEYS if nt <= 2 else 64 if nt <= 4 else 32)
    return max(OUT_KS * (64 * nt + 8) + OUT_KS,
               (ROWS + CLUSTER_KEYS) * (S_KS + 4), vd * (64 * nt + 8))


def cluster_smem(nt: int) -> int:
    """The dynamic shared memory of the cluster outputs pass's CTA of 64 nt
    columns (the source's cluster_smem_bytes): two stages of C, v, or q and
    k slices (v up to 128 keys deep, ``cluster_stage``), q's (a 32-wide
    slice, or at nt = 1 all 64 columns) and P's hi and lo, the rows' and
    keys' scalars."""
    return 4 * (OUT_STAGES * cluster_stage(nt)
                + 2 * ROWS * (64 if nt == 1 else OUT_KS)
                + 2 * ROWS * CLUSTER_KEYS + 4 * ROWS + 2 * CLUSTER_KEYS
                + OUT_THREADS // 64 * ROWS + 4 * ROWS)


def outputs_smem(width: int, lp: int) -> int:
    """The dynamic shared memory of the in-limit outputs block of ``width``
    columns and P tiles of ``lp`` keys (the source's outputs_smem_bytes)."""
    stage = max(ROWS * (OUT_KS + 4) + lp * (OUT_KS + 4),
                ROWS * (OUT_KS + 4) + OUT_KS * (width + 8) + OUT_KS)
    return 4 * (OUT_STAGES * stage + ROWS * (lp + 4) + 3 * ROWS + 2 * lp
                + OUT_THREADS // 64 * ROWS + ROWS)


def cluster_columns(dh: int, ctas: int) -> list:
    """The cluster pass's split of dh among the ``ctas`` CTAs of a row tile
    (or of S among the ranks of a cluster): [start, end) columns, dh's
    8-column units shared evenly, the earlier CTAs one unit more."""
    units = -(-dh // 8)
    each, extra = divmod(units, ctas)
    starts = [8 * (r * each + min(r, extra)) for r in range(ctas + 1)]
    return [(starts[r], min(dh, starts[r + 1])) for r in range(ctas)]


# the C entry's arguments (csrc/mlstm_scan_sm90.cu)
LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])


@functools.cache
def _launcher():
    from repro_torch.kernels import _build
    fn = _build.load("mlstm_scan_sm90").mlstm_scan_sm90_launch
    fn.argtypes = LAUNCH_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def clusters(dh: int, chunk: int, device=None) -> dict:
    """The cluster outputs pass at (dh, chunk) past one block's reach, on
    the card: CTAs a cluster, CTAs a row tile, n tiles per warp, and the
    most such clusters the card holds at once
    (cudaOccupancyMaxActiveClusters)."""
    from repro_torch.kernels import _build
    vals = [ctypes.c_int() for _ in range(4)]
    dev = torch.device("cuda" if device is None else device)
    err = _build.load("mlstm_scan_sm90").mlstm_scan_sm90_clusters(
        ctypes.c_int(dh), ctypes.c_int(chunk),
        ctypes.c_int(torch.cuda.current_device() if dev.index is None
                     else dev.index), *(ctypes.byref(v) for v in vals))
    if err:
        raise RuntimeError(f"mlstm_scan: cluster query failed with CUDA "
                           f"error {err}")
    return dict(zip(("cluster", "ctas", "nt", "max_active_clusters"),
                    (v.value for v in vals)))


def _check(q, k, v, lf, li, chunk) -> int:
    """Validates the inputs; returns the chunk length the scan uses."""
    for name, t in (("k", k), ("v", v), ("lf", lf), ("li", li)):
        if t.device != q.device:
            raise ValueError(f"mlstm_scan: {name} on {t.device}, q on "
                             f"{q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"mlstm_scan: dtype {q.dtype} not supported "
                        f"(float32, bfloat16, float16)")
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if dh > 1 and t.stride(-1) != 1:
            raise ValueError(f"mlstm_scan: {name} must be contiguous in its "
                             f"last dimension")
    return chunk


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lf: torch.Tensor, li: torch.Tensor, *,
               chunk: int = 128) -> torch.Tensor:
    """q, k, v: (B, H, S, dh), float32, bfloat16 or float16; lf, li: (B,
    H, S) float32 log-forget and log-input gates. The scan starts from a
    zero state. Returns h (B, H, S, dh) in q's dtype; see ``ref.py``. Raises
    where a gradient is needed (``refuse_grad``)."""
    refuse_grad("mlstm_scan", q, k, v, lf, li)
    chunk = _check(q, k, v, lf, li, chunk)
    if q.device.type == "cpu":
        return mlstm_scan_ref(q, k, v, lf, li, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_scan: no kernel for {q.device}")
    if q.numel() == 0:
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    out = _run_sm90(q, k, v, lf, li, chunk)
    mlstm_scan.launches += 1
    return out


def workspace(B: int, H: int, S: int, dh: int, chunk: int,
              device) -> tuple:
    """The kernel's float32 workspace: (scalars per position (4, B H, S),
    per chunk (3, B H, S/chunk + 1), n states (B H, S/chunk - 1, dhp), C
    states (B H, S/chunk - 1, dh, dhp)); the two states are None for a
    single chunk."""
    p = plan(S, dh, chunk)
    nc, BH = p["n_chunks"], B * H
    f32 = dict(dtype=torch.float32, device=device)
    states = ((torch.empty((BH, nc - 1, p["dhp"]), **f32),
               torch.empty((BH, nc - 1, dh, p["dhp"]), **f32))
              if nc > 1 else (None, None))
    return (torch.empty((4, BH, S), **f32),
            torch.empty((3, BH, nc + 1), **f32), *states)


def _run_sm90(q, k, v, lf, li, chunk, *, ws=None, out=None, passes=7,
              build=None):
    """Launches ``csrc/mlstm_scan_sm90.cu`` on checked, non-empty CUDA
    inputs and returns the output. A measurement may pass the workspace
    and output of an earlier call, a mask of the passes to run (1 the
    scalars, 2 the states, 4 the outputs), and another build as
    ``(C entry of the same signature, its plan(S, dh, chunk))``."""
    B, H, S, dh = q.shape
    launcher, tiling = build or (_launcher(), plan)
    p = tiling(S, dh, chunk)
    ws = ws or workspace(B, H, S, dh, chunk, q.device)
    if out is None:
        out = torch.empty((B, H, S, dh), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 15)(
        *(s for t in (q, k, v, lf, li) for s in t.stride()[:3]))
    err = launcher(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lf.data_ptr(),
        li.data_ptr(), out.data_ptr(), ctypes.addressof(strides),
        *(None if t is None else t.data_ptr() for t in ws), B, H, S, dh,
        chunk, p["nt"], p["bn"], p["smem_states"], p["smem_outputs"],
        dh ** -0.5, _DTYPE_CODE[q.dtype], passes, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"mlstm_scan: kernel launch failed with CUDA "
                           f"error {err}")
    return out


mlstm_scan.launches = 0
