"""Public wrapper of the chunkwise-parallel mLSTM scan.

A CUDA tensor goes to the hand-written kernel ``csrc/mlstm_scan_sm90.cu``
(three passes: the gate scalars, the state entering each chunk, the outputs;
3xTF32 tensor-core products), or the call raises; a CPU tensor goes to the
plain version (``ref.py``). The kernel takes every shape the wrapper
accepts up to chunk ``MAX_CHUNK`` and dh ``MAX_HEAD_DIM`` (``_check_kernel``,
on the CUDA branch only). ``mlstm_scan.launches`` counts the calls that
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

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 512      # 8 warps x 8 n tiles of output columns
MAX_CHUNK = 256         # one scalar-pass thread per chunk row
OUTPUT_TILES = (1, 2, 4, 6, 8)  # output n tiles per warp: 64 x this >= dh
MAX_SMEM = 232448       # dynamic shared memory one block may have on sm_90
# as in the source: the states pass's slice, rows and stages; the output
# block's rows, slice and stages
KS, STATE_ROWS, STATE_STAGES = 32, 64, 3
ROWS, OUT_KS, OUT_STAGES, OUT_THREADS = 64, 32, 2, 512


def plan(S: int, dh: int, chunk: int) -> dict:
    """The kernel's tiling for an accepted shape: ``nt`` output n tiles per
    warp (the output block holds 64 x ``dhp`` = 64 nt columns), ``bn`` the
    state block's columns (96 at dhp = 384: 768 blocks at xLSTM-125m's
    layer shape, three resident on each SM, fill two whole waves), the
    dynamic shared memory of the state and output passes, and the number
    of chunks. The source checks it."""
    nt = next(n for n in OUTPUT_TILES if 64 * n >= dh)
    dhp = 64 * nt
    bn = 96 if dhp == 384 else 128 if dhp >= 256 else 64
    lp = -(-chunk // 64) * 64           # keys a row tile can see, rounded up
    stage = max(ROWS * (OUT_KS + 4) + lp * (OUT_KS + 4),
                ROWS * (OUT_KS + 4) + OUT_KS * (dhp + 8) + OUT_KS)
    return {"nt": nt, "dhp": dhp, "bn": bn, "n_chunks": S // chunk,
            "row_tiles": -(-chunk // ROWS),
            "smem_states": 4 * STATE_STAGES * (KS * (STATE_ROWS + 8)
                                               + KS * (bn + 8) + KS),
            "smem_outputs": 4 * (OUT_STAGES * stage + ROWS * (lp + 4)
                                 + 3 * ROWS + 2 * lp
                                 + OUT_THREADS // 64 * ROWS + ROWS)}


@functools.cache
def _launcher():
    from repro_torch.kernels import _build
    fn = _build.load("mlstm_scan_sm90").mlstm_scan_sm90_launch
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                   + [ctypes.c_float] + [ctypes.c_int] * 3
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if dh > 1 and t.stride(-1) != 1:
            raise ValueError(f"mlstm_scan: {name} must be contiguous in its "
                             f"last dimension")
    return chunk


def _check_kernel(chunk: int, dh: int) -> None:
    """What only the card's kernel cannot take, checked before a launch
    (the plain version computes it): chunk past ``MAX_CHUNK`` or dh past
    ``MAX_HEAD_DIM``."""
    if chunk > MAX_CHUNK or dh > MAX_HEAD_DIM:
        raise ValueError(f"mlstm_scan: chunk={chunk}, dh={dh}; the kernel "
                         f"takes chunk <= {MAX_CHUNK} and dh <= "
                         f"{MAX_HEAD_DIM}")


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lf: torch.Tensor, li: torch.Tensor, *,
               chunk: int = 128) -> torch.Tensor:
    """q, k, v: (B, H, S, dh), float32 or bfloat16; lf, li: (B, H, S)
    float32 log-forget and log-input gates. The scan starts from a zero
    state. Returns h (B, H, S, dh) in q's dtype; see ``ref.py``. Raises
    where a gradient is needed (``refuse_grad``)."""
    refuse_grad("mlstm_scan", q, k, v, lf, li)
    chunk = _check(q, k, v, lf, li, chunk)
    if q.device.type == "cpu":
        return mlstm_scan_ref(q, k, v, lf, li, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_scan: no kernel for {q.device}")
    _check_kernel(chunk, q.shape[3])
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


def _run_sm90(q, k, v, lf, li, chunk, *, ws=None, out=None, passes=7):
    """Launches ``csrc/mlstm_scan_sm90.cu`` on checked, non-empty CUDA
    inputs and returns the output. A measurement may pass the workspace
    and output of an earlier call and a mask of the passes to run (1 the
    scalars, 2 the states, 4 the outputs)."""
    B, H, S, dh = q.shape
    p = plan(S, dh, chunk)
    ws = ws or workspace(B, H, S, dh, chunk, q.device)
    if out is None:
        out = torch.empty((B, H, S, dh), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 15)(
        *(s for t in (q, k, v, lf, li) for s in t.stride()[:3]))
    err = _launcher()(
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
