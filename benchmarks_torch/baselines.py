"""Earlier kernels, built from another checkout, as yardsticks.

Three CUDA-core kernels the port has replaced are no longer in this tree:

* K3's ``csrc/mlstm_scan.cu`` (last in commit df97d3b's parent): one
  block per (batch x head, 64 value columns), the chunks in order inside
  it; replaced by ``csrc/mlstm_scan_sm90.cu``;
* K2's ``csrc/flash_attention.cu`` (last in commit 2142486): float32
  attention on the CUDA cores, one block per (batch x head, 64 q rows);
  replaced on the float32 route by ``csrc/flash_attention_f32_sm90.cu``;
* K1's ``csrc/paged_attention.cu`` (last in commit 8d1f884): paged decode
  attention on the CUDA cores, one block per (kv head, sequence), g <= 8
  and d <= 256; replaced for every shape by ``csrc/paged_attention_sm90.cu``.

The four sm90 sources of commit ff92dab (``flash_attention_sm90.cu``,
``flash_attention_f32_sm90.cu``, ``paged_attention_sm90.cu``,
``mlstm_scan_sm90.cu``, before the grid folds, K1's wide route and K3's
sliced routes) are the yardsticks of the shapes that ran before them:
those shapes must keep their times. Commit 9676424's
``paged_attention_sm90.cu`` (K1 before its mma route, g >= 8 at d <= 256 on
the CUDA cores) is the yardstick of K1's routes in the same way; unpack it
in place of ff92dab's. Commit 076818b's four sm90 sources (before the
cluster routes: K2's float32 route past d = 256 and K1's wide route past d
= 2048 recomputing the scores per output slice) are the yardsticks of
those two routes, and of every route that kept its code since; unpack them
in place of ff92dab's. Their C entries take the arguments the current
wrappers pass (K1's with the register route's group tiles, or with the
mma route's where the source has that route).

To time them beside the current kernels on one card, unpack commits that
have them with ``git archive`` into one git-ignored directory and pass it,
e.g.

  mkdir -p build/base
  git archive df97d3b^ src/repro_torch/csrc/mlstm_scan.cu | tar -x -C build/base
  git archive 2142486 src/repro_torch/csrc/flash_attention.cu | tar -x -C build/base
  git archive 8d1f884 src/repro_torch/csrc/paged_attention.cu | tar -x -C build/base
  git archive ff92dab src/repro_torch/csrc | tar -x -C build/base
  git archive 9676424 src/repro_torch/csrc/paged_attention_sm90.cu | tar -x -C build/base
  python3 chip_smoke.py --baseline-src build/base

or, for the routes as they stood before the cluster routes,

  mkdir -p build/base
  git archive 076818b src/repro_torch/csrc | tar -x -C build/base
  python3 chip_smoke.py --baseline-src build/base

``load(dir)`` builds every one of those sources it finds under
``dir/src/repro_torch/csrc/`` with the port's nvcc flags into
``build/kernels/`` (keyed by the source's hash; one nvcc each, all at
once) and returns, by source name, a function with the public wrapper's
signature that launches the earlier kernel on CUDA tensors it takes (K1's
CUDA-core kernel: g <= 8 and d <= 256; the sm90 sources: what they took at
their commit).
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mlstm_scan import ops as ml_ops
from repro_torch.kernels.paged_attention import ops as pa_ops

CSRC = Path("src") / "repro_torch" / "csrc"


def _libraries(srcs: Dict[str, Path],
               failed: Optional[Dict[str, str]] = None
               ) -> Dict[str, ctypes.CDLL]:
    """Each source's library, built where missing, one nvcc each, all at
    once. Raises where nvcc fails, or, given ``failed``, puts nvcc's output
    there by name and leaves that source out."""
    libs, procs = {}, {}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name, src in srcs.items():
        digest = hashlib.sha1(src.read_bytes()
                              + " ".join(_build.NVCC_FLAGS).encode())
        libs[name] = _build.BUILD_DIR / (f"{name}_baseline-"
                                         f"{digest.hexdigest()[:12]}.so")
        if not libs[name].exists():
            tmp = libs[name].with_name(f"{libs[name].name}.{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(tmp),
                 str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode and failed is not None:
            failed[name] = out
            del libs[name]
            continue
        if proc.returncode:
            raise RuntimeError(f"baselines: nvcc failed on {srcs[name]}:\n"
                               f"{out}")
        os.replace(tmp, libs[name])
    return {name: ctypes.CDLL(str(lib)) for name, lib in libs.items()}


def _check(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"baselines: {name} launch failed with CUDA error "
                           f"{err}")


def _mlstm_scan(lib: ctypes.CDLL) -> Callable[..., torch.Tensor]:
    fn = lib.mlstm_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(q, k, v, lf, li, *, chunk: int = 128) -> torch.Tensor:
        B, H, S, dh = q.shape
        chunk = min(chunk, S)
        out = torch.empty((B, H, S, dh), dtype=q.dtype, device=q.device)
        strides = (ctypes.c_longlong * 15)(
            *(s for t in (q, k, v, lf, li) for s in t.stride()[:3]))
        _check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lf.data_ptr(),
                  li.data_ptr(), out.data_ptr(), ctypes.addressof(strides), B,
                  H, S, dh, chunk, dh ** -0.5,
                  0 if q.dtype == torch.float32 else 1, q.device.index,
                  torch.cuda.current_stream(q.device).cuda_stream),
               "mlstm_scan")
        return out

    return run


def _flash_attention(lib: ctypes.CDLL) -> Callable[..., torch.Tensor]:
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(q, k, v, *, causal: bool = True, window: int = 0,
            softcap: float = 0.0) -> torch.Tensor:
        B, Hq, Sq, d = q.shape
        Hkv, Sk = k.shape[1], k.shape[2]
        out = torch.empty_like(q)
        strides = (ctypes.c_longlong * 12)(
            *(s for t in (q, k, v, out) for s in t.stride()[:3]))
        _check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  ctypes.addressof(strides), B, Hq, Hkv, Sq, Sk, d,
                  int(causal), window, 1.0 / math.sqrt(d), float(softcap),
                  0 if q.dtype == torch.float32 else 1, q.device.index,
                  torch.cuda.current_stream(q.device).cuda_stream),
               "flash_attention")
        return out

    return run


def _paged_attention(lib: ctypes.CDLL) -> Callable[..., torch.Tensor]:
    fn = lib.paged_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(q, k_pages, v_pages, page_table, lengths, *,
            softcap: float = 0.0) -> torch.Tensor:
        B, Hq, d = q.shape
        P, Hkv, page, _ = k_pages.shape
        out = torch.empty_like(q)
        _check(fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                  page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                  B, Hq, Hkv, d, page, page_table.shape[1], P,
                  1.0 / math.sqrt(d), float(softcap),
                  0 if q.dtype == torch.float32 else 1, q.device.index,
                  torch.cuda.current_stream(q.device).cuda_stream),
               "paged_attention")
        return out

    return run


def _flash_attention_sm90(name: str):
    """Commit ff92dab's two K2 sources (``name``), whose C entries take the
    arguments the current wrapper passes (``fa_ops._launch_args``)."""
    def wrap(lib: ctypes.CDLL) -> Callable[..., torch.Tensor]:
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int

        def run(q, k, v, *, causal: bool = True, window: int = 0,
                softcap: float = 0.0) -> torch.Tensor:
            out = torch.empty_like(q)
            strides, args = fa_ops._launch_args(
                q, k, v, out, causal=causal, window=window, softcap=softcap)
            _check(fn(*args, q.device.index,
                      torch.cuda.current_stream(q.device).cuda_stream), name)
            return out

        return run
    return wrap


def _paged_attention_sm90(lib: ctypes.CDLL) -> Callable[..., torch.Tensor]:
    """An earlier K1 (commit ff92dab's: d <= 2048, B and Hkv <= 65,535;
    commit 9676424's: every shape; commit 076818b's: every shape, with the
    mma route), whose C entry the wrapper's call fits with the register
    route's group tiles (``tile_rows``) at every g, or the wrapper's own
    (``group_tile_rows``) where the source has the mma route."""
    fn = lib.paged_attention_sm90_launch
    fn.argtypes, fn.restype = pa_ops.LAUNCH_ARGTYPES, ctypes.c_int
    tiles = (pa_ops.group_tile_rows
             if hasattr(lib, "paged_attention_sm90_mma_route")
             else pa_ops.tile_rows)

    def run(q, k_pages, v_pages, page_table, lengths, *,
            softcap: float = 0.0) -> torch.Tensor:
        rows = tiles(q.shape[1] // k_pages.shape[1], q.shape[2],
                     q.element_size())
        return pa_ops._run_sm90(q, k_pages, v_pages, page_table, lengths,
                                softcap, launcher=fn, rows=rows)

    return run


def sliced_plan(S: int, dh: int, chunk: int) -> dict:
    """The plan of the sliced outputs pass (``outputs_sliced_kernel``,
    commits 9676424 to 774e907) past chunk 256 or dh 512: a block of 64 nt
    columns, nt 1, 4 or 8 (dh <= 64, <= 256, above), over column slices, P
    tiles of 256 keys at most; inside both limits the plan as it is."""
    p = ml_ops.plan(S, dh, chunk)
    if not p["sliced"]:
        return p
    nt = 1 if dh <= 64 else 4 if dh <= 256 else 8
    lp = min(-(-chunk // 64) * 64, ml_ops.BLOCK_CHUNK)
    return {**p, "nt": nt, "lp": lp, "col_slices": -(-dh // (64 * nt)),
            "smem_outputs": ml_ops.outputs_smem(64 * nt, lp)}


def _mlstm_scan_sm90(lib: ctypes.CDLL) -> Callable[..., torch.Tensor]:
    """An earlier K3: commit ff92dab's, whose C entry the wrapper's call
    still fits at the shapes it took (chunk <= 256, dh <= 512), or commit
    774e907's (every shape; past those limits the sliced outputs pass,
    ``sliced_plan``). The function also takes ``passes``, ``ws`` and
    ``out`` as ``ops._run_sm90`` does."""
    fn = lib.mlstm_scan_sm90_launch
    fn.argtypes, fn.restype = ml_ops.LAUNCH_ARGTYPES, ctypes.c_int

    def run(q, k, v, lf, li, *, chunk: int = 128, **kw) -> torch.Tensor:
        chunk = min(chunk, q.shape[2])
        return ml_ops._run_sm90(q, k, v, lf, li, chunk,
                                build=(fn, sliced_plan), **kw)

    return run


_KERNELS = {"mlstm_scan": _mlstm_scan, "flash_attention": _flash_attention,
            "paged_attention": _paged_attention,
            "flash_attention_sm90": _flash_attention_sm90(
                "flash_attention_sm90"),
            "flash_attention_f32_sm90": _flash_attention_sm90(
                "flash_attention_f32_sm90"),
            "paged_attention_sm90": _paged_attention_sm90,
            "mlstm_scan_sm90": _mlstm_scan_sm90}


def load(checkout: str) -> Dict[str, Callable[..., torch.Tensor]]:
    """The earlier kernels whose sources lie under ``checkout``, by source
    name; raises if there is none."""
    srcs = {name: Path(checkout) / CSRC / f"{name}.cu" for name in _KERNELS}
    libs = _libraries({n: s for n, s in srcs.items() if s.exists()})
    found = {name: _KERNELS[name](lib) for name, lib in libs.items()}
    if not found:
        raise FileNotFoundError(
            f"baselines: none of {', '.join(f'{n}.cu' for n in _KERNELS)} "
            f"under {checkout}/{CSRC}")
    return found
