"""Earlier CUDA-core kernels, built from another checkout, as yardsticks.

Three kernels the port has replaced are no longer in this tree:

* K3's ``csrc/mlstm_scan.cu`` (last in commit df97d3b's parent): one
  block per (batch x head, 64 value columns), the chunks in order inside
  it; replaced by ``csrc/mlstm_scan_sm90.cu``;
* K2's ``csrc/flash_attention.cu`` (last in commit 2142486): float32
  attention on the CUDA cores, one block per (batch x head, 64 q rows);
  replaced on the float32 route by ``csrc/flash_attention_f32_sm90.cu``;
* K1's ``csrc/paged_attention.cu`` (last in commit 8d1f884): paged decode
  attention on the CUDA cores, one block per (kv head, sequence), g <= 8
  and d <= 256; replaced for every shape by ``csrc/paged_attention_sm90.cu``.

To time them beside the current kernels on one card, unpack commits that
have them with ``git archive`` into one git-ignored directory and pass it,
e.g.

  mkdir -p build/base
  git archive df97d3b^ src/repro_torch/csrc/mlstm_scan.cu | tar -x -C build/base
  git archive 2142486 src/repro_torch/csrc/flash_attention.cu | tar -x -C build/base
  git archive 8d1f884 src/repro_torch/csrc/paged_attention.cu | tar -x -C build/base
  python3 chip_smoke.py --baseline-src build/base

``load(dir)`` builds each of the three sources it finds under
``dir/src/repro_torch/csrc/`` with the port's nvcc flags into
``build/kernels/`` (keyed by the source's hash) and returns, by name
(``mlstm_scan``, ``flash_attention``, ``paged_attention``), a function with
the public wrapper's signature that launches the earlier kernel on CUDA
tensors the wrapper would accept (K1's: at g <= 8 and d <= 256).
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
from pathlib import Path
from typing import Callable, Dict

import torch

from repro_torch.kernels import _build

CSRC = Path("src") / "repro_torch" / "csrc"


def _library(src: Path, name: str) -> ctypes.CDLL:
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(_build.NVCC_FLAGS).encode())
    lib = _build.BUILD_DIR / f"{name}_baseline-{digest.hexdigest()[:12]}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(tmp), str(src)], capture_output=True,
                              text=True)
        if done.returncode:
            raise RuntimeError(f"baselines: nvcc failed on {src}:\n"
                               f"{done.stdout}{done.stderr}")
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))


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


_KERNELS = {"mlstm_scan": _mlstm_scan, "flash_attention": _flash_attention,
            "paged_attention": _paged_attention}


def load(checkout: str) -> Dict[str, Callable[..., torch.Tensor]]:
    """The earlier kernels whose sources lie under ``checkout``, by name;
    raises if there is none."""
    found = {}
    for name, wrap in _KERNELS.items():
        src = Path(checkout) / CSRC / f"{name}.cu"
        if src.exists():
            found[name] = wrap(_library(src, name))
    if not found:
        raise FileNotFoundError(
            f"baselines: none of {', '.join(f'{n}.cu' for n in _KERNELS)} "
            f"under {checkout}/{CSRC}")
    return found
