"""K3's earlier CUDA-core kernel, built from another checkout, as a yardstick.

Until the chunk-state kernel (``csrc/mlstm_scan_sm90.cu``) replaced it, K3
was one CUDA-core kernel, ``csrc/mlstm_scan.cu``: one block per (batch x
head, 64 value columns) with the chunks in order inside it. Its source is no
longer in this tree. To time it beside the current kernel on one card,
unpack a commit that has it with ``git archive`` into a git-ignored
directory and pass that directory, e.g.

  python3 chip_smoke.py --baseline-src build/<dir>

``load(dir)`` builds ``<dir>/src/repro_torch/csrc/mlstm_scan.cu`` with the
port's nvcc flags into ``build/kernels/`` (keyed by the source's hash) and
returns a function with the public wrapper's signature that launches it on
CUDA tensors the wrapper would accept.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Callable

import torch

from repro_torch.kernels import _build

SOURCE = Path("src") / "repro_torch" / "csrc" / "mlstm_scan.cu"


def load(checkout: str) -> Callable[..., torch.Tensor]:
    src = Path(checkout) / SOURCE
    if not src.exists():
        raise FileNotFoundError(f"k3_baseline: no {SOURCE} under {checkout}")
    data = src.read_bytes()
    digest = hashlib.sha1(data + " ".join(_build.NVCC_FLAGS).encode())
    name = f"mlstm_scan_baseline-{digest.hexdigest()[:12]}.so"
    lib = _build.BUILD_DIR / name
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(tmp), str(src)], capture_output=True,
                              text=True)
        if done.returncode:
            raise RuntimeError(f"k3_baseline: nvcc failed:\n{done.stdout}"
                               f"{done.stderr}")
        os.replace(tmp, lib)
    fn = ctypes.CDLL(str(lib)).mlstm_scan_launch
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
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lf.data_ptr(),
                 li.data_ptr(), out.data_ptr(), ctypes.addressof(strides), B,
                 H, S, dh, chunk, dh ** -0.5,
                 0 if q.dtype == torch.float32 else 1, q.device.index,
                 torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            raise RuntimeError(f"k3_baseline: launch failed with CUDA error "
                               f"{err}")
        return out

    return run
