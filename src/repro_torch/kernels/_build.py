"""Build the port's CUDA sources with nvcc at first use; load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/kernels/<name>-<hash>.so`` at the repository root (listed in
``.gitignore``); the hash covers the source and the flags, so an edited
source builds anew. ``build`` starts one nvcc per source, all together, and
waits for them. Nothing is compiled when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> Iterable[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    nvcc = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if not nvcc:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (CUDA_HOME or nvcc on PATH)")
    return nvcc


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build_log(name: str) -> str:
    """What nvcc printed (ptxas registers, shared memory, spills)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named source that has no library yet, all nvcc
    processes at once. Returns the seconds each build took (0 if cached)."""
    names = list(sources() if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, took = {}, {n: 0.0 for n in names}
    nvcc = None
    for n in names:
        lib = library_path(n)
        if lib.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = open(lib.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                    log, tmp, lib, time.perf_counter())
    failed, left = [], dict(procs)
    while left:                 # each source's own time, as it finishes
        for n in [n for n, p in left.items() if p[0].poll() is not None]:
            took[n] = time.perf_counter() - left.pop(n)[4]
        if left:
            time.sleep(0.05)
    for n, (proc, log, tmp, lib, t0) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{n} (nvcc exit {rc}):\n{build_log(n)}")
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The compiled library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        lib = library_path(name)
        if not lib.exists():
            build([name])
        _loaded[name] = ctypes.CDLL(str(lib))
    return _loaded[name]
