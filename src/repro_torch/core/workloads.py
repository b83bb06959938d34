"""Synthetic benchmark pool + multiprogrammed workload construction.

A numpy copy of ``repro/core/workloads.py``: the same seeds give the same
workloads.

CPU archetypes are calibrated to the paper's Fig 1 ranges for SPEC2006:
MPKI from ~1 (low) to ~40 (high), RBL 0.2–0.9, BLP 1–6. GPU benchmarks have
very high intensity (wavefront generator), RBL ~0.9, BLP ~4. Workload
categories follow §4: L, ML, M, HL, HML, HM, H — 15 workloads each = 105.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.params import CLS_GPU, CLS_HWA, SimConfig, SourcePool

# (name, mpki, rbl, blp)
CPU_BENCH: List[Tuple[str, float, float, int]] = [
    # --- Low (MPKI < 5) ---
    ("l.povray", 1.5, 0.35, 2), ("l.calculix", 3.0, 0.70, 1),
    ("l.namd", 4.0, 0.50, 2), ("l.gcc", 2.0, 0.20, 3),
    ("l.perl", 5.0, 0.85, 1), ("l.sjeng", 4.5, 0.40, 4),
    # --- Medium (5 <= MPKI < 18) ---
    ("m.astar", 8.0, 0.60, 2), ("m.cactus", 11.0, 0.30, 4),
    ("m.zeusmp", 14.0, 0.75, 2), ("m.wrf", 9.0, 0.45, 3),
    ("m.xalanc", 13.0, 0.50, 5), ("m.gems", 16.0, 0.80, 1),
    # --- High (MPKI >= 18) ---
    ("h.omnetpp", 22.0, 0.85, 1), ("h.leslie", 27.0, 0.35, 5),
    ("h.soplex", 33.0, 0.60, 3), ("h.libq", 38.0, 0.45, 6),
    ("h.milc", 25.0, 0.55, 4), ("h.lbm", 40.0, 0.70, 2),
]

# (name, rbl, blp) — intensity is the wavefront generator (MSHR-bounded)
GPU_BENCH: List[Tuple[str, float, int]] = [
    ("g.game0", 0.92, 4), ("g.game1", 0.88, 4), ("g.game2", 0.95, 4),
    ("g.bench0", 0.90, 4), ("g.bench1", 0.93, 4),
]

# (name, dl_period, dl_reqs, rbl, blp, dl_jitter) — frame-deadline HWAs
# (SQUASH-style, arXiv:1505.07502): every dl_period cycles a frame of
# dl_reqs requests is released (after up to dl_jitter cycles of per-frame
# jitter) and is due at the next boundary. Streaming DMA access patterns:
# high RBL, modest BLP.
HWA_BENCH: List[Tuple[str, int, int, float, int, int]] = [
    ("x.imgproc", 1000, 45, 0.85, 2, 64),
    ("x.hog",      800, 28, 0.75, 3, 48),
    ("x.mfilt",   1200, 55, 0.90, 2, 96),
    ("x.ldpc",     600, 18, 0.60, 4, 32),
]

CATEGORIES = ("L", "ML", "M", "HL", "HML", "HM", "H")
_CAT_GROUPS = {
    "L": ("l",), "ML": ("l", "m"), "M": ("m",), "HL": ("h", "l"),
    "HML": ("h", "m", "l"), "HM": ("h", "m"), "H": ("h",),
}


@dataclass(frozen=True)
class Workload:
    category: str
    cpu_ids: Tuple[int, ...]   # indices into CPU_BENCH
    gpu_id: int                # index into GPU_BENCH
    hwa_ids: Tuple[int, ...] = ()   # indices into HWA_BENCH


def make_workloads(n_cpu: int, n_per_cat: int = 15, seed: int = 7,
                   n_hwa: int = 0) -> List[Workload]:
    """`n_hwa > 0` adds that many HWA draws per workload. The draws happen
    only when requested, so the 2-class workload stream for a given seed is
    unchanged by the N-class extension."""
    rng = np.random.RandomState(seed)
    by_group: Dict[str, List[int]] = {"l": [], "m": [], "h": []}
    for i, (name, *_ ) in enumerate(CPU_BENCH):
        by_group[name[0]].append(i)
    out = []
    for cat in CATEGORIES:
        pool = [i for g in _CAT_GROUPS[cat] for i in by_group[g]]
        for _ in range(n_per_cat):
            cpu_ids = tuple(rng.choice(pool, size=n_cpu, replace=True))
            gpu_id = int(rng.randint(len(GPU_BENCH)))
            hwa_ids = tuple(int(rng.randint(len(HWA_BENCH)))
                            for _ in range(n_hwa)) if n_hwa else ()
            out.append(Workload(cat, cpu_ids, gpu_id, hwa_ids))
    return out


def pool_batch(cfg: SimConfig, workloads: Sequence[Workload]
               ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Build (pool arrays (W,S), active (W,S)) for the shared runs."""
    W, S = len(workloads), cfg.n_src
    mpki = np.zeros((W, S), np.float32)
    rbl = np.zeros((W, S), np.float32)
    blp = np.ones((W, S), np.int32)
    is_gpu = np.zeros((W, S), bool)
    src_class = np.zeros((W, S), np.int32)          # CLS_CPU default
    dl_period = np.zeros((W, S), np.int32)
    dl_reqs = np.zeros((W, S), np.int32)
    dl_jitter = np.zeros((W, S), np.int32)
    for w, wl in enumerate(workloads):
        for i, b in enumerate(wl.cpu_ids[:cfg.n_cpu]):
            _, m, r, bl = CPU_BENCH[b]
            mpki[w, i], rbl[w, i], blp[w, i] = m, r, bl
        gname, gr, gb = GPU_BENCH[wl.gpu_id]
        gi = cfg.n_cpu
        mpki[w, gi], rbl[w, gi], blp[w, gi] = 1000.0, gr, gb
        is_gpu[w, gi] = True
        src_class[w, gi] = CLS_GPU
        for j, b in enumerate(wl.hwa_ids[:cfg.n_hwa]):
            _, period, reqs, r, bl, jit = HWA_BENCH[b]
            hi = cfg.n_cpu + cfg.n_gpu + j
            mpki[w, hi], rbl[w, hi], blp[w, hi] = 1000.0, r, bl
            src_class[w, hi] = CLS_HWA
            dl_period[w, hi], dl_reqs[w, hi] = period, reqs
            dl_jitter[w, hi] = jit
    pool = {"mpki": mpki,
            "inst_per_miss": np.maximum(1000.0 / np.maximum(mpki, 1e-3), 1.0),
            "rbl": rbl, "blp": blp, "is_gpu": is_gpu,
            "src_class": src_class, "dl_period": dl_period,
            "dl_reqs": dl_reqs, "dl_jitter": dl_jitter}
    active = np.ones((W, S), bool)
    return pool, active


# ---------------------------------------------------------------------------
# idle-heavy / bursty archetypes: the traffic the variable-step driver is
# for. Real heterogeneous streams are mostly
# idle at the memory controller (Ausavarungnirun, arXiv:1803.06958; Mutlu et
# al., arXiv:1805.06407): sparse CPU misses, long HWA frame gaps, duty-cycled
# GPU bursts. Each archetype is one workload row; the measured skip ratio
# per archetype is reported by `benchmarks/simspeed.py` (event_skip section).
# ---------------------------------------------------------------------------

BURSTY_ARCHETYPES: Tuple[str, ...] = (
    "idle_cpu",      # low-intensity CPU mix, nothing else
    "hwa_frames",    # long-period frame accelerators + a CPU trickle
    "gpu_burst",     # duty-cycled streaming bursts (GPU-like HWA source)
    "mixed_bursty",  # all three combined
)


def bursty_batch(cfg: SimConfig) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """(pool (W,S), active (W,S)) for the BURSTY_ARCHETYPES rows.

    Duty-cycled GPU bursts are modeled as CLS_HWA sources (streaming RBL/BLP
    with a large per-frame request budget): the frame machinery IS the duty
    cycle — a dl_reqs burst every dl_period cycles, idle in between — which
    a plain CLS_GPU source (always-wanting) cannot express. Requires at
    least two HWA slots (cfg.n_hwa >= 2).
    """
    if cfg.n_hwa < 2:
        raise ValueError("bursty_batch needs cfg.n_hwa >= 2 "
                         f"(got {cfg.n_hwa})")
    W, S = len(BURSTY_ARCHETYPES), cfg.n_src
    mpki = np.zeros((W, S), np.float32)
    rbl = np.zeros((W, S), np.float32)
    blp = np.ones((W, S), np.int32)
    is_gpu = np.zeros((W, S), bool)
    src_class = np.zeros((W, S), np.int32)
    dl_period = np.zeros((W, S), np.int32)
    dl_reqs = np.zeros((W, S), np.int32)
    dl_jitter = np.zeros((W, S), np.int32)
    active = np.zeros((W, S), bool)

    def cpu(w, i, m, r=0.6, bl=2):
        mpki[w, i], rbl[w, i], blp[w, i] = m, r, bl
        active[w, i] = True

    def hwa(w, j, period, reqs, r, bl, jit):
        hi = cfg.n_cpu + cfg.n_gpu + j
        mpki[w, hi], rbl[w, hi], blp[w, hi] = 1000.0, r, bl
        src_class[w, hi] = CLS_HWA
        dl_period[w, hi], dl_reqs[w, hi] = period, reqs
        dl_jitter[w, hi] = jit
        active[w, hi] = True

    for w, arch in enumerate(BURSTY_ARCHETYPES):
        if arch == "idle_cpu":
            # sparse misses: one every ~500-3300 instructions per core
            for i, m in zip(range(cfg.n_cpu), (0.3, 0.6, 1.2, 2.0) * 4):
                cpu(w, i, m)
        elif arch == "hwa_frames":
            cpu(w, 0, 0.5)
            hwa(w, 0, 4000, 60, 0.85, 2, 128)
            hwa(w, 1, 6000, 40, 0.90, 2, 256)
        elif arch == "gpu_burst":
            cpu(w, 0, 0.3)
            # ~300-cycle burst every 3000 cycles at ~1 req/cycle drain
            hwa(w, 0, 3000, 300, 0.92, 4, 0)
        elif arch == "mixed_bursty":
            for i, m in zip(range(min(cfg.n_cpu, 3)), (0.5, 1.0, 1.5)):
                cpu(w, i, m)
            hwa(w, 0, 5000, 50, 0.85, 2, 192)
            hwa(w, 1, 2500, 200, 0.90, 4, 0)
    pool = {"mpki": mpki,
            "inst_per_miss": np.maximum(1000.0 / np.maximum(mpki, 1e-3), 1.0),
            "rbl": rbl, "blp": blp, "is_gpu": is_gpu,
            "src_class": src_class, "dl_period": dl_period,
            "dl_reqs": dl_reqs, "dl_jitter": dl_jitter}
    return pool, active


def alone_batch(cfg: SimConfig) -> Tuple[Dict[str, np.ndarray], np.ndarray,
                                         Dict[str, int]]:
    """One single-source run per benchmark; returns index map name->row.

    HWA rows are added only when the config has HWA slots (cfg.n_hwa > 0),
    keeping the 2-class alone sweep — and its cached results — untouched.
    """
    names = [b[0] for b in CPU_BENCH] + [g[0] for g in GPU_BENCH]
    if cfg.n_hwa > 0:
        names += [h[0] for h in HWA_BENCH]
    W, S = len(names), cfg.n_src
    mpki = np.full((W, S), 10.0, np.float32)
    rbl = np.full((W, S), 0.5, np.float32)
    blp = np.ones((W, S), np.int32)
    is_gpu = np.zeros((W, S), bool)
    src_class = np.zeros((W, S), np.int32)
    dl_period = np.zeros((W, S), np.int32)
    dl_reqs = np.zeros((W, S), np.int32)
    dl_jitter = np.zeros((W, S), np.int32)
    active = np.zeros((W, S), bool)
    for w, name in enumerate(names):
        if name.startswith("g."):
            _, r, bl = GPU_BENCH[[g[0] for g in GPU_BENCH].index(name)]
            gi = cfg.n_cpu
            mpki[w, gi], rbl[w, gi], blp[w, gi] = 1000.0, r, bl
            is_gpu[w, gi] = True
            src_class[w, gi] = CLS_GPU
            active[w, gi] = True
        elif name.startswith("x."):
            _, period, reqs, r, bl, jit = \
                HWA_BENCH[[h[0] for h in HWA_BENCH].index(name)]
            hi = cfg.n_cpu + cfg.n_gpu
            mpki[w, hi], rbl[w, hi], blp[w, hi] = 1000.0, r, bl
            src_class[w, hi] = CLS_HWA
            dl_period[w, hi], dl_reqs[w, hi] = period, reqs
            dl_jitter[w, hi] = jit
            active[w, hi] = True
        else:
            _, m, r, bl = CPU_BENCH[[b[0] for b in CPU_BENCH].index(name)]
            mpki[w, 0], rbl[w, 0], blp[w, 0] = m, r, bl
            active[w, 0] = True
    pool = {"mpki": mpki,
            "inst_per_miss": np.maximum(1000.0 / np.maximum(mpki, 1e-3), 1.0),
            "rbl": rbl, "blp": blp, "is_gpu": is_gpu,
            "src_class": src_class, "dl_period": dl_period,
            "dl_reqs": dl_reqs, "dl_jitter": dl_jitter}
    return pool, active, {n: i for i, n in enumerate(names)}


def alone_perf_lookup(cfg: SimConfig, metrics: Dict[str, np.ndarray],
                      name_to_row: Dict[str, int]):
    """Extract per-benchmark alone performance from the alone-batch metrics."""
    out = {}
    for name, w in name_to_row.items():
        if name.startswith("g."):
            out[name] = float(metrics["bw"][w, cfg.n_cpu])
        elif name.startswith("x."):
            out[name] = float(metrics["bw"][w, cfg.n_cpu + cfg.n_gpu])
        else:
            out[name] = float(metrics["ipc"][w, 0])
    return out
