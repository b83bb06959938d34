"""System metrics: weighted speedup, max slowdown, harmonic speedup (§5),
per-class QoS (deadline-met rate, tail latency, class-masked fairness).

A numpy copy of ``repro/core/metrics.py``; `timeline_breakdown` reads the
flight recorder's ring (`repro_torch.core.telemetry`)."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.params import (CLASS_NAMES, CLS_CPU, CLS_GPU, CLS_HWA,
                               SimConfig)
from repro_torch.core.workloads import CPU_BENCH, GPU_BENCH, HWA_BENCH, Workload


def class_vector(cfg: SimConfig) -> np.ndarray:
    """Canonical (S,) class-id layout: CPUs, then GPUs, then HWAs."""
    return np.asarray([CLS_CPU] * cfg.n_cpu + [CLS_GPU] * cfg.n_gpu
                      + [CLS_HWA] * cfg.n_hwa, np.int32)


def max_slowdown(slowdowns: np.ndarray,
                 mask: Optional[np.ndarray] = None) -> float:
    """The unfairness reduction, shared by every per-class variant: max
    slowdown over the (optionally class-masked) sources. NaN when the mask
    selects nothing, so an absent class can't fake perfect fairness."""
    s = np.asarray(slowdowns, np.float64)
    if mask is not None:
        mask = np.asarray(mask, bool)
        if not mask.any():
            return float("nan")
        s = s[mask]
    return float(s.max())


def per_source_alone(cfg: SimConfig, wl: Workload,
                     alone: Dict[str, float]) -> np.ndarray:
    """Alone performance vector (S,) for one workload."""
    out = np.ones((cfg.n_src,), np.float64)
    for i, b in enumerate(wl.cpu_ids[:cfg.n_cpu]):
        out[i] = max(alone[CPU_BENCH[b][0]], 1e-9)
    out[cfg.n_cpu] = max(alone[GPU_BENCH[wl.gpu_id][0]], 1e-9)
    for j, b in enumerate(wl.hwa_ids[:cfg.n_hwa]):
        out[cfg.n_cpu + cfg.n_gpu + j] = max(alone[HWA_BENCH[b][0]], 1e-9)
    return out


def workload_metrics(cfg: SimConfig, wl: Workload, shared_perf: np.ndarray,
                     alone: Dict[str, float]) -> Dict[str, float]:
    """shared_perf: (S,) per-source perf (IPC for CPUs, BW for GPU/HWAs).

    The populated sources are the n_cpu CPUs, the GPU at index n_cpu, and
    the workload's HWAs; slowdown reductions run over exactly those, with
    the per-class variants masking the shared `max_slowdown` reduction.
    `weighted_speedup` keeps its 2-class CPU+GPU definition (the paper's
    headline metric); HWA throughput reports separately as `hwa_speedup`.
    """
    alone_v = per_source_alone(cfg, wl, alone)
    ratio = np.maximum(shared_perf, 1e-9) / alone_v
    n = cfg.n_cpu
    n_hwa = len(wl.hwa_ids[:cfg.n_hwa])
    idx = np.asarray(list(range(n)) + [n] +
                     [n + cfg.n_gpu + j for j in range(n_hwa)])
    cls = np.asarray([CLS_CPU] * n + [CLS_GPU] + [CLS_HWA] * n_hwa)
    slowdowns = 1.0 / np.maximum(ratio[idx], 1e-9)
    cpu_ws = float(ratio[:n].sum())
    gpu_su = float(ratio[n])
    out = {
        "weighted_speedup": cpu_ws + gpu_su,
        "cpu_weighted_speedup": cpu_ws,
        "gpu_speedup": gpu_su,
        "max_slowdown": max_slowdown(slowdowns),
        "cpu_max_slowdown": max_slowdown(slowdowns, cls == CLS_CPU),
        "harmonic_speedup": float(len(idx) / (1.0 / ratio[idx]).sum()),
    }
    if n_hwa:
        out["hwa_speedup"] = float(ratio[idx[cls == CLS_HWA]].sum())
        out["hwa_max_slowdown"] = max_slowdown(slowdowns, cls == CLS_HWA)
    return out


def hist_quantile(hist: np.ndarray, edges: np.ndarray, q: float
                  ) -> np.ndarray:
    """Quantile(s) from latency histograms: (..., BINS) counts -> (...,)
    upper-edge latency of the bin where the cumulative mass crosses q.
    Rows with no mass report 0."""
    h = np.asarray(hist, np.float64)
    tot = h.sum(-1)
    cum = np.cumsum(h, -1)
    idx = np.argmax(cum >= q * np.maximum(tot, 1e-9)[..., None], axis=-1)
    return np.where(tot > 0, np.asarray(edges, np.float64)[idx], 0.0)


def qos_breakdown(cfg: SimConfig, m: Dict[str, np.ndarray],
                  pool_batch: Dict[str, np.ndarray],
                  quantiles: Sequence[float] = (0.95, 0.99)
                  ) -> Dict[str, np.ndarray]:
    """Per-workload (W,) QoS metrics from `simulate` outputs.

    Per-class tail latency comes from the issue-time latency histogram
    (`lat_hist`, needs cfg.qos_enabled): source rows roll up to classes by
    masking with `src_class`, then the pooled histogram reduces to p95/p99.
    Frame-deadline accounting (HWA class): deadline-met rate over the
    frames the measurement window released.
    """
    from repro_torch.core import qos
    cls = np.asarray(pool_batch["src_class"])                  # (W, S)
    hist = np.asarray(m["lat_hist"], np.float64)               # (W, S, B)
    edges = qos.bin_upper_edges(cfg)
    out: Dict[str, np.ndarray] = {}
    for k, kname in enumerate(CLASS_NAMES):
        pooled = np.where((cls == k)[..., None], hist, 0.0).sum(-2)
        for q in quantiles:
            out[f"lat_p{int(round(q * 100))}_{kname}"] = \
                hist_quantile(pooled, edges, q)
    hwa = cls == CLS_HWA
    rel = np.where(hwa, np.asarray(m["frames_released"], np.float64),
                   0.0).sum(-1)
    met = np.where(hwa, np.asarray(m["dl_met"], np.float64), 0.0).sum(-1)
    out["frames_released"] = rel
    out["dl_met_rate"] = met / np.maximum(rel, 1.0)
    return out


def timeline_breakdown(cfg: SimConfig, m: Dict[str, np.ndarray],
                       total_cycles: Optional[int] = None
                       ) -> Dict[str, np.ndarray]:
    """Time-resolved per-epoch series from the flight-recorder ring.

    m: metrics with `telemetry` (..., W, K) and `telemetry_epoch` (...)
    (cfg.telemetry_enabled); leading axes are flattened to one row axis.
    Slots are reordered into ascending epochs; `valid` masks slots never
    written, and with `total_cycles` (warm-up + measured) the per-epoch
    denominators account for a partial final epoch.

    Returns (..., W) series: `epoch`, `valid`, `occ_<class>` mean queue
    depth, `adm_<class>`/`iss_<class>` per-cycle rates, `lat_<class>` the
    occupancy over issues (Little's law, cycles per request),
    `row_hit_rate`, `batch_marks`, `pd_frac` power-down residency and
    `skip_ratio` (1 - processed steps / epoch cycles, a driver property).
    """
    from repro_torch.core import telemetry
    E, W = cfg.telemetry_epoch, cfg.telemetry_window
    ring = np.asarray(m["telemetry"], np.float64)
    lead = ring.shape[:-2]
    ring = ring.reshape((-1,) + ring.shape[-2:])               # (R, W, K)
    e_f = np.asarray(m["telemetry_epoch"]).reshape(-1).astype(np.int64)
    R = ring.shape[0]
    epochs = np.stack([telemetry.ring_epochs(W, e) for e in e_f])  # (R, W)
    order = np.argsort(epochs, axis=1)
    epochs = np.take_along_axis(epochs, order, axis=1)
    ring = np.take_along_axis(ring, order[:, :, None], axis=1)
    valid = epochs >= 0
    if total_cycles is not None:
        width = np.clip(total_cycles - epochs * E, 0, E).astype(np.float64)
    else:
        width = np.full((R, W), float(E))
    width = np.maximum(width, 1.0)
    ch = lambda name: ring[:, :, telemetry.CH[name]]
    out: Dict[str, np.ndarray] = {"epoch": epochs, "valid": valid}
    iss_tot = np.zeros((R, W))
    for kname in CLASS_NAMES:
        occ, adm, iss = ch(f"occ_{kname}"), ch(f"adm_{kname}"), \
            ch(f"iss_{kname}")
        iss_tot = iss_tot + iss
        out[f"occ_{kname}"] = occ / width
        out[f"adm_{kname}"] = adm / width
        out[f"iss_{kname}"] = iss / width
        # Little's law: mean in-flight / completion rate ~ mean latency
        out[f"lat_{kname}"] = occ / np.maximum(iss, 1.0)
    out["row_hit_rate"] = ch("row_hits") / np.maximum(iss_tot, 1.0)
    out["batch_marks"] = ch("batch_marks")
    out["pd_frac"] = ch("pd_chan") / (width * max(cfg.n_channels, 1))
    out["skip_ratio"] = 1.0 - ch("steps") / width
    restore = lambda a: a.reshape(lead + (W,))
    return {k: restore(v) for k, v in out.items()}


def energy_breakdown(cfg: SimConfig, m: Dict[str, np.ndarray],
                     pool_batch: Dict[str, np.ndarray], n_cycles: int,
                     static_per_cycle: float = 0.0) -> Dict[str, np.ndarray]:
    """Per-workload (W,) energy metrics from `simulate` outputs (nJ).

    m: metrics dict with the energy counters present (cfg.energy_enabled);
    static_per_cycle: scheduler-structure leakage power in nJ/cycle (see
    `power.scheduler_static_power`) folded into the full-MC totals.

    EDP here is per-request energy-delay: (energy per request) x (cycles
    per request) — runs are fixed-time, so per-request normalization is
    what makes policies comparable.
    """
    is_gpu = np.asarray(pool_batch["is_gpu"], bool)            # (W, S)
    act = np.asarray(m["energy_act"], np.float64)              # (W, S)
    rw = np.asarray(m["energy_rw"], np.float64)
    dyn = act + rw
    bg = np.asarray(m["energy_bg"], np.float64) \
        + np.asarray(m["energy_wake"], np.float64)             # (W,)
    static = float(static_per_cycle) * n_cycles
    total = dyn.sum(-1) + bg + static
    reqs = np.maximum(np.asarray(m["completed"], np.float64).sum(-1), 1.0)
    epr = total / reqs
    # the historical CPU/GPU split: everything non-GPU (including HWAs)
    # stays in the "cpu" bucket so 2-class consumers see unchanged keys;
    # 3-class runs get the per-class split from the hwa keys below
    hwa = (np.asarray(pool_batch["src_class"]) == CLS_HWA) \
        if "src_class" in pool_batch else np.zeros_like(is_gpu)
    out = {}
    if hwa.any():
        out["energy_dyn_hwa"] = np.where(hwa, dyn, 0.0).sum(-1)
        out["energy_act_hwa"] = np.where(hwa, act, 0.0).sum(-1)
    return {
        **out,
        "energy_total": total,
        "energy_per_request": epr,
        "edp": epr * (n_cycles / reqs),
        "energy_dyn_cpu": np.where(~is_gpu, dyn, 0.0).sum(-1),
        "energy_dyn_gpu": np.where(is_gpu, dyn, 0.0).sum(-1),
        "energy_act_cpu": np.where(~is_gpu, act, 0.0).sum(-1),
        "energy_act_gpu": np.where(is_gpu, act, 0.0).sum(-1),
        # row-miss ACT share of dynamic energy: the row-hit-batching signal
        "act_energy_frac": act.sum(-1) / np.maximum(dyn.sum(-1), 1e-9),
        "background_frac": bg / np.maximum(total, 1e-9),
        "static_frac": static / np.maximum(total, 1e-9),
        "pd_frac": np.asarray(m["pd_cycles"], np.float64)
        / (cfg.n_channels * n_cycles),
    }


def aggregate(rows: Sequence[Dict[str, float]]) -> Dict[str, float]:
    keys = rows[0].keys()
    return {k: float(np.mean([r[k] for r in rows])) for k in keys}


def by_category(workloads: Sequence[Workload],
                rows: Sequence[Dict[str, float]]):
    cats: Dict[str, List[Dict[str, float]]] = {}
    for wl, r in zip(workloads, rows):
        cats.setdefault(wl.category, []).append(r)
    return {c: aggregate(rs) for c, rs in cats.items()}
