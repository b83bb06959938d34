"""Simulation drivers: a loop over cycles, a leading axis over workloads.

Port of the ticked drivers of ``repro/core/simulator.py``.
``simulate(cfg, policy, pool_batch, active_batch, n_cycles, warmup)`` runs a
batch of W workloads through one scheduler and returns per-source metrics,
delta-measured after a warm-up. Every state tensor carries the workload
axis W in front (the reference vmaps one workload's step instead), and the
cycle counter is a Python int.

The entry points run on the card unless the caller passes
``device="cpu"``; without a card they raise. Policies resolve by name
through `repro_torch.core.policy.POLICY_REGISTRY`.

Not ported yet (slice B): the variable-step driver (``skip=True``), the
knob-grid and stacked drivers, the sanitizer and the flight recorder.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core import params
from repro_torch.core import policy as policy_api
from repro_torch.core.params import SimConfig

_SNAP_KEYS = ("insts_done", "emitted", "completed", "sum_lat", "dl_met",
              "dl_missed", "frames_released")
_DRAM_SNAP = ("hits", "issued")
# energy accumulators, present in dram_state only when cfg.energy_enabled
_ENERGY_SNAP = ("e_act", "e_rw", "sb_cycles", "e_wake", "pd_cycles")
# QoS latency histogram, present only when cfg.qos_enabled
_QOS_SNAP = ("lat_hist",)
# policy QoS counters surfaced from scheduler state when present
_SCHED_SNAP = {"sq_urgent_adm": "urgent_admits"}


def __getattr__(name: str):
    # live registry enumerations, in registration order: POLICIES is the
    # baseline sweep (no configured variants); ALL_POLICIES adds variants
    if name == "POLICIES":
        return policy_api.baseline_names()
    if name == "ALL_POLICIES":
        return policy_api.names()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def resolve_device(device=None) -> torch.device:
    """The device a run uses: `cuda` unless the caller names another. A
    CUDA device without a card raises; nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the simulator runs on the GPU by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def _check_skip(skip) -> None:
    if skip:
        raise NotImplementedError(
            "skip=True: the variable-step driver comes with slice B")


def _init(cfg: SimConfig, policy: str, W: int, device):
    """Resolve the policy and build (bound cfg, policy object, carry)."""
    pol = policy_api.get(policy)
    cfg = pol.configure(cfg)
    kn = policy_api.resolve_knobs(cfg, pol)
    carry = (engine.source_state(cfg, W, device),
             pol.init_state(cfg, W, device),
             engine.dram_state(cfg, W, device))
    return params.bind(cfg, kn), pol, carry


def _run_cycles(step, carry, t0: int, t1: int):
    """Run cycles [t0, t1): the one driver loop of every `simulate*`."""
    for t in range(t0, t1):
        carry, _ = step(carry, t)
    return carry


def _scan_and_measure(cfg: SimConfig, step, carry, n_cycles: int,
                      warmup: int) -> Dict[str, torch.Tensor]:
    """Warm-up run, stat snapshot, measured run, delta metrics ((W, ...)).

    The state is never written in place, so the snapshot keeps the
    warm-up's tensors by reference."""
    carry = _run_cycles(step, carry, 0, warmup)
    st_w, sched_w, dram_w = carry
    energy_on = all(k in dram_w for k in _ENERGY_SNAP)
    qos_on = all(k in dram_w for k in _QOS_SNAP)
    snap = {k: st_w[k] for k in _SNAP_KEYS}
    snap.update({k: dram_w[k] for k in _DRAM_SNAP})
    if energy_on:
        snap.update({k: dram_w[k] for k in _ENERGY_SNAP})
    if qos_on:
        snap.update({k: dram_w[k] for k in _QOS_SNAP})
    sched_snap = {k: sched_w[k] for k in _SCHED_SNAP if k in sched_w}
    carry = _run_cycles(step, carry, warmup, warmup + n_cycles)
    st_f, sched_f, dram_f = carry

    f32 = torch.float32
    d = lambda k: (st_f[k] if k in st_f else dram_f[k]).to(f32) \
        - snap[k].to(f32)
    # The reference's metrics as XLA computes them: `x / n_cycles` becomes
    # x * f32(1/n), and `x / n * 1000` becomes x * f32(f32(1/n) * 1000).
    inv = np.float32(1.0) / np.float32(n_cycles)
    per_cyc = lambda x: x * float(inv)
    per_kcyc = lambda x: x * float(np.float32(inv * np.float32(1000.0)))
    completed = d("completed")
    out = {
        "ipc": per_cyc(d("insts_done")),
        "bw": per_cyc(completed),                     # requests per cycle
        "mpkc": per_kcyc(d("emitted")),
        "rbl": d("hits") / torch.clamp(d("issued"), min=1.0),
        "avg_lat": d("sum_lat") / torch.clamp(completed, min=1.0),
        "completed": completed,
        "emitted": d("emitted"),
        "outstanding_end": st_f["outstanding"].to(f32),
        "inflight_unserved": (st_f["emitted"] - st_f["completed"]).to(f32),
        "dl_met": d("dl_met"),
        "dl_missed": d("dl_missed"),
        "frames_released": d("frames_released"),
        # processed cycles in the measured window (every cycle: ticked)
        "sim_steps": torch.full(st_f["completed"].shape[:-1],
                                float(n_cycles), dtype=f32,
                                device=completed.device),
    }
    if qos_on:
        out["lat_hist"] = d("lat_hist")               # (W, S, BINS) counts
    for k, name in _SCHED_SNAP.items():
        if k in sched_snap:
            out[name] = sched_f[k].to(f32) - sched_snap[k].to(f32)
    if energy_on:
        # per-source dynamic energy stays (W, S); per-channel background
        # collapses to totals, in nJ from the integer cycle counters
        out.update({
            "energy_act": d("e_act"),
            "energy_rw": d("e_rw"),
            "energy_bg": _fma(_sum_channels(d("sb_cycles")),
                              cfg.energy_standby,
                              _sum_channels(d("pd_cycles"))
                              * float(np.float32(cfg.energy_pd))),
            "energy_wake": _sum_channels(d("e_wake")),
            "pd_cycles": _sum_channels(d("pd_cycles")),
        })
    return out


def _fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """f32 a * b + c with one rounding, as XLA contracts the reference's
    `energy_bg` (sb * standby + pd * pd_power). Exact through float64: a is
    a cycle count (integer-valued, < 2^24), b and c float32, so a * b + c
    fits a double's mantissa and only the final cast rounds."""
    b = float(np.float32(b))
    return (a.to(torch.float64) * b + c.to(torch.float64)).to(torch.float32)


def _sum_channels(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last (channel) axis in index order, as a left fold: a
    float sum of non-integer values (`e_wake`) then rounds the same way on
    every device, whatever order a library reduction would pick."""
    acc = x[..., 0]
    for c in range(1, x.shape[-1]):
        acc = acc + x[..., c]
    return acc


def _check_pool(pool: Dict[str, Any], shape) -> None:
    """Host-side pool validation: malformed columns raise a named-column
    `ValueError` before any cycle runs."""
    shape = tuple(shape)
    float_cols = ("mpki", "inst_per_miss", "rbl")
    int_cols = ("blp", "dl_period", "dl_reqs", "dl_jitter", "src_class")
    for k, v in pool.items():
        v = _host(v)
        if tuple(v.shape) != shape:
            raise ValueError(
                f"pool column {k!r}: shape {tuple(v.shape)} does not match "
                f"the active shape {shape}")
        if k in float_cols and v.dtype.kind not in "fiu":
            raise ValueError(
                f"pool column {k!r}: dtype {v.dtype} is not numeric")
        if k in int_cols and v.dtype.kind not in "iu":
            raise ValueError(
                f"pool column {k!r}: dtype {v.dtype} is not integral")
        if k == "is_gpu" and v.dtype.kind != "b":
            raise ValueError(
                f"pool column 'is_gpu': dtype {v.dtype} is not bool")
    for k in ("dl_period", "dl_reqs", "dl_jitter"):
        if k in pool and np.any(_host(pool[k]) < 0):
            raise ValueError(
                f"pool column {k!r}: negative values (deadline streams "
                f"use 0 for 'no deadline', never negatives)")
    if "src_class" in pool:
        sc = _host(pool["src_class"])
        if np.any((sc < 0) | (sc >= params.N_CLASSES)):
            raise ValueError(
                f"pool column 'src_class': values outside the CLASS_NAMES "
                f"range [0, {params.N_CLASSES}) "
                f"(known classes: {params.CLASS_NAMES})")


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


# numpy kinds -> the dtypes the reference's arrays take (JAX's default
# 32-bit mode: float64 -> float32, int64 -> int32)
_KIND_DTYPE = {"f": torch.float32, "i": torch.int32, "u": torch.int32,
               "b": torch.bool}


def _to_device(v, device) -> torch.Tensor:
    a = _host(v)
    dt = _KIND_DTYPE[a.dtype.kind]
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.as_tensor(a).to(device=device, dtype=dt)


def prepare_pool(pool: Dict[str, Any], shape, device=None
                 ) -> Dict[str, torch.Tensor]:
    """The one pool-preparation path shared by every driver.

    Validates the columns (named-column `ValueError` on malformed input),
    moves them to the device in the reference's dtypes and completes the
    N-class schema: absent deadline-stream keys are zero-filled and an
    absent `src_class` is derived from `is_gpu`/`dl_period`.
    """
    _check_pool(pool, shape)
    dev = resolve_device(device)
    out = {k: _to_device(v, dev) for k, v in pool.items()}
    for k in ("dl_period", "dl_reqs", "dl_jitter"):
        if k not in out:
            out[k] = torch.zeros(tuple(shape), dtype=torch.int32, device=dev)
    if "src_class" not in out:
        out["src_class"] = engine.derive_src_class(out["is_gpu"],
                                                   out["dl_period"])
    return out


def prepare_run(cfg: SimConfig, policy: str, pool_batch: Dict[str, Any],
                active_batch, *, device=None):
    """(bound cfg, step, carry) of a batched run, nothing simulated yet: the
    pool and the zero state on the device. Every host-to-device copy of a
    run happens here; the cycle loop that follows makes none."""
    dev = resolve_device(device)
    active = _host(active_batch)
    pool = prepare_pool(pool_batch, active.shape, dev)
    active = torch.as_tensor(active.astype(bool)).to(dev)
    cfg, pol, carry = _init(cfg, policy, active.shape[0], dev)
    return cfg, policy_api.make_step(cfg, pol, pool, active), carry


def simulate(cfg: SimConfig, policy: str, pool_batch: Dict[str, Any],
             active_batch, n_cycles: int = 20_000, warmup: int = 2_000,
             skip: bool = None, *, device=None) -> Dict[str, np.ndarray]:
    """pool_batch: dict of (W, S) arrays; active_batch: (W, S) bool.
    Returns (W, ...) numpy metrics."""
    _check_skip(skip)
    cfg, step, carry = prepare_run(cfg, policy, pool_batch, active_batch,
                                   device=device)
    out = _scan_and_measure(cfg, step, carry, n_cycles, warmup)
    return {k: v.cpu().numpy() for k, v in out.items()}


def _export_state(tree: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Final-state tensors as numpy in the reference's dtypes: the uint32
    streams held in int64 come back as uint32."""
    out = {}
    for k, v in tree.items():
        a = v.cpu().numpy()
        out[k] = a.astype(np.uint32) if k in engine.U32_KEYS else a
    return out


def simulate_debug(cfg: SimConfig, policy: str, pool: Dict[str, Any],
                   active, n_cycles: int = 2_000, skip: bool = None, *,
                   device=None):
    """Single-workload run returning the FINAL RAW STATE (invariant tests):
    the batched path at W = 1, squeezed on export.

    pool: dict of (S,) arrays; active: (S,) bool.
    Returns (src_state, sched_state, dram_state) as numpy trees.
    """
    _check_skip(skip)
    dev = resolve_device(device)
    _check_pool(pool, (cfg.n_src,))
    pool = prepare_pool({k: _host(v)[None] for k, v in pool.items()},
                        (1, cfg.n_src), dev)
    active = torch.as_tensor(_host(active).astype(bool)[None]).to(dev)
    cfg, pol, carry = _init(cfg, policy, 1, dev)
    step = policy_api.make_step(cfg, pol, pool, active)
    carry = _run_cycles(step, carry, 0, n_cycles)
    return tuple({k: v[0] for k, v in _export_state(tree).items()}
                 for tree in carry)


def perf_vector(cfg: SimConfig, metrics: Dict[str, np.ndarray],
                pool_batch: Dict[str, np.ndarray]) -> np.ndarray:
    """Per-source performance, (W, S): IPC for CPU-class sources, attained
    BW for the streaming classes (GPU, HWA)."""
    if "src_class" in pool_batch:
        cls = np.asarray(pool_batch["src_class"])
    else:
        is_gpu = np.asarray(pool_batch["is_gpu"], bool)
        dlp = np.asarray(pool_batch.get("dl_period", np.zeros_like(is_gpu,
                                                                   np.int32)))
        cls = np.where(is_gpu, params.CLS_GPU,
                       np.where(dlp > 0, params.CLS_HWA, params.CLS_CPU))
    return np.where(cls == params.CLS_CPU, metrics["ipc"], metrics["bw"])
