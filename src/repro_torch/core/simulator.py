"""Simulation drivers: a loop over cycles, a leading axis over workloads.

Port of ``repro/core/simulator.py``.
``simulate(cfg, policy, pool_batch, active_batch, n_cycles, warmup)`` runs a
batch of W workloads through one scheduler and returns per-source metrics,
delta-measured after a warm-up. Every state tensor carries the workload
axis W in front (the reference vmaps one workload's step instead), and the
cycle counter is a Python int.

The stacked and grid drivers (``simulate_stacked``, ``simulate_grid``,
``simulate_stacked_grid``, ``simulate_debug_stacked``) fold their slices
(policies, knob points, or both) into that leading axis, policy-major:
P slices of W workloads are P·W rows of one run, each slice equal to its
solo run (`schedulers.make_stacked_step`, `policy.make_folded_step`).

Every driver takes ``skip``: ticked (every cycle) or the variable-step
driver (``skip=True``), which processes a cycle and jumps to the earliest
witnessed next event, bit-identical to ticking. The reference runs one
`while_loop` per workload under `vmap`; here one host cycle counter drives
every row, and each clock group (a row; a workload across its slices on
the stacked drivers) keeps its own next event, so every group processes
exactly the cycles the reference's loop does (see `_run_cycles`).

The entry points run on the card unless the caller passes
``device="cpu"``; without a card they raise. Policies resolve by name
through `repro_torch.core.policy.POLICY_REGISTRY`.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core import params
from repro_torch.core import policy as policy_api
from repro_torch.core import schedulers
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


# Variable-step driver default. skip=True jumps idle spans (bit-identical to
# ticking) but pays the witnesses on every processed step, so it is opt-in:
# a win on bursty, idle-heavy traffic, a loss on saturated sweeps.
DEFAULT_SKIP = False

# host reads of the variable-step driver: one per processed step
host_reads = 0


def _init(cfg: SimConfig, policy: str, W: int, device):
    """Resolve the policy and build (bound cfg, policy object, carry)."""
    pol = policy_api.get(policy)
    cfg = pol.configure(cfg)
    kn = policy_api.resolve_knobs(cfg, pol)
    carry = (engine.source_state(cfg, W, device),
             pol.init_state(cfg, W, device),
             engine.dram_state(cfg, W, device))
    return params.bind(cfg, kn), pol, carry


def _run_cycles(step, skip, carry, t0: int, t1: int, check=None):
    """Run cycles [t0, t1): the one driver loop of every `simulate*`.

    Ticked (`skip` None): every cycle, with no host read. Skipping (`skip`
    an `engine.SkipBody`): each clock group g keeps `own_next[g]`, the next
    cycle of its own trajectory, starting at t0. Each processed step runs
    the ticked step at t = min(own_next) for every row, then asks every
    row's witnesses; a group whose own cycle t is sets its next one to the
    minimum witness over its rows (at most t1) and counts the step. The
    minimum over groups, read on the host once per step, is the next
    processed cycle; the skipped span between them is accrued in closed
    form for every row. A group woken by another group's event processes a
    cycle at which nothing happens, which is ticked-identical (contract
    rule 1), and its own pending witness still binds: every group processes
    exactly the reference's trajectory and counts exactly its steps.

    `check(carry, t)`, if given, runs after each processed cycle t.
    Returns (carry, steps): steps is t1 - t0 when ticked, else the (G,)
    int32 processed steps of each group.
    """
    global host_reads
    if skip is None:
        for t in range(t0, t1):
            carry, _ = step(carry, t)
            if check is not None:
                check(carry, t)
        return carry, t1 - t0
    st = carry[0]
    R, dev = st["outstanding"].shape[0], st["outstanding"].device
    G = R // skip.fold
    own_next = torch.full((G,), t0, dtype=torch.int64, device=dev)
    steps = torch.zeros((G,), dtype=torch.int32, device=dev)
    t = t0
    while t < t1:
        mine = own_next == t
        own = mine.repeat(skip.fold) if skip.meter else None
        carry, _ = step(carry, t, own)
        w = skip.witness(carry, t)
        if skip.fold > 1:
            w = torch.amin(w.reshape(skip.fold, G), dim=0)
        own_next = torch.where(mine, torch.clamp(w, max=t1), own_next)
        steps = steps + mine.to(torch.int32)
        t_new = int(own_next.min())
        host_reads += 1
        if t_new <= t:
            raise RuntimeError(f"a witness returned cycle {t_new} at cycle "
                               f"{t}; witnesses must lie after t")
        if t_new > t + 1:
            carry = skip.accrue(carry, t, t_new)
        if check is not None:
            check(carry, t)
        t = t_new
    return carry, steps


def _scan_and_measure(cfg: SimConfig, step, skip, carry, n_cycles: int,
                      warmup: int) -> Dict[str, torch.Tensor]:
    """Warm-up run, stat snapshot, measured run, delta metrics ((W, ...)).

    The state is never written in place, so the snapshot keeps the
    warm-up's tensors by reference."""
    carry, _ = _run_cycles(step, skip, carry, 0, warmup)
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
    carry, steps = _run_cycles(step, skip, carry, warmup, warmup + n_cycles)
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
        # processed cycles in the measured window: n_cycles when ticked,
        # each row's clock group's own steps when skipping (the skip ratio
        # is 1 - sim_steps / n_cycles); a driver property
        "sim_steps": (torch.full(st_f["completed"].shape[:-1],
                                 float(n_cycles), dtype=f32,
                                 device=completed.device) if skip is None
                      else steps.repeat(skip.fold).to(f32)),
    }
    if qos_on:
        out["lat_hist"] = d("lat_hist")               # (W, S, BINS) counts
    if "viol" in dram_f:
        # sanitizer counters are cumulative, not delta-measured: a warm-up
        # violation is still one. (W, NV); `validate.summarize` names them
        out["violations"] = dram_f["viol"].to(f32)
    if "tl_ring" in dram_f:
        # the flight-recorder ring is windowed, not delta-measured: (W,
        # window, K) and the final epoch (W,) that maps slots to epochs
        out["telemetry"] = dram_f["tl_ring"].to(f32)
        out["telemetry_epoch"] = dram_f["tl_epoch"].to(f32)
    for k, name in _SCHED_SNAP.items():
        if k in sched_snap:
            out[name] = sched_f[k].to(f32) - sched_snap[k].to(f32)
    if energy_on:
        # per-source dynamic energy stays (W, S); per-channel background
        # collapses to totals, in nJ from the integer cycle counters
        out.update({
            "energy_act": d("e_act"),
            "energy_rw": d("e_rw"),
            # sb * standby + pd * pd_power, contracted by XLA into one
            # multiply-add
            "energy_bg": engine.fma_f32(
                _sum_channels(d("sb_cycles")), cfg.energy_standby,
                _sum_channels(d("pd_cycles"))
                * float(np.float32(cfg.energy_pd))),
            "energy_wake": _sum_channels(d("e_wake")),
            "pd_cycles": _sum_channels(d("pd_cycles")),
        })
    return out


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


def _pool_and_active(pool_batch, active_batch, dev):
    active = _host(active_batch)
    pool = prepare_pool(pool_batch, active.shape, dev)
    return pool, torch.as_tensor(active.astype(bool)).to(dev)


def _skip(skip) -> bool:
    return DEFAULT_SKIP if skip is None else bool(skip)


def prepare_run(cfg: SimConfig, policy: str, pool_batch: Dict[str, Any],
                active_batch, skip: bool = None, *, device=None):
    """(bound cfg, step, skip body, carry) of a batched run, nothing
    simulated yet: the pool and the zero state on the device. Every
    host-to-device copy of a run happens here; the cycle loop that follows
    makes none (the skipping loop reads one int64 per processed step). The
    skip body is None for a ticked run."""
    dev = resolve_device(device)
    pool, active = _pool_and_active(pool_batch, active_batch, dev)
    cfg, pol, carry = _init(cfg, policy, active.shape[0], dev)
    body = policy_api.make_skip_step(cfg, pol, pool, active) \
        if _skip(skip) else None
    return cfg, policy_api.make_step(cfg, pol, pool, active), body, carry


def simulate(cfg: SimConfig, policy: str, pool_batch: Dict[str, Any],
             active_batch, n_cycles: int = 20_000, warmup: int = 2_000,
             skip: bool = None, *, device=None) -> Dict[str, np.ndarray]:
    """pool_batch: dict of (W, S) arrays; active_batch: (W, S) bool.
    Returns (W, ...) numpy metrics."""
    out = _scan_and_measure(*prepare_run(cfg, policy, pool_batch,
                                         active_batch, skip, device=device),
                            n_cycles, warmup)
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
    return _debug_run(cfg, policy, pool, active, n_cycles, skip, device)


def _debug_run(cfg, policy, pool, active, n_cycles, skip, device,
               check=None):
    """`simulate_debug`, with `check(carry, t)` after each processed cycle
    (`validate.debug_check`)."""
    _check_pool(pool, (cfg.n_src,))
    batch = {k: _host(v)[None] for k, v in pool.items()}
    _, step, body, carry = prepare_run(cfg, policy, batch,
                                       _host(active).astype(bool)[None],
                                       skip, device=device)
    carry, _ = _run_cycles(step, body, carry, 0, n_cycles, check)
    return tuple({k: v[0] for k, v in _export_state(tree).items()}
                 for tree in carry)


# ---------------------------------------------------------------------------
# folded drivers: P slices (policies, knob points, or both) as P·W rows of
# one run. Each slice equals its solo run in every metric; on the stacked
# drivers `sim_steps` is the family's, per workload (one clock per workload).
# ---------------------------------------------------------------------------

def stackable_names(cfg: SimConfig, policies=None) -> Tuple[str, ...]:
    """The subset of `policies` (default: the whole registry) that joins the
    stacked cross-policy step under this config."""
    names = policy_api.names() if policies is None else policies
    return tuple(n for n in names if policy_api.is_stackable(n, cfg))


def _grid_slices(cfg: SimConfig, slices):
    """Slices (a policy name, or (name, overrides) mixing period-like and
    value-like knobs) as (names, per-slice configs with the period
    overrides, per-slice bound views)."""
    names, cfgs, bound = [], [], []
    for sl in slices:
        name, ov = (sl, {}) if isinstance(sl, str) else sl
        per, val = params.split_overrides(dict(ov))
        c = cfg.replace(**per)
        kn = params.Knobs.from_cfg(cfg, **val)
        names.append(name)
        cfgs.append(c)
        bound.append(params.bind(c, policy_api.resolve_knobs(
            c, policy_api.get(name), kn)))
    return names, cfgs, bound


def _fold(cfg: SimConfig, pols, W: int, dev):
    """The folded zero carry: the slices' scheduler states padded to the
    union schema, policy-major, beside P·W rows of engine state."""
    bufs = schedulers.stacked_union_state(cfg, pols, W, dev)
    R = len(pols) * W
    return (engine.source_state(cfg, R, dev), schedulers.fold_rows(bufs),
            engine.dram_state(cfg, R, dev))


def prepare_stacked_run(cfg: SimConfig, slices, pool_batch: Dict[str, Any],
                        active_batch, skip: bool = None, *, device=None):
    """(cfg, step, skip body, carry) of a stacked run over `slices` (policy
    names, or (name, overrides) pairs; policies may repeat), nothing
    simulated yet. Every slice must be stackable under its config; the
    slices share one clock per workload."""
    dev = resolve_device(device)
    pool, active = _pool_and_active(pool_batch, active_batch, dev)
    W = active.shape[0]
    names, cfgs, bound = _grid_slices(cfg, slices)
    bad = [n for n, c in zip(names, cfgs)
           if not policy_api.is_stackable(n, c)]
    if bad:
        raise ValueError(f"not stackable under this config: {bad}")
    pols = [policy_api.get(n) for n in names]
    # period overrides never touch a shape: one union schema for the family
    carry = _fold(cfg, pols, W, dev)
    row_cfg = params.row_config(cfg, bound, W, dev)
    step = schedulers.make_stacked_step(cfg, pols, pool, active, bound,
                                        row_cfg)
    body = schedulers.make_stacked_skip_step(
        cfg, pols, pool, active, bound, row_cfg, len(pols)) \
        if _skip(skip) else None
    return cfg, step, body, carry


def prepare_grid_run(cfg: SimConfig, policy: str, points,
                     pool_batch: Dict[str, Any], active_batch,
                     skip: bool = None, *, device=None):
    """(cfg, step, skip body, carry) of one policy at V knob points
    (value-knob override dicts or `Knobs`), nothing simulated yet. A
    stackable centralized policy takes the stacked step with V slices of
    itself; any other (sms) the folded step, its `tick` and `select` per
    slice. Every row keeps its own clock, as each point of the reference's
    grid does."""
    dev = resolve_device(device)
    pool, active = _pool_and_active(pool_batch, active_batch, dev)
    W = active.shape[0]
    pol = policy_api.get(policy)
    cfg = pol.configure(cfg)
    bound = [params.bind(cfg, policy_api.resolve_knobs(cfg, pol, kn))
             for kn in params.knob_points(cfg, points)]
    V = len(bound)
    row_cfg = params.row_config(cfg, bound, W, dev)
    body = None
    if isinstance(pol, schedulers.CentralizedPolicy) and pol.stackable:
        step = schedulers.make_stacked_step(cfg, [pol] * V, pool, active,
                                            bound, row_cfg)
        if _skip(skip):
            body = schedulers.make_stacked_skip_step(
                cfg, [pol] * V, pool, active, bound, row_cfg, 1)
    else:
        step = policy_api.make_folded_step(cfg, pol, pool, active, bound,
                                           row_cfg)
        if _skip(skip):
            body = policy_api.make_folded_skip_step(cfg, pol, pool, active,
                                                    bound, row_cfg)
    return cfg, step, body, _fold(cfg, [pol] * V, W, dev)


def _measure_slices(prep, n, n_cycles, warmup, W) -> list:
    """Run and measure a folded run; per-slice (W, ...) numpy metrics."""
    out = _scan_and_measure(*prep, n_cycles, warmup)
    host = {k: v.cpu().numpy() for k, v in out.items()}
    return [{k: v[i * W:(i + 1) * W] for k, v in host.items()}
            for i in range(n)]


def simulate_stacked(cfg: SimConfig, policies, pool_batch: Dict[str, Any],
                     active_batch, n_cycles: int = 20_000,
                     warmup: int = 2_000, skip: bool = None, *,
                     device=None) -> Dict[str, Dict[str, np.ndarray]]:
    """Per-policy (W, ...) metrics of a stacked family, keyed by name. Each
    slice equals the policy's own `simulate` run but for `sim_steps`, which
    is the family's: the slices share one clock per workload."""
    policies = tuple(policies)
    return dict(zip(policies, simulate_stacked_grid(
        cfg, policies, pool_batch, active_batch, n_cycles, warmup, skip,
        device=device)))


def simulate_grid(cfg: SimConfig, policy: str, points,
                  pool_batch: Dict[str, Any], active_batch,
                  n_cycles: int = 20_000, warmup: int = 2_000,
                  skip: bool = None, *, device=None) -> list:
    """Per-point (W, ...) metric dicts of one policy at the knob `points`
    (value-knob override dicts or `Knobs`), parallel to `points`. Each
    equals a `simulate` run with the same values baked into SimConfig;
    period-like knobs are refused here (see `simulate_stacked_grid`)."""
    points = list(points)
    prep = prepare_grid_run(cfg, policy, points, pool_batch, active_batch,
                            skip, device=device)
    W = _host(active_batch).shape[0]
    return _measure_slices(prep, len(points), n_cycles, warmup, W)


def simulate_stacked_grid(cfg: SimConfig, slices,
                          pool_batch: Dict[str, Any], active_batch,
                          n_cycles: int = 20_000, warmup: int = 2_000,
                          skip: bool = None, *, device=None) -> list:
    """Per-slice (W, ...) metric dicts of a (policy x knob point) grid,
    parallel to `slices`: policy names or (policy, overrides) pairs, the
    overrides mixing value-like knobs and period-like ones (each slice's
    hooks keep their own period as a Python int). Policies may repeat. Each
    slice equals a solo `simulate` run with its overrides baked into
    SimConfig, but for the family's `sim_steps`."""
    slices = list(slices)
    prep = prepare_stacked_run(cfg, slices, pool_batch, active_batch, skip,
                               device=device)
    W = _host(active_batch).shape[0]
    return _measure_slices(prep, len(slices), n_cycles, warmup, W)


def simulate_debug_stacked(cfg: SimConfig, policies, pool: Dict[str, Any],
                           active, n_cycles: int = 2_000, skip: bool = None,
                           *, device=None):
    """Stacked analog of `simulate_debug`: one workload, the family stacked.

    Returns {policy: (src_state, sched_state, dram_state)} numpy trees in
    the reference's dtypes: each policy's slice of the final stacked state,
    its scheduler state restricted to the policy's own (unpadded) keys.
    """
    policies = tuple(policies)
    dev = resolve_device(device)
    _check_pool(pool, (cfg.n_src,))
    batch = {k: _host(v)[None] for k, v in pool.items()}
    cfg, step, body, carry = prepare_stacked_run(
        cfg, policies, batch, _host(active).astype(bool)[None], skip,
        device=dev)
    carry, _ = _run_cycles(step, body, carry, 0, n_cycles)
    st_f, sched_f, dram_f = (_export_state(tree) for tree in carry)
    own = [set(policy_api.get(p).init_state(cfg, 1, dev)) for p in policies]
    take = lambda tree, i, keys=None: {
        k: v[i] for k, v in tree.items() if keys is None or k in keys}
    return {pol: (take(st_f, i), take(sched_f, i, own[i]), take(dram_f, i))
            for i, pol in enumerate(policies)}


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
