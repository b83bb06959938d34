"""Per-cycle invariant sanitizer: the third measurement-only subsystem.

Port of ``repro/core/validate.py`` over the port's leading row axis. Gated
by ``cfg.validate_enabled`` (default off), it accumulates int32 violation
counters in ``dram_state["viol"]``, one (NV,) vector per row:

  * DRAM timing compliance — an issue committed to a busy bank, an ACTIVATE
    inside a saturated tFAW window, a burst scheduled before the shared bus
    frees (checked on the pre-update state inside `engine.issue_channels`);
  * conservation laws — per-source ``emitted == completed + outstanding``,
    total ``outstanding == pending + queued + in-flight``, policy structure
    occupancy within declared bounds (the per-policy hooks below),
    ``sb_cycles + pd_cycles == cycles`` per channel, ``lat_hist`` row sums
    == ``issued``, ``frames_released == dl_met + dl_missed``, and the engine
    rng stream at its closed-form position;
  * a skip-witness lateness auditor for the variable-step driver: an event
    that would have fired inside a jumped span is counted. It checks direct
    would-fire predicates at the last skipped cycle ``u = t_new - 1``, never
    the witness formulas themselves.

The counters never feed back into scheduling. Per-policy hooks (optional):
``queued_requests(cfg, sched)``, ``check_invariants(cfg, pool, st, sched,
t)`` (each (R,) int32) and ``audit_skip(cfg, pool, st, sched, dram, t,
t_new)`` ({name: (R,) int32}). Every count sums over one row's own axes.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.params import CLS_CPU, CLS_GPU, CLS_HWA, SimConfig

# counter layout of dram_state["viol"]; the order is part of the metric schema
VIOLATIONS = (
    "busy_bank",        # issue committed to a bank before bank_free
    "tfaw",             # ACTIVATE inside a saturated four-ACT window
    "bus_conflict",     # data burst scheduled before the shared bus frees
    "req_conserve",     # per-source emitted != completed + outstanding
    "flow_conserve",    # outstanding != pending + queued + in-flight
    "occupancy",        # policy structure bounds / mirror counters broken
    "energy_bg",        # sb_cycles + pd_cycles != elapsed cycles (per chan)
    "lat_hist",         # latency histogram row sum != issued
    "frames",           # frames_released != dl_met + dl_missed
    "rng_stream",       # engine rng off its closed-form stream position
    "late_source",      # skip span jumped past a source emission
    "late_completion",  # skip span jumped past a completion-ring slot
    "late_admission",   # skip span jumped past an admission-ready cycle
    "late_issue",       # skip span jumped past an issue-eligible cycle
    "late_boundary",    # skip span jumped past a frame/policy boundary
)
NV = len(VIOLATIONS)
IDX = {n: i for i, n in enumerate(VIOLATIONS)}

# dram_state keys owned by this module
STATE_KEYS = ("viol",)


class InvariantViolation(RuntimeError):
    """Raised by `debug_check` at the first cycle with a violation."""


def validate_state(cfg: SimConfig, W: int, device) -> Dict[str, Any]:
    """Sanitizer counters for `engine.dram_state` ({} when disabled)."""
    if not cfg.validate_enabled:
        return {}
    return {"viol": torch.zeros((W, NV), dtype=torch.int32, device=device)}


def nbool(x: torch.Tensor) -> torch.Tensor:
    """(R,) int32 count of true (or nonzero) entries of each row."""
    return torch.sum(x.reshape(x.shape[0], -1).to(torch.int32), dim=-1,
                     dtype=torch.int32)


def bump(counts: Dict[str, Any], R: int, device) -> torch.Tensor:
    """Assemble the (R, NV) increment from named counts, each an (R,) tensor
    or a host int for every row (a missing name counts zero)."""
    unknown = set(counts) - set(VIOLATIONS)
    if unknown:
        raise KeyError(f"unknown violation counters: {sorted(unknown)}")
    cols = []
    for n in VIOLATIONS:
        c = counts.get(n, 0)
        if not isinstance(c, torch.Tensor):
            c = torch.full((R,), int(c), dtype=torch.int32, device=device)
        cols.append(c.to(torch.int32))
    return torch.stack(cols, dim=-1)


# ---------------------------------------------------------------------------
# DRAM timing compliance (called from engine.issue_channels, PRE-update)
# ---------------------------------------------------------------------------

def issue_counts(cfg: SimConfig, dram: Dict[str, Any], do_issue, bank, lat,
                 is_hit, t: int) -> torch.Tensor:
    """Timing-violation increments for one issue commit (args (R, C)):
    each check re-derives one `engine.eligibility` gate independently."""
    tm = cfg.timing
    bank_free = torch.gather(dram["bank_free"], -1,
                             bank.to(torch.int64)[..., None])[..., 0]
    busy = do_issue & (bank_free > t)
    oldest_act = torch.amin(dram["act_ring"], dim=-1)
    faw = do_issue & ~is_hit & ((t - oldest_act) < tm.t_faw)
    bus = do_issue & ((t + lat) < dram["bus_free"])
    return bump({"busy_bank": nbool(busy), "tfaw": nbool(faw),
                 "bus_conflict": nbool(bus)}, do_issue.shape[0],
                do_issue.device)


# ---------------------------------------------------------------------------
# end-of-cycle conservation laws
# ---------------------------------------------------------------------------

def tick_counts(cfg: SimConfig, pool: Dict[str, torch.Tensor], pol,
                st: Dict[str, Any], sched: Dict[str, Any],
                dram: Dict[str, Any], t: int) -> torch.Tensor:
    """Conservation-law increments on post-step state at cycle t, (R, NV).
    Each law is an exact identity of the update rules."""
    from repro_torch.core import engine
    R, dev = st["emitted"].shape[0], st["emitted"].device
    i32 = torch.int32
    c: Dict[str, Any] = {}
    c["req_conserve"] = nbool(
        st["emitted"] - st["completed"] != st["outstanding"])
    qfn = getattr(pol, "queued_requests", None)
    if qfn is not None:
        total = torch.sum(st["outstanding"], dim=-1, dtype=i32)
        held = (torch.sum(st["pend_valid"], dim=-1, dtype=i32)
                + qfn(cfg, sched)
                + torch.sum(dram["ring"].reshape(R, -1), dim=-1, dtype=i32))
        c["flow_conserve"] = (total != held).to(i32)
    chk = getattr(pol, "check_invariants", None)
    if chk is not None:
        c["occupancy"] = chk(cfg, pool, st, sched, t)
    if "sb_cycles" in dram:
        c["energy_bg"] = nbool(dram["sb_cycles"] + dram["pd_cycles"] != t + 1)
    if "lat_hist" in dram:
        c["lat_hist"] = nbool(
            torch.sum(dram["lat_hist"], dim=-1, dtype=i32) != dram["issued"])
    c["frames"] = nbool(
        st["frames_released"] != st["dl_met"] + st["dl_missed"])
    # the engine rng stream is a function of t alone (2 draws per cycle,
    # ticked or skipped): catches fast-forward off-by-ones exactly
    S = cfg.n_src
    rng0 = engine.device_const(
        ("rng0", S), dev, lambda: engine.u32_init(S, 2654435761, 12345, dev))
    c["rng_stream"] = nbool(st["rng"] != engine.lcg_skip(rng0, 2 * (t + 1)))
    return bump(c, R, dev)


# ---------------------------------------------------------------------------
# skip-witness lateness auditor (variable-step driver)
# ---------------------------------------------------------------------------

def span_counts(cfg: SimConfig, pool: Dict[str, torch.Tensor], pol,
                st: Dict[str, Any], sched: Dict[str, Any],
                dram: Dict[str, Any], active: torch.Tensor, t: int,
                t_new: int) -> torch.Tensor:
    """Lateness increments for the jumped span (t, t_new), evaluated after
    the closed-form accruals, (R, NV). Any would-fire event strictly inside
    the span breaks the witness contract."""
    from repro_torch.core import engine
    S = cfg.n_src
    R, dev = st["emitted"].shape[0], st["emitted"].device
    k = t_new - t - 1                    # skipped cycles (host)
    u = t_new - 1                        # the last skipped cycle
    cls = pool["src_class"]
    free = active & ~st["pend_valid"] & \
        (st["outstanding"] < engine.source_mshr(cfg, cls))
    # would-fire emission predicates at u: monotone in t over a frozen
    # span, so firing anywhere inside implies firing at u
    want_cpu = free & (cls == CLS_CPU) & \
        (st["insts_acc"] >= pool["inst_per_miss"])
    want_gpu = free & (cls == CLS_GPU)
    period = torch.clamp(pool["dl_period"], min=1)
    released = (u % period) >= \
        engine.frame_release_offset(S, u // period, pool["dl_jitter"])
    want_hwa = free & (cls == CLS_HWA) & released & \
        (st["period_done"] + st["outstanding"] < pool["dl_reqs"])
    c: Dict[str, Any] = {}
    if k >= 1:
        c["late_source"] = nbool(want_cpu | want_gpu | want_hwa)
    # completions due strictly inside the span: ring slot t+1+dt with
    # dt = (slot - (t+1)) mod RING and dt < min(k, RING)
    dt = (engine.arange(engine.RING, dev) - (t + 1)) % engine.RING
    pend = torch.any(dram["ring"] > 0, dim=-1)
    c["late_completion"] = nbool(pend & (dt < min(k, engine.RING)))
    # frame boundaries crossed inside [t+1, u]
    has_dl = pool["dl_period"] > 0
    c["late_boundary"] = nbool(has_dl & (u // period > t // period))
    afn = getattr(pol, "audit_skip", None)
    if afn is not None:
        for name, n in afn(cfg, pool, st, sched, dram, t, t_new).items():
            c[name] = c.get(name, 0) + n
    return bump(c, R, dev)


# ---------------------------------------------------------------------------
# host-side helpers
# ---------------------------------------------------------------------------

def summarize(v) -> Dict[str, int]:
    """Collapse a violations array of shape (..., NV) to {name: total}."""
    arr = np.asarray(v).astype(np.int64).reshape(-1, NV).sum(axis=0)
    return {n: int(x) for n, x in zip(VIOLATIONS, arr)}


def debug_check(cfg: SimConfig, policy, pool, active, n_cycles: int = 2_000,
                skip: bool = False, *, device=None):
    """Hard-fail debug mode on the solo path: run one workload with the
    sanitizer on and raise `InvariantViolation` at the first processed cycle
    whose counters go nonzero, naming the cycle and the counter vector. The
    counters are read on the host after every processed cycle (a debug
    mode). Returns the final (src, sched, dram) numpy trees on success."""
    from repro_torch.core import simulator as sim
    if not cfg.validate_enabled:
        cfg = cfg.replace(validate_enabled=True)

    def check(carry, t):
        v = carry[2]["viol"][0]
        if bool(torch.any(v != 0)):
            raise InvariantViolation(
                f"invariant violation at cycle {t}: counters "
                f"{v.cpu().tolist()}")

    return sim._debug_run(cfg, policy, pool, active, n_cycles, skip, device,
                          check)
