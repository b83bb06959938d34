"""Windowed flight recorder: time-resolved counters inside the cycle loop.

Port of ``repro/core/telemetry.py`` over the port's leading row axis: each
row keeps a `(telemetry_window, K)` int32 ring of epoch-downsampled
channels in `dram_state`. Cycle time is split into epochs of
`cfg.telemetry_epoch` cycles, epoch `e` accumulates into ring slot
`e % cfg.telemetry_window`, and a slot is zeroed exactly when it starts
representing a newer epoch, so the final ring holds the run's last
`telemetry_window` epochs.

Channels (`CHANNELS` order; int32 accumulators, zero-init):

  occ_*        sum over cycles of end-of-cycle in-flight requests per class;
  adm_*        admissions per class (pending register consumed);
  iss_*        DRAM issues per class;
  row_hits     row-hit issues (all classes);
  batch_marks  newly marked entries of the centralized buffer (0 for SMS);
  pd_chan      sum over cycles of channels in power-down at end of cycle
               (requires `energy_enabled`, else 0);
  steps        processed driver steps, the skip meter. Every channel
               before it (`N_INVARIANT`) is driver-invariant: ticked and
               variable-step runs give bit-identical values.

Gated by `cfg.telemetry_enabled` (off adds no op to the cycle); on never
feeds a value back into admission, scoring or timing. The variable-step
driver charges a skipped span with `skip_accrue`: frozen occupancy and the
closed-form power-down split, both integer counts.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.params import N_CLASSES, SimConfig

CHANNELS = (
    "occ_cpu", "occ_gpu", "occ_hwa",
    "adm_cpu", "adm_gpu", "adm_hwa",
    "iss_cpu", "iss_gpu", "iss_hwa",
    "row_hits", "batch_marks", "pd_chan",
    "steps",
)
K = len(CHANNELS)
CH = {name: i for i, name in enumerate(CHANNELS)}
# channels below this index are driver-invariant; `steps` is the skip meter
N_INVARIANT = CH["steps"]

# dram_state keys owned by this module
STATE_KEYS = ("tl_ring", "tl_epoch")


def telemetry_state(cfg: SimConfig, W: int, device) -> Dict[str, Any]:
    """Flight-recorder state merged into `engine.dram_state` when enabled:
    tl_ring (W, window, K) accumulators, tl_epoch (W,) the newest epoch
    each row's ring has advanced to."""
    if not cfg.telemetry_enabled:
        return {}
    return {
        "tl_ring": torch.zeros((W, cfg.telemetry_window, K),
                               dtype=torch.int32, device=device),
        "tl_epoch": torch.zeros((W,), dtype=torch.int32, device=device),
    }


def _slots(W: int, device) -> torch.Tensor:
    from repro_torch.core import engine
    return engine.device_const(
        ("tl_slots", W), device,
        lambda: torch.arange(W, dtype=torch.int32, device=device))


def _slot_epochs(W: int, e, device) -> torch.Tensor:
    """The newest epoch <= e that each ring slot represents: slot s holds
    epoch e - ((e - s) mod W). e: a host int -> (W,), or (R,) -> (R, W)."""
    s = _slots(W, device)
    if isinstance(e, torch.Tensor):
        e = e[..., None]
    return e - (e - s) % W


def _advance(W: int, ring, e_old, e_new):
    """Zero every slot whose represented epoch moved past its old one."""
    dev = ring.device
    stale = _slot_epochs(W, e_new, dev) > _slot_epochs(W, e_old, dev)
    return torch.where(stale[..., None], 0, ring)


def _class_sums(cls, v) -> torch.Tensor:
    """(R, S) int values -> (R, N_CLASSES) per-class sums."""
    v = v.to(torch.int32)
    return torch.stack([torch.sum(torch.where(cls == c, v, 0), dim=-1,
                                  dtype=torch.int32)
                        for c in range(N_CLASSES)], dim=-1)


def snapshot(st, sched, dram) -> Dict[str, Any]:
    """Pre-step counter snapshot; post-step deltas give this cycle's events
    without touching `engine.issue_channels` or any policy hook."""
    snap = {
        "emitted": st["emitted"],
        "pend_valid": st["pend_valid"],
        "issued": dram["issued"],
        "hits": dram["hits"],
    }
    if "marked" in sched:
        snap["marked"] = sched["marked"]
    return snap


def tick_accrue(cfg: SimConfig, pool, snap, st, sched, dram, t: int,
                own=None) -> Dict[str, Any]:
    """Charge cycle t's end-of-cycle values into each row's ring, after the
    policy's select. `own`: (R,) bool, the rows for which t is a cycle of
    their own clock (the variable-step driver's `steps` meter); None: all.
    """
    W, E = cfg.telemetry_window, cfg.telemetry_epoch
    R = st["emitted"].shape[0]
    e = t // E
    ring = _advance(W, dram["tl_ring"], dram["tl_epoch"], e)
    cls = pool["src_class"]
    # admission = pending register consumed: it was (or became) valid this
    # cycle and is no longer; at most one emission per source per cycle
    want = (st["emitted"] - snap["emitted"]) > 0
    admitted = (snap["pend_valid"] | want) & ~st["pend_valid"]
    i32 = torch.int32
    hits = torch.sum(dram["hits"] - snap["hits"], dim=-1, dtype=i32)
    if "marked" in snap:
        marks = torch.sum((sched["marked"] & ~snap["marked"]).reshape(R, -1),
                          dim=-1, dtype=i32)
    else:
        marks = torch.zeros_like(hits)
    if "pd_down" in dram:
        pd = torch.sum(dram["pd_down"], dim=-1, dtype=i32)
    else:
        pd = torch.zeros_like(hits)
    steps = torch.ones_like(hits) if own is None else own.to(i32)
    inc = torch.cat([
        _class_sums(cls, st["outstanding"]), _class_sums(cls, admitted),
        _class_sums(cls, dram["issued"] - snap["issued"]),
        torch.stack([hits, marks, pd, steps], dim=-1)], dim=-1)
    onehot = (_slots(W, ring.device) == e % W).to(i32)
    dram = dict(dram)
    dram["tl_ring"] = ring + onehot[:, None] * inc[:, None, :]
    dram["tl_epoch"] = torch.full_like(dram["tl_epoch"], e)
    return dram


def skip_accrue(cfg: SimConfig, pool, st, dram, t: int, t_new: int
                ) -> Dict[str, Any]:
    """Charge the jumped span t+1 .. t_new-1 in one add, exactly what the
    ticked driver's per-cycle `tick_accrue` would record: no event lands
    inside a span, so the event channels add zero, occupancy is frozen, and
    the only power-down transition is standby -> power-down at `enter =
    busy_until + energy_pd_idle` (mirroring `energy.skip_accrue`). Runs
    BEFORE `energy.skip_accrue`: it reads the pre-span `pd_down`. `steps`
    adds nothing: skipped cycles are not processed steps."""
    W, E = cfg.telemetry_window, cfg.telemetry_epoch
    dev = dram["tl_ring"].device
    a, b = t + 1, t_new - 1
    eb = b // E
    e_s = _slot_epochs(W, eb, dev)                          # (W,)
    lo = torch.clamp(e_s * E, min=a)
    hi = torch.clamp(e_s * E + E - 1, max=b)
    n_s = torch.clamp(hi - lo + 1, 0, E)                    # span cycles/slot
    ring = _advance(W, dram["tl_ring"], dram["tl_epoch"], eb)
    occ = _class_sums(pool["src_class"], st["outstanding"])  # (R, classes)
    zeros = torch.zeros_like(ring[..., 0])                  # (R, W)
    cols = [n_s * occ[:, c:c + 1] for c in range(N_CLASSES)]
    cols += [zeros] * (2 * N_CLASSES + 2)       # adm, iss, hits, marks
    if "pd_down" in dram:
        # per slot x channel: the span's cycles u of the slot with
        # end-of-cycle pd_down, i.e. pd_pre | (u >= enter)
        enter = (dram["busy_until"] + cfg.energy_pd_idle)[:, None, :]
        n3 = n_s[None, :, None]
        cnt = torch.where(
            dram["pd_down"][:, None, :], n3,
            torch.clamp(torch.clamp(hi[None, :, None]
                                    - torch.maximum(enter, lo[None, :, None])
                                    + 1, min=0), max=n3))
        cols.append(torch.sum(cnt, dim=-1, dtype=torch.int32))
    else:
        cols.append(zeros)
    cols.append(zeros)                                      # steps
    dram = dict(dram)
    dram["tl_ring"] = ring + torch.stack(cols, dim=-1).to(torch.int32)
    dram["tl_epoch"] = torch.clamp(dram["tl_epoch"], min=eb)
    return dram


# ---------------------------------------------------------------------------
# host-side helpers (numpy; used by metrics.timeline_breakdown)
# ---------------------------------------------------------------------------

def ring_epochs(W: int, final_epoch) -> np.ndarray:
    """Epoch index held by each ring slot at the end of a run (negative:
    the slot was never written and still holds zeros)."""
    s = np.arange(W)
    e = int(final_epoch)
    return e - np.mod(e - s, W)


def ordered_view(ring, final_epoch):
    """(W, K) ring -> (epochs ascending, (W, K) rows, valid mask)."""
    ring = np.asarray(ring)
    W = ring.shape[0]
    epochs = ring_epochs(W, final_epoch)
    order = np.argsort(epochs)
    return epochs[order], ring[order], epochs[order] >= 0
