"""Deterministic fault injection for the invariant sanitizer.

Port of ``repro/core/faults.py``. Each injector breaks exactly one contract
that the sanitizer (`repro_torch.core.validate`) guards, by swapping the
port's module attribute that the cycle loop looks up at call time: a
sanitizer that never fires on a healthy run proves nothing unless each
violation class also fires under a fault made to break it.

  * `inject(name)` is a context manager: patch on entry, restore on exit,
    also on an exception.
  * The step and skip bodies call `engine.next_source_event`,
    `engine.completions_tick`, `engine.skip_sources` and
    `schedulers.issue_picked` through their modules on every cycle, so a
    patch fires in any run built or driven inside the `with` block. The
    stacked write-sets are read when a stacked step is built, so that fault
    needs the run to start inside the block (every `simulate*` does).
  * No injector touches `engine.lcg_skip` or any other function the
    sanitizer itself calls: the checker keeps its own view of the truth.

Registered faults (TARGETS: the violation counters each must trip;
SKIP_ONLY faults need a variable-step run):

  late_witness        the source-event witness returns 16 cycles late
  dropped_completion  the completion-ring slot is zeroed before it returns
                      to its source: requests vanish in flight
  double_issue        the issue mask is forced on whatever the eligibility
  rng_skew            the closed-form rng fast-forward is one step off per
                      span
  stacked_writeset    "msub" is dropped from PAR-BS's declared stacked
                      write-sets, so the counter silently desyncs
"""
from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch

from repro_torch.core import engine, policy as policy_api, schedulers

# violation counters each fault must flip (a fault may also trip collateral
# counters, but at least one target must fire)
TARGETS: Dict[str, Tuple[str, ...]] = {
    "late_witness": ("late_source", "late_boundary", "late_admission",
                     "late_issue"),
    "dropped_completion": ("flow_conserve",),
    "double_issue": ("busy_bank", "bus_conflict", "tfaw"),
    "rng_skew": ("rng_stream",),
    "stacked_writeset": ("occupancy",),
}

# faults that corrupt the variable-step span machinery: drive with skip=True
SKIP_ONLY = ("late_witness", "rng_skew")

# faults that live on the stacked multi-policy path only
STACKED_ONLY = ("stacked_writeset",)


@contextlib.contextmanager
def _patched(obj, attr, value):
    orig = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, orig)


def _late_witness():
    """The source-event witness reports 16 cycles past the truth, so the
    driver trusts a span holding real wake-ups."""
    orig = engine.next_source_event

    def skewed(cfg, pool, st, active, t):
        return orig(cfg, pool, st, active, t) + 16

    return _patched(engine, "next_source_event", skewed)


def _dropped_completion():
    """Zero the completion-ring slot before it returns to its source: the
    request was emitted and issued but never completes."""
    orig = engine.completions_tick

    def dropping(st, dram, t):
        ring = dram["ring"].clone()
        ring[..., t % engine.RING, :] = 0
        return orig(st, {**dram, "ring": ring}, t)

    return _patched(engine, "completions_tick", dropping)


def _double_issue():
    """Hand `issue_picked` the absolute score: picks without a legal
    candidate (score < 0) are committed anyway."""
    orig = schedulers.issue_picked

    def forced(cfg, st, buf, dram, score, lat, is_hit, t):
        return orig(cfg, st, buf, dram, torch.abs(score), lat, is_hit, t)

    return _patched(schedulers, "issue_picked", forced)


def _rng_skew():
    """Advance the source rng one extra step per skipped span: the stream
    check fires at the first processed cycle after the span."""
    orig = engine.skip_sources

    def skewed(cfg, pool, st, active, k):
        st = dict(orig(cfg, pool, st, active, k))
        if k > 0:
            st["rng"], _ = engine.lcg_step(st["rng"])
        return st

    return _patched(engine, "skip_sources", skewed)


def _stacked_writeset():
    """Drop "msub" from PAR-BS's declared stacked write-sets: the stacked
    step discards the hooks' updates to it, and the recount in
    `check_invariants` desyncs (occupancy)."""
    pol = policy_api.get("parbs")
    tick = tuple(k for k in pol.stacked_tick_keys if k != "msub")
    issue = tuple(k for k in pol.stacked_issue_keys if k != "msub")

    @contextlib.contextmanager
    def ctx():
        # instance attributes shadow the class declaration; delete to restore
        pol.stacked_tick_keys = tick
        pol.stacked_issue_keys = issue
        try:
            yield
        finally:
            del pol.stacked_tick_keys
            del pol.stacked_issue_keys

    return ctx()


FAULTS = {
    "late_witness": _late_witness,
    "dropped_completion": _dropped_completion,
    "double_issue": _double_issue,
    "rng_skew": _rng_skew,
    "stacked_writeset": _stacked_writeset,
}

if set(FAULTS) != set(TARGETS):
    raise ImportError("faults: FAULTS and TARGETS name different faults")


def inject(name: str):
    """Context manager arming fault `name` (see FAULTS). Deterministic: the
    same fault and the same run give the same violation counters."""
    if name not in FAULTS:
        raise KeyError(f"unknown fault {name!r}; known: {sorted(FAULTS)}")
    return FAULTS[name]()
