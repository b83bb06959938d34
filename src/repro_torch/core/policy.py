"""`MemoryPolicy` protocol + registry: one scheduler API for the whole port.

Port of ``repro/core/policy.py``. A policy is an object with

    name         registry key ("frfcfs", "sms", ...)
    variant_of   None, or the name of the policy this one is a configured
                 variant of (variants are excluded from the baseline sweep)
    configure(cfg)                    -> cfg     (static/shape changes only)
    configure_knobs(knobs)            -> knobs   (optional: pin value knobs,
                                                  e.g. sms_dash's dash=True)
    init_state(cfg, W, device)        -> sched   (dict of (W, ...) tensors)
    tick(cfg, pool, st, sched, t)     -> (st, sched)
    select(cfg, pool, st, sched, dram, t) -> (st, sched, dram)

and the simulator's cycle is one generic step (`make_step`) over whatever
policy object the registry hands back. `t` is a Python int.

`Registry` itself is domain-agnostic; `repro_torch.serving.scheduler` uses a
second instance, so the serving engine and the cycle sim enumerate policies
the same way. `is_stackable` says which policies join the stacked
cross-policy step (`schedulers.make_stacked_step`); `make_folded_step` runs
knob points of any other policy the same folded way. `make_skip_step` and
`make_folded_skip_step` are the variable-step driver's bodies beside them.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, Iterator, Optional, Protocol,
                    Tuple)

import torch

from repro_torch.core import (energy, engine, params, schedulers, telemetry,
                              validate)
from repro_torch.core.params import Knobs, SimConfig


class MemoryPolicy(Protocol):
    """Structural type for cycle-sim scheduling policies."""

    name: str
    variant_of: Optional[str]

    def configure(self, cfg: SimConfig) -> SimConfig: ...

    def init_state(self, cfg: SimConfig, W: int, device) -> Dict[str, Any]:
        ...

    def tick(self, cfg: SimConfig, pool, st, sched, t): ...

    def select(self, cfg: SimConfig, pool, st, sched, dram, t): ...


class Registry:
    """Ordered name -> object registry with a decorator interface.

    Mapping-style access (`reg["sms"]`, `reg["sms"] = obj`, `"sms" in reg`,
    `reg.keys()`) is supported so call sites and tests can treat a registry
    like the plain dicts it replaces.
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, name: Optional[str] = None) -> Callable:
        """Use as ``@reg.register("name")`` or ``@reg.register`` (reads
        the object's ``name`` attribute)."""
        def deco(obj, _name=name if isinstance(name, str) else None):
            key = _name or getattr(obj, "name", None)
            if not key:
                raise ValueError(f"{self.kind} needs a `name` to register")
            if key in self._entries:
                raise ValueError(f"duplicate {self.kind} {key!r}")
            self._entries[key] = obj
            return obj

        if name is None or isinstance(name, str):
            return deco
        return deco(name)                       # bare @reg.register on a class

    def get(self, name: str) -> Any:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(f"unknown {self.kind} {name!r}; "
                           f"registered: {', '.join(self._entries)}") from None

    def names(self) -> Tuple[str, ...]:
        return tuple(self._entries)

    def keys(self):
        return self._entries.keys()

    def items(self):
        return self._entries.items()

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __getitem__(self, name: str) -> Any:
        return self.get(name)

    def __setitem__(self, name: str, obj: Any) -> None:
        self._entries[name] = obj               # tests swap entries in-place


POLICY_REGISTRY = Registry("memory policy")


def register(cls):
    """Class decorator: instantiate and register a `MemoryPolicy`."""
    POLICY_REGISTRY.register(cls.name)(cls())
    return cls


def _ensure_builtin() -> None:
    # lazy, so `policy` stays import-cycle-free (policies import schedulers,
    # which imports engine); the built-ins self-register on first lookup
    from repro_torch.core import policies  # noqa: F401


def get(name: str) -> MemoryPolicy:
    _ensure_builtin()
    return POLICY_REGISTRY.get(name)


def names() -> Tuple[str, ...]:
    """All registered policies, in registration order."""
    _ensure_builtin()
    return POLICY_REGISTRY.names()


def baseline_names() -> Tuple[str, ...]:
    """Policies that are not configured variants of another policy."""
    _ensure_builtin()
    return tuple(n for n, p in POLICY_REGISTRY.items()
                 if getattr(p, "variant_of", None) is None)


def resolve_knobs(cfg: SimConfig, pol, knobs: Optional[Knobs] = None
                  ) -> Knobs:
    """The knob point a policy actually runs at: caller-supplied (or cfg
    defaults) filtered through the policy's optional `configure_knobs`."""
    kn = Knobs.from_cfg(cfg) if knobs is None else knobs
    ck = getattr(pol, "configure_knobs", None)
    return ck(kn) if ck is not None else kn


def is_stackable(name: str, cfg: SimConfig) -> bool:
    """True if `name` opts into the stacked cross-policy step: the policy
    declares `stackable`, its `configure` leaves cfg untouched and its
    `configure_knobs` is the identity at this config. Stacked slices share
    one static config and, by default, cfg's knob point, so a policy that
    pins either (sms_dash's dash=True) runs on its own."""
    pol = get(name)
    if not getattr(pol, "stackable", False) or pol.configure(cfg) != cfg:
        return False
    ck = getattr(pol, "configure_knobs", None)
    if ck is None:
        return True
    base = Knobs.from_cfg(cfg)
    resolved = ck(base)
    return all(torch.equal(getattr(resolved, f), getattr(base, f))
               for f in params.KNOB_FIELDS)


def make_step(cfg: SimConfig, pol: MemoryPolicy, pool, active):
    """One simulator cycle for every workload of the batch, generic over the
    policy object. `pool`/`active` are read-only (W, S) tensors closed over
    here; the carry holds only cycle-varying state. `own`: the rows whose
    own cycle this is (the variable-step driver's telemetry meter)."""

    def step(carry, t: int, own=None):
        st, sched, dram = carry
        if cfg.telemetry_enabled:
            snap = telemetry.snapshot(st, sched, dram)
        st, dram = engine.completions_tick(st, dram, t)
        dram = energy.background_tick(cfg, dram, t)
        st = engine.deadline_tick(cfg, pool, st, t)
        st = engine.source_tick(cfg, pool, st, active, t)
        st, sched = pol.tick(cfg, pool, st, sched, t)
        st, sched, dram = pol.select(cfg, pool, st, sched, dram, t)
        if cfg.telemetry_enabled:
            dram = telemetry.tick_accrue(cfg, pool, snap, st, sched, dram, t,
                                         own)
        if cfg.validate_enabled:
            # conservation laws hold as end-of-cycle identities
            dram = schedulers.add_violations(dram, validate.tick_counts(
                cfg, pool, pol, st, sched, dram, t))
        return (st, sched, dram), None

    return step


def make_skip_step(cfg: SimConfig, pol: MemoryPolicy, pool, active):
    """The variable-step body beside `make_step` (ROADMAP "Variable-step
    driver contract"): `witness` asks the engine and the policy for each
    row's earliest cycle > t at which anything could happen; `accrue`
    replays a skipped span's closed-form accruals (source rng and
    instruction progress, background energy, the policy's `on_skip`). Hooks
    never observe the step size. None when `pol` has no `next_event`: the
    driver then ticks every cycle."""
    if not hasattr(pol, "next_event"):
        return None
    on_skip = getattr(pol, "on_skip", None)

    def witness(carry, t: int):
        st, sched, dram = carry
        te = engine.next_source_event(cfg, pool, st, active, t)
        te = engine.earliest(te, engine.next_completion(dram, t))
        return engine.earliest(te, pol.next_event(cfg, pool, st, sched, dram,
                                                  t))

    def accrue(carry, t: int, t_new: int):
        st, sched, dram = carry
        k = t_new - t - 1
        st = engine.skip_sources(cfg, pool, st, active, k)
        if cfg.telemetry_enabled:
            # before energy.skip_accrue: reads the pre-span pd_down
            dram = telemetry.skip_accrue(cfg, pool, st, dram, t, t_new)
        dram = energy.skip_accrue(cfg, dram, t, t_new)
        if on_skip is not None:
            sched = on_skip(cfg, sched, k)
        if cfg.validate_enabled:
            # lateness audit of the jumped span, on post-accrual state
            dram = schedulers.add_violations(dram, validate.span_counts(
                cfg, pool, pol, st, sched, dram, active, t, t_new))
        return st, sched, dram

    return engine.SkipBody(witness, accrue, 1, cfg.telemetry_enabled)


def make_folded_step(cfg: SimConfig, pol: MemoryPolicy, pool, active, cfgs,
                     row_cfg):
    """One cycle for V knob points of one policy folded into V·W rows, for
    a policy outside the stacked family (sms): the engine work runs once
    over every row; the policy's `tick` and `select` run per slice, on row
    views of the state, with the unrepeated (W, S) pool and the slice's
    own bound config `cfgs[i]`. `row_cfg` serves the shared work's two
    value knobs (`params.row_config`). Only tensors some slice replaced
    are re-concatenated."""
    V, W = len(cfgs), active.shape[0]
    rpool, ractive = schedulers.shared_inputs(pool, active, V)
    views = lambda tree: schedulers.row_views(tree, V, W)
    merge = schedulers.merge_rows

    def step(carry, t: int, own=None):
        st, sched, dram = carry
        if cfg.telemetry_enabled:
            snap = telemetry.snapshot(st, sched, dram)
        st, dram = engine.completions_tick(st, dram, t)
        dram = energy.background_tick(row_cfg, dram, t)
        st = engine.deadline_tick(cfg, rpool, st, t)
        st = engine.source_tick(cfg, rpool, st, ractive, t)
        sv, cv = views(st), views(sched)
        new = [pol.tick(cfgs[i], pool, sv[i], cv[i], t) for i in range(V)]
        st = merge(st, sv, [n[0] for n in new], st.keys())
        sched = merge(sched, cv, [n[1] for n in new], sched.keys())
        sv, cv, dv = views(st), views(sched), views(dram)
        new = [pol.select(cfgs[i], pool, sv[i], cv[i], dv[i], t)
               for i in range(V)]
        st = merge(st, sv, [n[0] for n in new], st.keys())
        sched = merge(sched, cv, [n[1] for n in new], sched.keys())
        dram = merge(dram, dv, [n[2] for n in new], dram.keys())
        if cfg.telemetry_enabled:
            dram = telemetry.tick_accrue(cfg, rpool, snap, st, sched, dram, t,
                                         own)
        if cfg.validate_enabled:
            dram = schedulers.add_violations(dram, schedulers.slice_counts(
                [pol] * V, lambda i, p, s_, c_, d_: validate.tick_counts(
                    cfgs[i], pool, p, s_, c_, d_, t), st, sched, dram, W))
        return (st, sched, dram), None

    return step


def make_folded_skip_step(cfg: SimConfig, pol: MemoryPolicy, pool, active,
                          cfgs, row_cfg):
    """The variable-step body beside `make_folded_step`: the engine's
    witnesses and accruals once over every row, the policy's `next_event`,
    `on_skip` and span audit per slice. Each row keeps its own clock, as
    each knob point of the reference's grid does. None when `pol` has no
    `next_event`."""
    if not hasattr(pol, "next_event"):
        return None
    V, W = len(cfgs), active.shape[0]
    rpool, ractive = schedulers.shared_inputs(pool, active, V)
    views = lambda tree: schedulers.row_views(tree, V, W)
    on_skip = getattr(pol, "on_skip", None)

    def witness(carry, t: int):
        st, sched, dram = carry
        te = engine.next_source_event(cfg, rpool, st, ractive, t)
        te = engine.earliest(te, engine.next_completion(dram, t))
        sv, cv, dv = views(st), views(sched), views(dram)
        return torch.cat([engine.earliest(part, pol.next_event(
            cfgs[i], pool, sv[i], cv[i], dv[i], t))
            for i, part in enumerate(te.split(W))])

    def accrue(carry, t: int, t_new: int):
        st, sched, dram = carry
        k = t_new - t - 1
        st = engine.skip_sources(cfg, rpool, st, ractive, k)
        if cfg.telemetry_enabled:
            dram = telemetry.skip_accrue(row_cfg, rpool, st, dram, t, t_new)
        dram = energy.skip_accrue(row_cfg, dram, t, t_new)
        if on_skip is not None:
            cv = views(sched)
            sched = schedulers.merge_rows(
                sched, cv, [on_skip(cfgs[i], cv[i], k) for i in range(V)],
                sched.keys())
        if cfg.validate_enabled:
            dram = schedulers.add_violations(dram, schedulers.slice_counts(
                [pol] * V, lambda i, p, s_, c_, d_: validate.span_counts(
                    cfgs[i], pool, p, s_, c_, d_, active, t, t_new),
                st, sched, dram, W))
        return st, sched, dram

    return engine.SkipBody(witness, accrue, 1, cfg.telemetry_enabled)
