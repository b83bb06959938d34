"""Centralized request-buffer substrate for `MemoryPolicy` implementations.

Port of the single-policy path of ``repro/core/schedulers.py``: the
per-channel CAM-style request buffer scored every cycle, as the base class
`CentralizedPolicy`. Subclasses override

    extra_state(cfg, W, device)            policy-private state tensors
    boundary_pred(cfg, pool, st, buf, t)   Python bool: run boundary_tick?
                                           (None = policy has no boundary)
    boundary_tick(cfg, pool, st, buf, t)   epoch/quantum/batch maintenance
    policy_tick(cfg, pool, st, buf, t)     cheap per-cycle maintenance
    score(cfg, pool, buf, is_hit, t)       (W, C, E) int32 score
    on_admit(cfg, pool, st, buf, do, slot, src, t)   per-admission hook
    on_issue(cfg, pool, buf, do, pick, src, t)       per-issue hook (buf is
                                                     the PRE-clear buffer)

Buffer shapes: (W, C, E). `t` is a Python int, and every boundary
predicate depends on `t` only, so the gate is a plain `if`.

Scores are lexicographic integers:

    [policy bits 22+] [rank 15..20] [row-hit 14] [age 0..13]

The stacked cross-policy step (`make_stacked_step`) folds a family of P
policies into the leading row axis, policy-major: P·W rows, slice i on rows
[i·W, (i+1)·W). The variable-step witnesses of the substrate
(`next_admission`, `next_issue_ready`, each policy's `next_boundary`) give
every policy `next_event`; `make_stacked_skip_step` is the stacked family's
skip body.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.core import energy, engine, telemetry, validate
from repro_torch.core.params import SimConfig

AGE_CAP = (1 << 14) - 1
HIT_BIT = 1 << 14
RANK_SHIFT = 15
POL_BIT = 1 << 22


def buffer_state(cfg: SimConfig, W: int, device) -> Dict[str, Any]:
    """The shared CAM buffer; policy-private arrays live in extra_state.
    `gpu_occ` mirrors the GPU-held entries per channel (admit +1, issue -1).
    """
    C, E = cfg.n_channels, cfg.buf_entries
    z = lambda dt: torch.zeros((W, C, E), dtype=dt, device=device)
    return {
        "valid": z(torch.bool), "src": z(torch.int32),
        "bank": z(torch.int32), "row": z(torch.int32),
        "birth": z(torch.int32), "marked": z(torch.bool),
        "gpu_occ": torch.zeros((W, C), dtype=torch.int32, device=device),
    }


def rank_pos(key: torch.Tensor) -> torch.Tensor:
    """Rank position of each element under an ascending stable sort along
    the last axis (0 = smallest), int32."""
    order = torch.argsort(key, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True).to(torch.int32)


def base_score(cfg: SimConfig, buf, is_hit, t) -> torch.Tensor:
    """FR-FCFS core: row hit above age. (W, C, E) int32."""
    age = torch.clamp(t - buf["birth"], 0, AGE_CAP)
    return is_hit.to(torch.int32) * HIT_BIT + age


def admit(cfg: SimConfig, pool, st, buf, t, key=None):
    """One admission per channel per cycle; lowest-key pending request wins
    (default key: birth, i.e. oldest first). GPU sources are blocked while
    they hold >= gpu_cap entries of the channel's buffer.

    Returns (st, buf, do, slot, src): per-channel (W, C) admission outcome.
    """
    S, C = cfg.n_src, cfg.n_channels
    is_gpu_src = pool["is_gpu"]                                 # (W, S)
    st = dict(st)
    buf = dict(buf)
    dev = is_gpu_src.device
    cidx = engine.arange(C, dev)
    ch = engine.channel_of(cfg, st["pend_bank"])                # (W, S)
    gpu_ok = buf["gpu_occ"] < cfg.gpu_cap                       # (W, C)
    cand = st["pend_valid"][:, None, :] & \
        (ch[:, None, :] == cidx[None, :, None]) & \
        (gpu_ok[:, :, None] | ~is_gpu_src[:, None, :])          # (W, C, S)
    has_free = ~torch.all(buf["valid"], dim=-1)                 # (W, C)
    key = st["pend_birth"] if key is None else key
    key = torch.where(cand, key[:, None, :], 2 ** 30)
    s = torch.argmin(key, dim=-1)                               # (W, C)
    do = engine.take(cand, s) & has_free
    slot = torch.argmin(buf["valid"].to(torch.uint8), dim=-1)   # first free
    wr = lambda a, v: engine.masked_set(a, slot, v, do)
    at_s = lambda a: torch.gather(a, -1, s)                     # (W, C)
    buf["valid"] = wr(buf["valid"], True)
    buf["src"] = wr(buf["src"], s.to(torch.int32))
    buf["bank"] = wr(buf["bank"],
                     engine.bank_in_channel(cfg, at_s(st["pend_bank"])))
    buf["row"] = wr(buf["row"], at_s(st["pend_row"]))
    buf["birth"] = wr(buf["birth"], at_s(st["pend_birth"]))
    buf["marked"] = wr(buf["marked"], False)
    buf["gpu_occ"] = buf["gpu_occ"] + (do & at_s(is_gpu_src)).to(torch.int32)
    taken = torch.any((engine.arange(S, dev) == s[..., None])
                      & do[..., None], dim=-2)                  # (W, S)
    st["pend_valid"] = st["pend_valid"] & ~taken
    return st, buf, do, slot.to(torch.int32), s.to(torch.int32)


class CentralizedPolicy:
    """`MemoryPolicy` base for single-stage CAM-buffer schedulers.

    `policy_tick` runs every cycle and must stay cheap; `boundary_tick`
    holds the epoch/quantum/batch maintenance, gated on `boundary_pred`.
    """

    name = "centralized"
    variant_of = None

    # keys `boundary_tick` may WRITE (everything else is read-only there)
    boundary_keys: tuple = ()

    # -- cross-policy stacking contract (see `make_stacked_step`) -----------
    # A stackable policy runs with its state padded to the family union
    # schema (sibling keys present but zero) and with `configure` leaving
    # cfg untouched. Opt out with `stackable = False`.
    stackable: bool = True
    # buf keys the tick-side hooks (on_admit/pre_tick/boundary_tick/
    # policy_tick) may WRITE; None = `boundary_keys`. The stacked step
    # re-concatenates only the union of these across the family: an
    # undeclared write is dropped on the stacked path.
    stacked_tick_keys: tuple = None
    # buf keys `on_issue` may WRITE (default: none).
    stacked_issue_keys: tuple = ()

    # -- per-policy hooks --------------------------------------------------
    def extra_state(self, cfg: SimConfig, W: int, device) -> Dict[str, Any]:
        return {}

    def pre_tick(self, cfg: SimConfig, pool, st, buf, t):
        """Per-cycle maintenance that must run BEFORE the boundary gate."""
        return buf

    def boundary_pred(self, cfg: SimConfig, pool, st, buf, t):
        """Gate for `boundary_tick`: a Python bool computed from `t` alone,
        or None (no boundary work)."""
        return None

    def boundary_tick(self, cfg: SimConfig, pool, st, buf, t):
        """Gated maintenance: may read any state, writes `boundary_keys`."""
        return buf

    def policy_tick(self, cfg: SimConfig, pool, st, buf, t):
        """Unconditional per-cycle maintenance."""
        return buf

    def score(self, cfg: SimConfig, pool, buf, is_hit, t) -> torch.Tensor:
        """Default: cached per-source priority + FR-FCFS base score."""
        s = base_score(cfg, buf, is_hit, t)
        if "pri_src" in buf:
            src = buf["src"]
            pri = torch.gather(buf["pri_src"], -1,
                               src.reshape(src.shape[0], -1).to(torch.int64))
            s = pri.reshape(src.shape) + s
        return s

    def on_admit(self, cfg: SimConfig, pool, st, buf, do, slot, src, t):
        """Per-admission accounting ((W, C) tensors, after the write)."""
        return buf

    def on_issue(self, cfg: SimConfig, pool, buf, do, pick, src, t):
        """Per-issue accounting. `buf` is PRE-clear."""
        return buf

    def admit_key(self, cfg: SimConfig, pool, st, buf, t):
        """(W, S) admission ordering key, lowest first (default: oldest)."""
        return st["pend_birth"]

    def next_boundary(self, cfg: SimConfig, pool, st, buf, t):
        """Earliest cycle > t at which `boundary_pred` could fire or other
        per-cycle policy state could change in a way the generic witnesses
        do not cover: a host int (a t-only boundary), a (W,) int tensor, or
        None (no boundary machinery). Early is safe, late is a bug."""
        return None

    # -- variable-step driver witness (see `policy.make_skip_step`) ---------
    def next_event(self, cfg: SimConfig, pool, st, buf, dram, t):
        """(W,) earliest cycle > t at which this policy's half of the cycle
        could do anything: admit, issue, or run boundary maintenance.
        Evaluated on post-cycle-t state."""
        te = engine.earliest(next_admission(cfg, pool, st, buf, t),
                             next_issue_ready(cfg, buf, dram, t))
        return engine.earliest(te, self.next_boundary(cfg, pool, st, buf, t))

    # -- invariant-sanitizer hooks (repro_torch.core.validate; run only when
    # cfg.validate_enabled) ------------------------------------------------
    def queued_requests(self, cfg: SimConfig, buf):
        """(W,) requests held in the buffer (total-flow conservation)."""
        return validate.nbool(buf["valid"])

    def check_invariants(self, cfg: SimConfig, pool, st, buf, t):
        """(W,) count of violated buffer invariants: the `gpu_occ` mirror
        matches a recount of GPU-held entries, occupancy stays within
        [0, E], and marks sit only on valid entries."""
        src = buf["src"]
        held_gpu = torch.gather(pool["is_gpu"], -1, src.reshape(
            src.shape[0], -1).to(torch.int64)).reshape(src.shape)
        occ = torch.sum(buf["valid"] & held_gpu, dim=-1, dtype=torch.int32)
        bad = validate.nbool(occ != buf["gpu_occ"])
        bad = bad + validate.nbool((buf["gpu_occ"] < 0)
                                   | (buf["gpu_occ"] > cfg.buf_entries))
        return bad + validate.nbool(buf["marked"] & ~buf["valid"])

    def audit_skip(self, cfg: SimConfig, pool, st, buf, dram, t, t_new):
        """Would-fire lateness predicates of a jumped span: admission and
        issue readiness re-derived inline (never the witness formulas) at
        the last skipped cycle u, valid because readiness is monotone over
        a frozen span; `next_boundary` evaluated at t may be reused."""
        if t_new - t <= 1:
            return {}
        u = t_new - 1
        ch = engine.channel_of(cfg, st["pend_bank"]).to(torch.int64)
        gpu_ok = buf["gpu_occ"] < cfg.gpu_cap
        has_free = ~torch.all(buf["valid"], dim=-1)
        adm = torch.any(st["pend_valid"] & torch.gather(has_free, -1, ch)
                        & (torch.gather(gpu_ok, -1, ch) | ~pool["is_gpu"]),
                        dim=-1)
        elig, _, _ = eligibility_grid(cfg, buf, dram, u)
        out = {"late_admission": adm.to(torch.int32),
               "late_issue": engine.row_any(elig).to(torch.int32)}
        nb = self.next_boundary(cfg, pool, st, buf, t)
        if isinstance(nb, torch.Tensor):
            out["late_boundary"] = (nb < t_new).to(torch.int32)
        elif nb is not None:
            out["late_boundary"] = int(nb < t_new)
        return out

    # -- MemoryPolicy protocol ---------------------------------------------
    def configure(self, cfg: SimConfig) -> SimConfig:
        return cfg

    def init_state(self, cfg: SimConfig, W: int, device) -> Dict[str, Any]:
        return {**buffer_state(cfg, W, device),
                **self.extra_state(cfg, W, device)}

    def tick_hooks(self, cfg: SimConfig, pool, st, buf, do, slot, src, t):
        """Everything policy-specific between admission and selection:
        per-admission accounting, cheap maintenance, the gated boundary
        work."""
        buf = self.on_admit(cfg, pool, st, buf, do, slot, src, t)
        buf = self.pre_tick(cfg, pool, st, buf, t)
        pred = self.boundary_pred(cfg, pool, st, buf, t)
        if pred is not None and not isinstance(pred, bool):
            raise TypeError(f"{self.name}: boundary_pred must return a "
                            f"Python bool computed from t, got {type(pred)}")
        if pred:
            new = self.boundary_tick(cfg, pool, st, buf, t)
            buf = {**buf, **{k: new[k] for k in self.boundary_keys}}
        buf = self.policy_tick(cfg, pool, st, buf, t)
        return buf

    def tick(self, cfg: SimConfig, pool, st, buf, t):
        st, buf, do, slot, src = admit(
            cfg, pool, st, buf, t,
            key=self.admit_key(cfg, pool, st, buf, t))
        buf = self.tick_hooks(cfg, pool, st, buf, do, slot, src, t)
        return st, buf

    def select(self, cfg: SimConfig, pool, st, buf, dram, t):
        """Pick + issue at most one request per channel, all at once."""
        elig, lat, is_hit = eligibility_grid(cfg, buf, dram, t)
        score = self.score(cfg, pool, buf, is_hit, t)
        score = torch.where(elig, score, -1)
        st, dram, do, pick, src = issue_picked(cfg, st, buf, dram, score,
                                               lat, is_hit, t)
        buf = self.on_issue(cfg, pool, buf, do, pick, src, t)
        buf = clear_picked(cfg, pool, buf, do, pick, src)
        return st, buf, dram


def eligibility_grid(cfg: SimConfig, buf, dram, t):
    """Per-entry issue legality for every channel: (W, C, E) elig/lat/hit."""
    return engine.eligibility(cfg, dram, buf["bank"], buf["row"],
                              buf["valid"], t)


def issue_picked(cfg: SimConfig, st, buf, dram, score, lat, is_hit, t):
    """argmax the masked score per channel and commit the issue to DRAM.

    Returns (st, dram, do, pick, src); `buf` is untouched (still pre-clear).
    """
    pick = torch.argmax(score, dim=-1).to(torch.int32)          # (W, C)
    at_pick = lambda a: engine.take(a, pick)
    do = at_pick(score) >= 0
    src = at_pick(buf["src"])
    dram, st = engine.issue_channels(
        cfg, dram, st, do, at_pick(buf["bank"]), at_pick(buf["row"]),
        src, at_pick(buf["birth"]), at_pick(lat), at_pick(is_hit), t)
    return st, dram, do, pick, src


def clear_picked(cfg: SimConfig, pool, buf, do, pick, src):
    """Free the issued entries and settle the GPU-occupancy counter."""
    buf = dict(buf)
    clear = lambda a: engine.masked_set(a, pick, False, do)
    buf["valid"] = clear(buf["valid"])
    buf["marked"] = clear(buf["marked"])
    buf["gpu_occ"] = buf["gpu_occ"] - \
        (do & torch.gather(pool["is_gpu"], -1, src.to(torch.int64))
         ).to(torch.int32)
    return buf


# ---------------------------------------------------------------------------
# variable-step witnesses of the centralized substrate (conservative-early,
# evaluated on post-cycle state; see ROADMAP "Variable-step driver contract")
# ---------------------------------------------------------------------------

def next_admission(cfg: SimConfig, pool, st, buf, t):
    """(R,) t+1 where a pending request could be admitted next cycle, else
    INF_T. Admissibility changes only through events other witnesses cover
    (a new pending request, a freed slot or a GPU-occupancy drop).
    `cfg.gpu_cap` may be a per-row (R, 1) tensor."""
    ch = engine.channel_of(cfg, st["pend_bank"]).to(torch.int64)  # (R, S)
    gpu_ok = buf["gpu_occ"] < cfg.gpu_cap                         # (R, C)
    has_free = ~torch.all(buf["valid"], dim=-1)                   # (R, C)
    ok = st["pend_valid"] & torch.gather(has_free, -1, ch) & \
        (torch.gather(gpu_ok, -1, ch) | ~pool["is_gpu"])
    return torch.where(torch.any(ok, dim=-1), t + 1, engine.INF_T)


def next_issue_ready(cfg: SimConfig, buf, dram, t):
    """(R,) earliest cycle > t at which a buffered entry becomes
    issue-eligible: `engine.eligibility`'s three timing gates (bank ready,
    tFAW window, bus ready) inverted per entry, their inputs frozen while no
    issue lands."""
    tm = cfg.timing
    bank = buf["bank"].to(torch.int64)
    take = lambda a: torch.gather(a, -1, bank)                   # (R, C, E)
    openv = take(dram["open_valid"])
    is_hit = openv & (take(dram["open_row"]) == buf["row"])
    lat = torch.where(is_hit, tm.lat_hit,
                      torch.where(openv, tm.lat_conflict, tm.lat_closed)
                      ).to(torch.int32)
    faw_ready = torch.amin(dram["act_ring"], dim=-1)[..., None] + tm.t_faw
    tau = torch.maximum(take(dram["bank_free"]),
                        torch.where(is_hit, engine.NEG_T, faw_ready))
    tau = torch.maximum(tau, dram["bus_free"][..., None] - lat)
    tau = torch.clamp(tau, min=t + 1)
    return engine.row_min(torch.where(buf["valid"], tau, engine.INF_T))


# ---------------------------------------------------------------------------
# Stacked cross-policy execution: a family of P centralized policies (or V
# knob points of one) in one step over P·W rows.
#
# The policies share the buffer layout and the engine half of the cycle and
# differ only in their hooks. So every policy's state is padded to the union
# schema and folded into the leading row axis, policy-major; per cycle the
# policy-independent work (completions, background energy, deadlines,
# sources, admission, eligibility, issue, clear) runs ONCE over all rows,
# while `admit_key`, `tick_hooks`, `score` and `on_issue` run per slice on
# row views with the unrepeated (W, S) pool and the slice's own bound
# config. Only the declared write-sets are re-concatenated.
# ---------------------------------------------------------------------------


def stacked_union_state(cfg: SimConfig, pols, W: int, device
                        ) -> List[Dict[str, Any]]:
    """Per-policy init states ((W, ...) tensors) padded to the family union
    schema: the same keys, shapes and dtypes in every dict. A key claimed by
    two policies with a different shape or dtype is a schema collision and
    refuses to stack."""
    states = [p.init_state(cfg, W, device) for p in pols]
    union: Dict[str, Any] = {}
    owner: Dict[str, str] = {}
    for p, s in zip(pols, states):
        for k, v in s.items():
            if k in union:
                u = union[k]
                if u.shape != v.shape or u.dtype != v.dtype:
                    raise ValueError(
                        f"stacked schema collision on {k!r}: "
                        f"{owner[k]} has {tuple(u.shape)}/{u.dtype}, "
                        f"{p.name} has {tuple(v.shape)}/{v.dtype}")
            else:
                union[k] = torch.zeros_like(v)
                owner[k] = p.name
    return [{**union, **s} for s in states]


def fold_rows(trees) -> Dict[str, torch.Tensor]:
    """Concatenate per-slice (W, ...) trees along the row axis."""
    return {k: torch.cat([t[k] for t in trees]) for k in trees[0]}


def row_views(tree: Dict[str, torch.Tensor], P: int, W: int) -> list:
    """The P slices of a folded tree, as views of rows [i·W, (i+1)·W)."""
    parts = {k: v.split(W) for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(P)]


def merge_rows(tree, views, news, keys) -> Dict[str, torch.Tensor]:
    """`tree` with each of `keys` re-concatenated from the slices' results;
    a key every slice returned untouched (its own view) keeps its tensor."""
    out = dict(tree)
    for k in keys:
        parts = [n[k] for n in news]
        if any(p is not v[k] for p, v in zip(parts, views)):
            out[k] = torch.cat(parts)
    return out


def shared_inputs(pool, active, P: int):
    """The pool and the active mask repeated P times along the rows, made
    once on the device (the shared work reads them; hooks get `pool`)."""
    return ({k: v.repeat(P, 1) for k, v in pool.items()},
            active.repeat(P, 1))


def make_stacked_step(cfg: SimConfig, pols, pool, active, cfgs, row_cfg):
    """One simulator cycle for P stacked centralized policies over P·W rows.

    `pool`/`active` are the unrepeated (W, S) tensors. `cfgs` are the
    slices' own config views (bound knob points, period overrides) for the
    per-slice hooks; `row_cfg` serves the shared work, with per-row values
    of the two value knobs it reads, admission's `gpu_cap` and the
    power-down `energy_pd_idle` (`params.row_config`).
    """
    P = len(pols)
    W = active.shape[0]
    rpool, ractive = shared_inputs(pool, active, P)
    tick_union = sorted(set().union(*(
        p.stacked_tick_keys if p.stacked_tick_keys is not None
        else p.boundary_keys for p in pols)))
    issue_union = sorted(set().union(*(p.stacked_issue_keys for p in pols)))
    split = lambda x: x.split(W)

    def step(carry, t: int, own=None):
        st, buf, dram = carry
        if cfg.telemetry_enabled:
            snap = telemetry.snapshot(st, buf, dram)
        st, dram = engine.completions_tick(st, dram, t)
        dram = energy.background_tick(row_cfg, dram, t)
        st = engine.deadline_tick(cfg, rpool, st, t)
        st = engine.source_tick(cfg, rpool, st, ractive, t)
        # admission: each slice's key, one merged admit
        sv, bv = row_views(st, P, W), row_views(buf, P, W)
        key = torch.cat([p.admit_key(cfgs[i], pool, sv[i], bv[i], t)
                         for i, p in enumerate(pols)])
        st, buf, do, slot, src = admit(row_cfg, rpool, st, buf, t, key=key)
        sv, bv = row_views(st, P, W), row_views(buf, P, W)
        do_, slot_, src_ = split(do), split(slot), split(src)
        new = [p.tick_hooks(cfgs[i], pool, sv[i], bv[i], do_[i], slot_[i],
                            src_[i], t) for i, p in enumerate(pols)]
        buf = merge_rows(buf, bv, new, tick_union)
        # selection: merged eligibility/issue, per-slice score + on_issue
        elig, lat, is_hit = eligibility_grid(cfg, buf, dram, t)
        bv, hit_ = row_views(buf, P, W), split(is_hit)
        score = torch.cat([p.score(cfgs[i], pool, bv[i], hit_[i], t)
                           for i, p in enumerate(pols)])
        score = torch.where(elig, score, -1)
        st, dram, do, pick, src = issue_picked(cfg, st, buf, dram, score,
                                               lat, is_hit, t)
        if issue_union:
            do_, pick_, src_ = split(do), split(pick), split(src)
            new = [p.on_issue(cfgs[i], pool, bv[i], do_[i], pick_[i],
                              src_[i], t) for i, p in enumerate(pols)]
            buf = merge_rows(buf, bv, new, issue_union)
        buf = clear_picked(cfg, rpool, buf, do, pick, src)
        if cfg.telemetry_enabled:
            dram = telemetry.tick_accrue(cfg, rpool, snap, st, buf, dram, t,
                                         own)
        if cfg.validate_enabled:
            # conservation laws per slice: policy invariants differ
            dram = add_violations(dram, slice_counts(
                pols, lambda i, p, sv, bv, dv: validate.tick_counts(
                    cfgs[i], pool, p, sv, bv, dv, t), st, buf, dram, W))
        return (st, buf, dram), None

    return step


def slice_counts(pols, fn, st, buf, dram, W: int) -> torch.Tensor:
    """fn(i, pol, st, buf, dram) on each slice's row views, re-folded."""
    P = len(pols)
    sv, bv, dv = (row_views(x, P, W) for x in (st, buf, dram))
    return torch.cat([fn(i, p, sv[i], bv[i], dv[i])
                      for i, p in enumerate(pols)])


def add_violations(dram, counts) -> Dict[str, Any]:
    return {**dram, "viol": dram["viol"] + counts}


def with_slices(te: torch.Tensor, nbs, W: int) -> torch.Tensor:
    """Per-row witnesses `te` folded with each slice's own witness `nbs[i]`
    (a host int, a (W,) tensor, or None) on its rows."""
    if all(nb is None for nb in nbs):
        return te
    if all(not isinstance(nb, torch.Tensor) for nb in nbs) and \
            len({nb for nb in nbs}) == 1:
        return engine.earliest(te, nbs[0])
    return torch.cat([engine.earliest(part, nb)
                      for part, nb in zip(te.split(W), nbs)])


def make_stacked_skip_step(cfg: SimConfig, pols, pool, active, cfgs,
                           row_cfg, fold: int):
    """The stacked family's skip body (see `policy.make_skip_step` for the
    solo one): the shared witnesses and accruals once over every row, each
    slice's `next_boundary` and the sanitizer's span audit per slice.
    `fold`: the slices share one clock per workload (fold = P, the stacked
    drivers) or each row has its own (fold = 1, a knob grid). None when a
    slice has no `next_event`."""
    if not all(hasattr(p, "next_event") for p in pols):
        return None
    P = len(pols)
    W = active.shape[0]
    rpool, ractive = shared_inputs(pool, active, P)

    def witness(carry, t: int):
        st, buf, dram = carry
        te = engine.next_source_event(cfg, rpool, st, ractive, t)
        te = engine.earliest(te, engine.next_completion(dram, t))
        te = engine.earliest(te, next_admission(row_cfg, rpool, st, buf, t))
        te = engine.earliest(te, next_issue_ready(cfg, buf, dram, t))
        sv, bv = row_views(st, P, W), row_views(buf, P, W)
        return with_slices(te, [p.next_boundary(cfgs[i], pool, sv[i], bv[i],
                                                t)
                                for i, p in enumerate(pols)], W)

    def accrue(carry, t: int, t_new: int):
        st, buf, dram = carry
        st = engine.skip_sources(cfg, rpool, st, ractive, t_new - t - 1)
        if cfg.telemetry_enabled:
            # before energy.skip_accrue: reads the pre-span pd_down
            dram = telemetry.skip_accrue(row_cfg, rpool, st, dram, t, t_new)
        dram = energy.skip_accrue(row_cfg, dram, t, t_new)
        if cfg.validate_enabled:
            dram = add_violations(dram, slice_counts(
                pols, lambda i, p, sv, bv, dv: validate.span_counts(
                    cfgs[i], pool, p, sv, bv, dv, active, t, t_new),
                st, buf, dram, W))
        return st, buf, dram

    return engine.SkipBody(witness, accrue, fold, cfg.telemetry_enabled)
