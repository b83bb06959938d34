"""Staged Memory Scheduler — the paper's contribution (§2).

Port of ``repro/core/sms.py`` over the leading workload axis. Three
decoupled stages, all simple FIFOs:
  1. per-source batch formation FIFOs (W, C, S, F): consecutive
     same-(bank,row) requests form a batch; ready on row-change / age
     threshold / full FIFO;
  2. batch scheduler: picks a ready batch — SJF (fewest in-flight across all
     stages) with probability p, round-robin with 1-p — then drains it one
     request/cycle into stage 3;
  3. DRAM command scheduler (DCS): per-bank FIFOs (W, C, B, D); only FIFO
     heads issue; DRAM timing legality enforced; round-robin across banks.

Stages 1+2 form the registered policy's `tick`, stage 3 its `select`. The
stage-2 rng (`rng2`) is a uint32 LCG held in int64, like the source rng.
`next_stage_event` and `skip_cycles` are the variable-step driver's witness
and span replay; `check_invariants` and `audit_skip` the sanitizer's hooks.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core import engine
from repro_torch.core.params import CLS_HWA, SimConfig, static_bool


def sms_state(cfg: SimConfig, W: int, device) -> Dict[str, Any]:
    C, S, F = cfg.n_channels, cfg.n_src, cfg.fifo_size
    B, D = cfg.n_banks, cfg.dcs_size
    zi = lambda *s: torch.zeros((W,) + s, dtype=torch.int32, device=device)
    return {
        # stage 1: per-source FIFOs
        "f_row": zi(C, S, F), "f_bank": zi(C, S, F), "f_birth": zi(C, S, F),
        "f_head": zi(C, S), "f_len": zi(C, S),
        # front_run: length of the front same-(bank,row) run of each FIFO,
        # maintained at push/pop
        "front_run": zi(C, S),
        # stage 2: batch scheduler
        "drain_src": torch.full((W, C), -1, dtype=torch.int32, device=device),
        "drain_left": zi(C),
        "rr_ptr": zi(C),
        "rng2": ((torch.arange(1, C + 1, dtype=torch.int64, device=device)
                  * 40503) & engine.U32).expand(W, C).clone(),
        # stage 3: per-bank DCS FIFOs
        "d_row": zi(C, B, D), "d_src": zi(C, B, D), "d_birth": zi(C, B, D),
        "d_head": zi(C, B), "d_len": zi(C, B), "rr_bank": zi(C),
    }


def _row_of(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """a[w, c, s[w, c], :] for a (W, C, S, F) and s (W, C): (W, C, F)."""
    idx = s.to(torch.int64)[..., None, None].expand(
        s.shape + (1, a.shape[-1]))
    return torch.gather(a, -2, idx)[..., 0, :]


def _at_channel(a: torch.Tensor, ch: torch.Tensor) -> torch.Tensor:
    """a[w, ch[w, s], s, ...] for a (W, C, S, ...) and ch (W, S)."""
    idx = ch.to(torch.int64)[:, None]
    idx = idx.reshape(idx.shape + (1,) * (a.dim() - 3)).expand(
        (a.shape[0], 1) + a.shape[2:])
    return torch.gather(a, 1, idx)[:, 0]


def _run_from_head(rows, banks, head, length, F):
    """Front same-(bank,row) run length of one FIFO per channel.

    rows/banks: (..., F) slot arrays; head/length: (...). int32.
    """
    idx = (head.to(torch.int64)[..., None]
           + engine.arange(F, rows.device)) % F
    rows_o = torch.gather(rows, -1, idx)
    banks_o = torch.gather(banks, -1, idx)
    in_r = engine.arange(F, rows.device) < length[..., None]
    eq = (rows_o == rows_o[..., :1]) & (banks_o == banks_o[..., :1]) & in_r
    run = torch.sum(torch.cumprod(eq.to(torch.int32), dim=-1), dim=-1)
    return run.to(torch.int32)


def batch_info(cfg: SimConfig, sms: Dict[str, Any], t):
    """(W, C, S) tensors: batch_len (front same-(bank,row) run) and
    readiness. Only the head birth is gathered, never the whole FIFO."""
    batch_len = sms["front_run"]
    nonempty = sms["f_len"] > 0
    row_changed = batch_len < sms["f_len"]
    head_birth = engine.take(sms["f_birth"], sms["f_head"])            # (W, C, S)
    aged = nonempty & ((t - head_birth) >= cfg.batch_age_cap)
    full = sms["f_len"] >= cfg.fifo_size
    ready = nonempty & (row_changed | aged | full)
    return batch_len, ready


def stage1_admit(cfg: SimConfig, st, sms, t):
    """Decentralized admission: every source pushes into its own FIFO."""
    C, S, F = cfg.n_channels, cfg.n_src, cfg.fifo_size
    st = dict(st)
    sms = dict(sms)
    dev = st["pend_bank"].device
    ch = engine.channel_of(cfg, st["pend_bank"])                # (W, S)
    flen = _at_channel(sms["f_len"], ch)                        # (W, S)
    room = flen < F
    do = st["pend_valid"] & room
    head = _at_channel(sms["f_head"], ch)
    slot = (head + flen) % F
    new_bank = engine.bank_in_channel(cfg, st["pend_bank"])
    # each source maps to exactly one channel this cycle: one-hot writes
    mask_cs = (engine.arange(C, dev)[None, :, None] == ch[:, None, :]) \
        & do[:, None, :]                                        # (W, C, S)
    mask_csf = mask_cs[..., None] & \
        (engine.arange(F, dev) == slot[:, None, :, None])  # (W,C,S,F)
    # front_run: a push extends the front batch only when the whole FIFO is
    # that batch and the new request matches its (bank, row); a push into an
    # empty FIFO starts a run of 1
    fr = _at_channel(sms["front_run"], ch)
    extend = (fr == flen) & \
        (st["pend_row"] == engine.take(_at_channel(sms["f_row"], ch), head)) & \
        (new_bank == engine.take(_at_channel(sms["f_bank"], ch), head))
    new_fr = torch.where(flen == 0, 1, torch.where(extend, fr + 1, fr))
    sms["front_run"] = torch.where(mask_cs, new_fr[:, None, :],
                                   sms["front_run"])
    wr = lambda a, v: torch.where(mask_csf, v[:, None, :, None], a)
    sms["f_row"] = wr(sms["f_row"], st["pend_row"])
    sms["f_bank"] = wr(sms["f_bank"], new_bank)
    sms["f_birth"] = wr(sms["f_birth"], st["pend_birth"])
    sms["f_len"] = sms["f_len"] + mask_cs.to(torch.int32)
    st["pend_valid"] = st["pend_valid"] & ~do
    return st, sms


def stage2_drain(cfg: SimConfig, pool, st, sms, t):
    """Pick ready batches (SJF w.p. p / RR w.p. 1-p) and drain 1 req/cycle."""
    S, F, D = cfg.n_src, cfg.fifo_size, cfg.dcs_size
    sms = dict(sms)
    dev = st["emitted"].device
    batch_len, ready = batch_info(cfg, sms, t)

    # --- pick a new batch on idle channels ---
    idle = sms["drain_left"] <= 0
    rng2, u = engine.lcg_step(sms["rng2"])
    sms["rng2"] = rng2
    use_sjf = u < cfg.sjf_prob                                  # (W, C)
    inflight = st["emitted"] - st["completed"]                  # (W, S)
    sjf_key = torch.where(ready, inflight[:, None, :], 1 << 28)
    sjf_pick = torch.argmin(sjf_key, dim=-1)
    rr_off = (engine.arange(S, dev) - sms["rr_ptr"][..., None]) % S
    rr_key = torch.where(ready, rr_off, 1 << 28)
    rr_pick = torch.argmin(rr_key, dim=-1)
    pick = torch.where(use_sjf, sjf_pick, rr_pick)
    # `dash` is a value knob resolved on the host at bind time: off keeps
    # the block out of the step; a tensor knob keeps it and masks with it
    dash_on = static_bool(cfg.dash)
    if dash_on is not False:
        # SMS-DASH: an HWA whose frame slack is below its estimated
        # remaining service time preempts the SJF/RR choice;
        # least-slack-first among urgent ready batches
        has_dl = (pool["src_class"] == CLS_HWA) & (pool["dl_period"] > 0)
        remaining = torch.clamp(pool["dl_reqs"] - st["period_done"], min=0)
        time_left = pool["dl_period"] - (
            t % torch.clamp(pool["dl_period"], min=1))
        slack = time_left.to(torch.float32) - \
            remaining.to(torch.float32) * cfg.dash_svc_est
        urgent = has_dl & (slack < 0.0) & (remaining > 0)
        urgent_ready = ready & urgent[:, None, :]
        u_key = torch.where(urgent_ready, slack[:, None, :], 1e30)
        u_pick = torch.argmin(u_key, dim=-1)
        any_urgent = torch.any(urgent_ready, dim=-1)
        if dash_on is None:
            any_urgent = any_urgent & cfg.dash
        pick = torch.where(any_urgent, u_pick, pick)
        use_sjf = use_sjf | any_urgent      # don't advance rr on preempt
    any_ready = torch.any(ready, dim=-1)
    start = idle & any_ready
    sms["drain_src"] = torch.where(start, pick.to(torch.int32),
                                   sms["drain_src"])
    sms["drain_left"] = torch.where(start, engine.take(batch_len, pick),
                                    sms["drain_left"])
    sms["rr_ptr"] = torch.where(start & ~use_sjf, (pick + 1) % S,
                                sms["rr_ptr"]).to(torch.int32)

    # --- drain one request per channel into the DCS ---
    draining = sms["drain_left"] > 0
    s = torch.clamp(sms["drain_src"], 0, S - 1).to(torch.int64)  # (W, C)
    head = engine.take(sms["f_head"], s)
    rows = _row_of(sms["f_row"], s)                             # (W, C, F)
    banks = _row_of(sms["f_bank"], s)
    row = engine.take(rows, head)
    bank = engine.take(banks, head)
    birth = engine.take(_row_of(sms["f_birth"], s), head)
    flen = engine.take(sms["f_len"], s)
    has_req = flen > 0
    # safety: a desynced drain counter on an empty FIFO must not deadlock
    sms["drain_left"] = torch.where(draining & ~has_req, 0,
                                    sms["drain_left"])
    d_len_b = engine.take(sms["d_len"], bank)
    dcs_room = d_len_b < D
    do = draining & has_req & dcs_room
    # pop stage-1
    new_head = torch.where(do, (head + 1) % F, head)
    new_len = flen - do.to(torch.int32)
    sms["f_head"] = engine.masked_set(sms["f_head"], s, new_head, do)
    sms["f_len"] = engine.masked_add(sms["f_len"], s, -1, do)
    sms["drain_left"] = sms["drain_left"] - do.to(torch.int32)
    # front_run: the pop shortens the front batch by one; when it exhausts
    # the batch with requests left, rescan just this source's FIFO
    fr = engine.take(sms["front_run"], s) - do.to(torch.int32)
    rescan = do & (fr == 0) & (new_len > 0)
    fr = torch.where(rescan, _run_from_head(rows, banks, new_head, new_len, F),
                     fr)
    sms["front_run"] = engine.masked_set(sms["front_run"], s, fr, do)
    # push stage-3
    dslot = (engine.take(sms["d_head"], bank) + d_len_b) % D
    wr = lambda a, v: engine.masked_set2(a, bank, dslot, v, do)
    sms["d_row"] = wr(sms["d_row"], row)
    sms["d_src"] = wr(sms["d_src"], s.to(torch.int32))
    sms["d_birth"] = wr(sms["d_birth"], birth)
    sms["d_len"] = engine.masked_add(sms["d_len"], bank, 1, do)
    return st, sms


def stage3_issue(cfg: SimConfig, st, sms, dram, t):
    """DCS: issue from per-bank FIFO heads, RR across eligible banks, every
    channel of every workload at once."""
    B, D = cfg.n_banks, cfg.dcs_size
    sms = dict(sms)
    head = sms["d_head"]                                        # (W, C, B)
    row = engine.take(sms["d_row"], head)
    src = engine.take(sms["d_src"], head)
    birth = engine.take(sms["d_birth"], head)
    valid = sms["d_len"] > 0
    banks = engine.arange(B, head.device).expand(head.shape)
    elig, lat, is_hit = engine.eligibility(cfg, dram, banks, row, valid, t)
    rr_key = torch.where(
        elig, (engine.arange(B, head.device)
               - sms["rr_bank"][..., None]) % B, 1 << 28)
    pick = torch.argmin(rr_key, dim=-1)                         # (W, C)
    at_pick = lambda a: engine.take(a, pick)
    do = at_pick(elig)
    dram, st = engine.issue_channels(
        cfg, dram, st, do, pick, at_pick(row), at_pick(src), at_pick(birth),
        at_pick(lat), at_pick(is_hit), t)
    head_p = engine.take(head, torch.where(do, pick, 0))
    sms["d_head"] = engine.masked_set(sms["d_head"], pick, (head_p + 1) % D,
                                      do)
    sms["d_len"] = engine.masked_add(sms["d_len"], pick, -1, do)
    sms["rr_bank"] = torch.where(do, (pick + 1) % B,
                                 sms["rr_bank"]).to(torch.int32)
    return st, sms, dram


# ---------------------------------------------------------------------------
# variable-step driver witnesses (ROADMAP "Variable-step driver contract")
# ---------------------------------------------------------------------------

def _stage_ready(cfg: SimConfig, st, sms, t):
    """(W,) stage 1 (a pending register with FIFO room) and stage 2 (an
    active drain, or an idle channel with a ready batch) at cycle t."""
    ch = engine.channel_of(cfg, st["pend_bank"])
    room = _at_channel(sms["f_len"], ch) < cfg.fifo_size
    s1 = torch.any(st["pend_valid"] & room, dim=-1)
    _, ready = batch_info(cfg, sms, t)
    idle = sms["drain_left"] <= 0
    s2 = torch.any(~idle, dim=-1) | \
        torch.any(idle & torch.any(ready, dim=-1), dim=-1)
    return s1, s2, ready


def _dcs_heads(cfg: SimConfig, sms, dram, t):
    """Issue eligibility of every per-bank DCS head at cycle t, (W, C, B)."""
    head = sms["d_head"]
    banks = engine.arange(cfg.n_banks, head.device).expand(head.shape)
    row = engine.take(sms["d_row"], head)
    return engine.eligibility(cfg, dram, banks, row, sms["d_len"] > 0, t)[0]


def next_stage_event(cfg: SimConfig, st, sms, dram, t):
    """(W,) earliest cycle > t at which any of the three stages could act:
    stage 1 while a pending register has FIFO room; stage 2 while a channel
    drains or could start a batch, and the age at which a quiet front batch
    turns ready; stage 3 the DRAM timing gates of the DCS heads, inverted.
    The dash pick needs no witness: it is consulted only when a drain
    starts, which is witnessed."""
    tm = cfg.timing
    INF = engine.INF_T
    t1 = t + 1
    s1, s2, ready = _stage_ready(cfg, st, sms, t)
    w1 = torch.where(s1, t1, INF)
    w2 = torch.where(s2, t1, INF)
    # aging: a nonempty, not-yet-ready FIFO turns ready at head_birth + cap
    head_birth = engine.take(sms["f_birth"], sms["f_head"])      # (W, C, S)
    w_age = engine.row_min(torch.where(
        (sms["f_len"] > 0) & ~ready,
        torch.clamp(head_birth + cfg.batch_age_cap, min=t1), INF))
    # stage 3: the DCS heads' issue-eligibility times
    row = engine.take(sms["d_row"], sms["d_head"])               # (W, C, B)
    openv = dram["open_valid"]
    is_hit = openv & (dram["open_row"] == row)
    lat = torch.where(is_hit, tm.lat_hit,
                      torch.where(openv, tm.lat_conflict, tm.lat_closed)
                      ).to(torch.int32)
    faw_ready = torch.amin(dram["act_ring"], dim=-1)[..., None] + tm.t_faw
    tau = torch.maximum(dram["bank_free"],
                        torch.where(is_hit, engine.NEG_T, faw_ready))
    tau = torch.maximum(tau, dram["bus_free"][..., None] - lat)
    tau = torch.clamp(tau, min=t1)
    w3 = engine.row_min(torch.where(sms["d_len"] > 0, tau, INF))
    return torch.minimum(torch.minimum(w1, w2),
                         torch.minimum(w_age, w3).to(torch.int64))


def skip_cycles(sms: Dict[str, Any], k: int) -> Dict[str, Any]:
    """Replay k skipped cycles of stage-2 state in closed form: the batch
    scheduler draws `rng2` once per cycle."""
    return {**sms, "rng2": engine.lcg_skip(sms["rng2"], k)}


# ---------------------------------------------------------------------------
# invariant-sanitizer hooks (repro_torch.core.validate)
# ---------------------------------------------------------------------------

def check_invariants(cfg: SimConfig, sms: Dict[str, Any], t):
    """(W,) count of violated staged-structure invariants: FIFO/DCS
    occupancy within bounds, heads in range, `front_run` equal to a full
    recount, a non-negative drain counter, and the stage-2 rng stream at
    its closed-form position (one draw per cycle, ticked or skipped)."""
    from repro_torch.core.validate import nbool
    C, F, D = cfg.n_channels, cfg.fifo_size, cfg.dcs_size
    bad = nbool((sms["f_len"] < 0) | (sms["f_len"] > F))
    bad = bad + nbool((sms["f_head"] < 0) | (sms["f_head"] >= F))
    bad = bad + nbool((sms["d_len"] < 0) | (sms["d_len"] > D))
    bad = bad + nbool((sms["d_head"] < 0) | (sms["d_head"] >= D))
    bad = bad + nbool(sms["drain_left"] < 0)
    bad = bad + nbool((sms["front_run"] < 0)
                      | (sms["front_run"] > sms["f_len"]))
    bad = bad + nbool((sms["f_len"] > 0) & (sms["front_run"] == 0))
    run = _run_from_head(sms["f_row"], sms["f_bank"], sms["f_head"],
                         sms["f_len"], F)
    bad = bad + nbool((sms["f_len"] > 0) & (run != sms["front_run"]))
    dev = sms["rng2"].device
    rng0 = engine.device_const(
        ("rng2_0", C), dev, lambda: engine.u32_init(C, 40503, 40503, dev))
    return bad + nbool(sms["rng2"] != engine.lcg_skip(rng0, t + 1))


def audit_skip(cfg: SimConfig, st, sms: Dict[str, Any], dram, t, t_new):
    """Would-fire lateness predicates of a jumped span, from the stage
    conditions at the last skipped cycle u (stage state is frozen over a
    span; only the age predicate depends on t, monotonically). Stage-1
    pushes report as late_admission, stage-2 batch events as late_boundary,
    stage-3 DCS-head eligibility as late_issue."""
    if t_new - t <= 1:
        return {}
    u = t_new - 1
    s1, s2, _ = _stage_ready(cfg, st, sms, u)
    elig = _dcs_heads(cfg, sms, dram, u)
    return {"late_admission": s1.to(torch.int32),
            "late_boundary": s2.to(torch.int32),
            "late_issue": engine.row_any(elig).to(torch.int32)}
