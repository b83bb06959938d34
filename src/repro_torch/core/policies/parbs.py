"""PAR-BS (Mutlu & Moscibroda, ISCA'08): batch the oldest `parbs_cap`
requests per (source, bank), serve marked batches with shortest-job-first
source ranking before anything unmarked.

The amortized-rank form of the reference, needing neither a data-dependent
boundary nor a sort:

  * `grank` — each entry's age rank within its (source, bank) group — is
    maintained incrementally: a new entry's rank is its group's current
    population (births rise per source), an issue decrements the rank of
    its younger group-mates. Re-marking is the elementwise test
    `valid & (grank < parbs_cap)`.
  * `msub` — the would-be-marked population per source — is maintained at
    admit and issue too, so batch re-formation reads a counter.
  * the SJF priority is a pairwise stable rank of the (S,) `marked_left`
    vector, O(S^2) compares and no sort, recomputed every cycle in
    `pre_tick` (a fixed point between batch events).

Every reduction here runs over one workload's own (C, E) or (S,) axes,
never across the leading row axis.
"""
from __future__ import annotations

import torch

from repro_torch.core import engine, policy, validate
from repro_torch.core.schedulers import CentralizedPolicy, POL_BIT, RANK_SHIFT


def pairwise_rank(key: torch.Tensor) -> torch.Tensor:
    """Stable ascending rank along the last axis (0 = smallest, ties broken
    by index) as an O(S^2) compare-and-sum, int32 — equal to `rank_pos`
    (argsort of argsort) without a sort."""
    lt = key[..., None, :] < key[..., :, None]
    idx = engine.arange(key.shape[-1], key.device)
    tie = (key[..., None, :] == key[..., :, None]) & \
        (idx[None, :] < idx[:, None])
    return torch.sum(lt | tie, dim=-1, dtype=torch.int32)


@policy.register
class PARBS(CentralizedPolicy):
    name = "parbs"
    boundary_keys = ()
    # stacked schema: (W, C, E) grank + (W, S) batch counters. on_admit seeds
    # grank/msub, pre_tick re-marks and ranks, on_issue shifts grank /
    # settles msub / defers the marked_left decrement.
    stacked_tick_keys = ("marked_left", "pend_dec", "pri_src", "grank",
                         "marked", "msub")
    stacked_issue_keys = ("grank", "pend_dec", "msub")

    def extra_state(self, cfg, W, device):
        C, E, S = cfg.n_channels, cfg.buf_entries, cfg.n_src
        z = lambda *shape: torch.zeros((W,) + shape, dtype=torch.int32,
                                       device=device)
        return {"marked_left": z(S), "grank": z(C, E), "pend_dec": z(S),
                "pri_src": z(S), "msub": z(S)}

    def on_admit(self, cfg, pool, st, buf, do, slot, src, t):
        # the admitted entry is its group's youngest: rank = group size - 1
        buf = dict(buf)
        bank = engine.take(buf["bank"], torch.where(do, slot, 0))  # (W, C)
        grp = buf["valid"] & (buf["src"] == src[..., None]) & \
            (buf["bank"] == bank[..., None])
        rank = torch.sum(grp, dim=-1, dtype=torch.int32) - 1
        buf["grank"] = engine.masked_set(buf["grank"], slot, rank, do)
        buf["msub"] = engine.accum_by_index(
            buf["msub"], src, 1, do & (rank < cfg.parbs_cap))
        return buf

    def pre_tick(self, cfg, pool, st, buf, t):
        buf = dict(buf)
        # apply the decrements deferred by on_issue, then re-mark when no
        # marked request remains in this workload's buffer — `msub` is the
        # recount, already maintained
        buf["marked_left"] = buf["marked_left"] - buf["pend_dec"]
        buf["pend_dec"] = torch.zeros_like(buf["pend_dec"])
        any_marked = torch.any((buf["valid"] & buf["marked"]).flatten(-2),
                               dim=-1)                           # (W,)
        buf["marked"] = torch.where(
            any_marked[..., None, None], buf["marked"],
            buf["valid"] & (buf["grank"] < cfg.parbs_cap))
        buf["marked_left"] = torch.where(any_marked[..., None],
                                         buf["marked_left"], buf["msub"])
        # shortest-job ranking: fewest marked = best
        rank = pairwise_rank(buf["marked_left"])
        buf["pri_src"] = (cfg.n_src - rank) << RANK_SHIFT
        return buf

    def on_issue(self, cfg, pool, buf, do, pick, src, t):
        buf = dict(buf)
        safe = torch.where(do, pick, 0)
        bank = engine.take(buf["bank"], safe)
        birth = engine.take(buf["birth"], safe)
        was_marked = engine.take(buf["marked"], safe)
        was_below = engine.take(buf["grank"], safe) < cfg.parbs_cap
        # younger group-mates move up one rank; a mate sitting exactly at the
        # cap (at most one per channel) enters the would-be-marked set, the
        # issued entry leaves it
        younger = buf["valid"] & (buf["src"] == src[..., None]) & \
            (buf["bank"] == bank[..., None]) & \
            (buf["birth"] > birth[..., None]) & do[..., None]
        at_cap = torch.sum(younger & (buf["grank"] == cfg.parbs_cap),
                           dim=-1, dtype=torch.int32)
        buf["grank"] = buf["grank"] - younger.to(torch.int32)
        buf["msub"] = engine.accum_by_index(
            buf["msub"], src, at_cap - was_below.to(torch.int32), do)
        # defer the marked_left decrement to the next pre_tick
        buf["pend_dec"] = engine.accum_by_index(
            buf["pend_dec"], src, 1, do & was_marked)
        return buf

    def score(self, cfg, pool, buf, is_hit, t):
        return buf["marked"].to(torch.int32) * POL_BIT + \
            super().score(cfg, pool, buf, is_hit, t)

    def check_invariants(self, cfg, pool, st, buf, t):
        # the base buffer invariants and the two mirror counters: `grank`
        # equals a pairwise age-rank recount within each (source, bank)
        # group (births are distinct in a group, so strict < is exact), and
        # `msub` a recount of the would-be-marked set. The corrupted
        # write-set fault trips the second on the stacked path.
        bad = super().check_invariants(cfg, pool, st, buf, t)
        v = buf["valid"]
        same = v[..., :, None] & v[..., None, :] & \
            (buf["src"][..., :, None] == buf["src"][..., None, :]) & \
            (buf["bank"][..., :, None] == buf["bank"][..., None, :])
        birth = buf["birth"]
        older = same & (birth[..., None, :] < birth[..., :, None])
        rank = torch.sum(older, dim=-1, dtype=torch.int32)       # (W, C, E)
        bad = bad + validate.nbool(v & (rank != buf["grank"]))
        below = v & (buf["grank"] < cfg.parbs_cap)
        mine = (engine.arange(cfg.n_src, v.device)
                == buf["src"][..., None]) & below[..., None]     # (W,C,E,S)
        cnt = torch.sum(mine.flatten(1, 2), dim=1, dtype=torch.int32)
        return bad + validate.nbool(cnt != buf["msub"])

    def next_boundary(self, cfg, pool, st, buf, t):
        # pre_tick changes state next cycle iff a deferred decrement is
        # pending or a fresh batch would form; otherwise every term it
        # writes is a fixed point and a span may skip it
        pend = torch.any(buf["pend_dec"] != 0, dim=-1)
        reform = ~engine.row_any(buf["valid"] & buf["marked"]) & \
            engine.row_any(buf["valid"])
        return torch.where(pend | reform, t + 1, engine.INF_T)
