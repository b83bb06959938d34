"""BLISS — the Blacklisting memory scheduler (Subramanian et al.,
arXiv:1504.00390).

Each channel watches the stream of issued requests: a source served
`bliss_threshold` times in a row is "interference-causing" and gets
blacklisted. Scheduling is then non-blacklisted > row-hit > age, and the
blacklist is wiped every `bliss_clear_interval` cycles (a boundary gated on
the cycle counter), so sources are only penalized while they stream. State:
a (W, C) last-served id, a (W, C) streak counter, a (W, S) blacklist
mirrored into the cached `pri_src` priority.
"""
from __future__ import annotations

import torch

from repro_torch.core import engine, policy
from repro_torch.core.schedulers import CentralizedPolicy, POL_BIT


@policy.register
class BLISS(CentralizedPolicy):
    name = "bliss"
    boundary_keys = ("blacklist", "pri_src")
    # stacked schema: (W, C) streak trackers + (W, S) blacklist/pri_src; the
    # whole blacklisting state machine lives in on_issue
    stacked_issue_keys = ("bl_last", "bl_streak", "blacklist", "pri_src")

    def extra_state(self, cfg, W, device):
        C, S = cfg.n_channels, cfg.n_src
        i32 = dict(dtype=torch.int32, device=device)
        return {
            "bl_last": torch.full((W, C), -1, **i32),
            "bl_streak": torch.zeros((W, C), **i32),
            "blacklist": torch.zeros((W, S), dtype=torch.bool, device=device),
            "pri_src": torch.full((W, S), POL_BIT, **i32),
        }

    def boundary_pred(self, cfg, pool, st, buf, t):
        return t % cfg.bliss_clear_interval == 0

    def boundary_tick(self, cfg, pool, st, buf, t):
        buf = dict(buf)
        buf["blacklist"] = torch.zeros_like(buf["blacklist"])
        buf["pri_src"] = torch.full_like(buf["pri_src"], POL_BIT)
        return buf

    def on_issue(self, cfg, pool, buf, do, pick, src, t):
        buf = dict(buf)
        same = do & (src == buf["bl_last"])
        streak = torch.where(do, torch.where(same, buf["bl_streak"] + 1, 1),
                             buf["bl_streak"])
        over = do & (streak >= cfg.bliss_threshold)
        buf["bl_last"] = torch.where(do, src, buf["bl_last"])
        buf["bl_streak"] = torch.where(over, 0, streak)
        hit = torch.any((engine.arange(cfg.n_src, src.device)
                         == src[..., None]) & over[..., None], dim=-2)
        buf["blacklist"] = buf["blacklist"] | hit
        buf["pri_src"] = (~buf["blacklist"]).to(torch.int32) * POL_BIT
        return buf

    def next_boundary(self, cfg, pool, st, buf, t):
        # the streak machine lives in on_issue (issues are witnessed); only
        # the interval clear is time-driven
        return (t // cfg.bliss_clear_interval + 1) * cfg.bliss_clear_interval
