"""TCM (Kim et al., MICRO'10): cluster sources into a latency-sensitive
group (prioritized, ranked by ascending intensity) and a bandwidth group
(rank-shuffled every quantum to spread interference).

Clustering, ranking and the shuffle only change at quantum boundaries, so
all of it lives in `boundary_tick`, gated on the cycle counter; `score`
gathers the cached per-source priority.
"""
from __future__ import annotations

import torch

from repro_torch.core import engine, policy
from repro_torch.core.schedulers import (CentralizedPolicy, POL_BIT,
                                         RANK_SHIFT, rank_pos)


@policy.register
class TCM(CentralizedPolicy):
    name = "tcm"
    boundary_keys = ("served_quant", "tcm_rank", "tcm_is_lat", "shuffle",
                     "pri_src")
    # stacked schema: (W, S) cluster/rank state + a (W,) shuffle; tick
    # writes are boundary-only (the default), on_issue maintains the
    # quantum counter
    stacked_issue_keys = ("served_quant",)

    def extra_state(self, cfg, W, device):
        S = cfg.n_src
        return {
            "served_quant": torch.zeros((W, S), dtype=torch.float32,
                                        device=device),
            "tcm_rank": torch.zeros((W, S), dtype=torch.int32, device=device),
            "tcm_is_lat": torch.ones((W, S), dtype=torch.bool, device=device),
            "shuffle": torch.zeros((W,), dtype=torch.int32, device=device),
            "pri_src": torch.zeros((W, S), dtype=torch.int32, device=device),
        }

    def boundary_pred(self, cfg, pool, st, buf, t):
        return t % cfg.tcm_quantum == 0

    def boundary_tick(self, cfg, pool, st, buf, t):
        buf = dict(buf)
        S = cfg.n_src
        inten = buf["served_quant"]                     # MPKC proxy
        order = rank_pos(inten)                         # ascending intensity
        # served_quant holds integer-valued f32 counts far below 2^24, so
        # the sum, the sort and the running sum along each row are exact in
        # any order, on any device
        total = torch.clamp(torch.sum(inten, dim=-1, keepdim=True), min=1.0)
        cum = torch.cumsum(torch.sort(inten, dim=-1).values, dim=-1)
        # latency cluster: least-intense prefix holding <= lat_frac of BW
        is_lat_sorted = cum <= total * cfg.tcm_lat_frac
        new_is_lat = torch.gather(is_lat_sorted, -1, order.to(torch.int64))
        # ranks: latency cluster by ascending intensity; bw cluster shuffled
        shuf = buf["shuffle"] + 1
        bw_rank = (order + shuf[..., None]) % S
        new_rank = torch.where(new_is_lat, order, bw_rank)
        buf["tcm_is_lat"] = new_is_lat
        buf["tcm_rank"] = new_rank
        buf["served_quant"] = torch.zeros_like(buf["served_quant"])
        buf["shuffle"] = shuf
        buf["pri_src"] = new_is_lat.to(torch.int32) * POL_BIT + \
            ((S - new_rank) << RANK_SHIFT)
        return buf

    def on_issue(self, cfg, pool, buf, do, pick, src, t):
        buf = dict(buf)
        buf["served_quant"] = engine.accum_by_index(
            buf["served_quant"], src, 1.0, do)
        return buf

    def next_boundary(self, cfg, pool, st, buf, t):
        # the shuffle counter advances every quantum, even when idle
        return (t // cfg.tcm_quantum + 1) * cfg.tcm_quantum
