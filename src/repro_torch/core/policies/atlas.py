"""ATLAS (Kim et al., HPCA'10): rank sources by least attained service,
recomputed every epoch with exponential decay.

The attained-service totals only change at epoch boundaries, so the ranking
argsort lives in `boundary_tick`, gated on the cycle counter; between epochs
`score` is a gather of the cached per-source priority.
"""
from __future__ import annotations

import torch

from repro_torch.core import engine, policy
from repro_torch.core.schedulers import (CentralizedPolicy, RANK_SHIFT,
                                         rank_pos)


@policy.register
class ATLAS(CentralizedPolicy):
    name = "atlas"
    boundary_keys = ("attained", "served_epoch", "pri_src")
    # stacked schema: (W, S) attained/served_epoch/pri_src; tick writes are
    # boundary-only (the default), on_issue maintains the service counter
    stacked_issue_keys = ("served_epoch",)

    def extra_state(self, cfg, W, device):
        z = lambda dt: torch.zeros((W, cfg.n_src), dtype=dt, device=device)
        return {"attained": z(torch.float32),
                "served_epoch": z(torch.float32),
                "pri_src": z(torch.int32)}

    def boundary_pred(self, cfg, pool, st, buf, t):
        return t % cfg.atlas_epoch == 0

    def boundary_tick(self, cfg, pool, st, buf, t):
        buf = dict(buf)
        # alpha * attained + served, contracted by XLA into one
        # multiply-add: rounded once, as a fused multiply-add rounds
        att = engine.fma_f32(buf["attained"], cfg.atlas_alpha,
                             buf["served_epoch"])
        buf["attained"] = att
        buf["served_epoch"] = torch.zeros_like(buf["served_epoch"])
        rank = rank_pos(att)                            # 0 = least attained
        buf["pri_src"] = (cfg.n_src - rank) << RANK_SHIFT
        return buf

    def on_issue(self, cfg, pool, buf, do, pick, src, t):
        buf = dict(buf)
        buf["served_epoch"] = engine.accum_by_index(
            buf["served_epoch"], src, 1.0, do)
        return buf

    def next_boundary(self, cfg, pool, st, buf, t):
        # epoch boundaries always run (the decay changes `attained` even in
        # an idle epoch): the next epoch multiple
        return (t // cfg.atlas_epoch + 1) * cfg.atlas_epoch
