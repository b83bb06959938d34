"""SQUASH-style probabilistic prioritization (Usui et al.,
arXiv:1505.07502).

A per-source priority bit is redrawn every `squash_epoch` cycles:

  * deadline sources behind their frame pace (plus a `squash_lead` cycle
    margin) are *urgent*: a priority tier above everything else, tracked
    every cycle, and their pending requests jump the admission queue;
  * on-pace deadline sources win the draw with `squash_pb`;
  * the GPU wins with `squash_gpu_pb`;
  * CPUs win with `squash_cpu_pb`.

Within a tier FR-FCFS (row hit, then age) breaks ties. The draw's stream
`sq_rng` is the reference's uint32 LCG, held in int64 and masked to 32 bits
(`engine.lcg_step`), and exports as uint32.
"""
from __future__ import annotations

import torch

from repro_torch.core import engine, policy
from repro_torch.core.params import CLS_GPU, CLS_HWA
from repro_torch.core.schedulers import CentralizedPolicy, POL_BIT

URGENT_BIT = POL_BIT << 1


@policy.register
class SquashPrio(CentralizedPolicy):
    name = "squash_prio"
    boundary_keys = ("sq_rng", "sq_prio")
    # stacked schema: (W, S) rng/priority/urgency; the per-cycle policy_tick
    # writes sq_urgent + pri_src on top of the boundary draw, on_admit
    # accumulates the urgent-admission QoS counter
    stacked_tick_keys = boundary_keys + ("sq_urgent", "pri_src",
                                         "sq_urgent_adm")

    def extra_state(self, cfg, W, device):
        S = cfg.n_src
        b = lambda: torch.zeros((W, S), dtype=torch.bool, device=device)
        i = lambda: torch.zeros((W, S), dtype=torch.int32, device=device)
        return {
            "sq_prio": b(),
            "sq_urgent": b(),
            "sq_rng": engine.u32_init(S, 747796405, 2891336453,
                                      device).expand(W, S).clone(),
            "pri_src": i(),
            # admissions that jumped the queue on the urgent tier, per
            # source (QoS accounting only; surfaced as `urgent_admits`)
            "sq_urgent_adm": i(),
        }

    def boundary_pred(self, cfg, pool, st, buf, t):
        return t % cfg.squash_epoch == 0

    def boundary_tick(self, cfg, pool, st, buf, t):
        buf = dict(buf)
        cls = pool["src_class"]
        rng, u = engine.lcg_step(buf["sq_rng"])
        p = torch.where(cls == CLS_HWA, cfg.squash_pb,
                        torch.where(cls == CLS_GPU, cfg.squash_gpu_pb,
                                    cfg.squash_cpu_pb))
        buf["sq_rng"] = rng
        buf["sq_prio"] = u < p
        return buf

    def on_admit(self, cfg, pool, st, buf, do, slot, src, t):
        buf = dict(buf)
        urgent = torch.gather(buf["sq_urgent"], -1, src.to(torch.int64))
        buf["sq_urgent_adm"] = engine.accum_by_index(
            buf["sq_urgent_adm"], src, 1, do & urgent)
        return buf

    def policy_tick(self, cfg, pool, st, buf, t):
        buf = dict(buf)
        # urgency needs both the HWA class AND a live deadline stream;
        # urgent until ahead of the linear frame pace by squash_lead cycles:
        # done/reqs < (phase + lead)/period
        period = pool["dl_period"]
        is_accel = (pool["src_class"] == CLS_HWA) & (period > 0)
        phase = t % torch.clamp(period, min=1)
        remaining = torch.clamp(pool["dl_reqs"] - st["period_done"], min=0)
        buf["sq_urgent"] = is_accel & (remaining > 0) & \
            (st["period_done"] * period
             < (phase + cfg.squash_lead) * pool["dl_reqs"])
        buf["pri_src"] = buf["sq_urgent"].to(torch.int32) * URGENT_BIT + \
            buf["sq_prio"].to(torch.int32) * POL_BIT
        return buf

    def admit_key(self, cfg, pool, st, buf, t):
        # an urgent source's pending request admits ahead of anything
        # merely older
        return st["pend_birth"] - buf["sq_urgent"].to(torch.int32) * (1 << 20)

    def next_boundary(self, cfg, pool, st, buf, t):
        # `policy_tick` runs every cycle, so a span may skip only cycles
        # where its writes are fixed points: between epoch draws urgency is
        # monotone within a frame (`period_done` is frozen until a witnessed
        # completion or frame boundary while the pace grows with the
        # phase), so the one time-driven change is the first phase at which
        # a non-urgent deadline source turns urgent
        nb = (t // cfg.squash_epoch + 1) * cfg.squash_epoch
        period = pool["dl_period"]
        is_accel = (pool["src_class"] == CLS_HWA) & (period > 0)
        reqs = torch.clamp(pool["dl_reqs"], min=1)
        remaining = torch.clamp(pool["dl_reqs"] - st["period_done"], min=0)
        # the smallest integer phase with done*period < (phase + lead)*reqs
        phase_on = torch.div(st["period_done"] * period
                             - cfg.squash_lead * reqs, reqs,
                             rounding_mode="floor") + 1
        tau = (t - t % torch.clamp(period, min=1)) + phase_on
        cand = is_accel & (remaining > 0) & ~buf["sq_urgent"]
        w_flip = torch.amin(torch.where(cand, torch.clamp(tau, min=t + 1),
                                        engine.INF_T), dim=-1)
        return engine.earliest(w_flip, nb)
