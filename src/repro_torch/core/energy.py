"""Command-level DRAM energy accounting (the paper's energy-efficient half).

Port of ``repro/core/energy.py``, over the port's leading workload axis:
per-source counters are (W, S), per-channel ones (W, C). Energy-only by
contract: no counter feeds back into eligibility, scoring or timing.

  * ACT/PRE pair energy charged to the issuing source on every row miss;
  * RD/WR burst energy charged to the issuing source on every issue;
  * background cycles per channel: active-standby, or power-down once a
    channel's banks have all been idle for >= `energy_pd_idle` cycles,
    held as integer cycle counters (`sb_cycles`, `pd_cycles`);
  * a wake-up penalty when a powered-down channel next issues.

`skip_accrue` charges a skipped span in closed form: the integer cycle
counters make one add bit-identical to the per-cycle accrual.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.params import SimConfig

# dram_state keys owned by this module
STATE_KEYS = ("e_act", "e_rw", "sb_cycles", "e_wake", "pd_down", "pd_cycles",
              "busy_until")


def energy_state(cfg: SimConfig, W: int, device) -> Dict[str, Any]:
    """Energy counters merged into `engine.dram_state` when enabled."""
    if not cfg.energy_enabled:
        return {}
    C, S = cfg.n_channels, cfg.n_src
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    return {
        "e_act": z((W, S), torch.float32),
        "e_rw": z((W, S), torch.float32),
        "sb_cycles": z((W, C), torch.int32),
        "e_wake": z((W, C), torch.float32),
        "pd_down": z((W, C), torch.bool),
        "pd_cycles": z((W, C), torch.int32),
        "busy_until": z((W, C), torch.int32),
    }


def background_tick(cfg: SimConfig, dram: Dict[str, Any], t: int
                    ) -> Dict[str, Any]:
    """Per-cycle background accrual + power-down entry (all (W, C) ops)."""
    if not cfg.energy_enabled:
        return dram
    dram = dict(dram)
    idle_long = (t - dram["busy_until"]) >= cfg.energy_pd_idle
    pd = dram["pd_down"] | idle_long
    dram["pd_down"] = pd
    dram["sb_cycles"] = dram["sb_cycles"] + (~pd).to(torch.int32)
    dram["pd_cycles"] = dram["pd_cycles"] + pd.to(torch.int32)
    return dram


def skip_accrue(cfg: SimConfig, dram: Dict[str, Any], t: int, t_new: int
                ) -> Dict[str, Any]:
    """Charge background cycles for the skipped span t+1 .. t_new-1 in one
    add, exactly what k = t_new-1-t calls of `background_tick` would do.

    No issue lands inside a span (the witness contract), so `busy_until` is
    frozen and the only transition is standby -> power-down at `enter =
    busy_until + energy_pd_idle`; the closed form splits the span there.
    t, t_new: host ints; `cfg.energy_pd_idle` may be a per-row tensor.
    """
    if not cfg.energy_enabled:
        return dram
    dram = dict(dram)
    k = t_new - 1 - t
    enter = dram["busy_until"] + cfg.energy_pd_idle
    n_pd = torch.where(
        dram["pd_down"], k,
        torch.clamp(t_new - torch.clamp(enter, min=t + 1), 0, k))
    dram["pd_cycles"] = dram["pd_cycles"] + n_pd
    dram["sb_cycles"] = dram["sb_cycles"] + (k - n_pd)
    dram["pd_down"] = dram["pd_down"] | (t_new - 1 >= enter)
    return dram


def on_issue(cfg: SimConfig, dram: Dict[str, Any], do_issue: torch.Tensor,
             src: torch.Tensor, is_hit: torch.Tensor, done: torch.Tensor
             ) -> Dict[str, Any]:
    """Charge command energy for this cycle's issues ((W, C) tensors)."""
    if not cfg.energy_enabled:
        return dram
    from repro_torch.core import engine
    # the float32 value of each constant, as the reference's jnp.float32
    f32 = lambda x: float(np.float32(x))
    dram = dict(dram)
    dram["e_rw"] = engine.accum_by_index(
        dram["e_rw"], src, f32(cfg.energy_rw), do_issue)
    dram["e_act"] = engine.accum_by_index(
        dram["e_act"], src, f32(cfg.energy_act), do_issue & ~is_hit)
    wake = do_issue & dram["pd_down"]
    dram["e_wake"] = dram["e_wake"] + \
        wake.to(torch.float32) * f32(cfg.energy_wake)
    dram["pd_down"] = dram["pd_down"] & ~do_issue
    dram["busy_until"] = torch.where(
        do_issue, torch.maximum(dram["busy_until"], done), dram["busy_until"])
    return dram
