"""Structure-count power/area proxy model (§5.2 reproduction) + the
full-MC energy combine. A copy of ``repro/core/power.py``.

The centralized schedulers need a CAM over the whole request buffer (row
match for FR-FCFS hit detection + global age/priority search each cycle) and
per-entry ranking logic. SMS needs only SRAM FIFOs with head/tail pointers
and a handful of small comparators.

Per-bit constants (relative units; CAM ~9–10T vs 6T SRAM, match-line
leakage; ranking comparators dominated by per-entry priority encode):

`full_mc_energy` closes the loop with `repro_torch.core.energy`: the static
scheduler-structure leakage (these relative units, scaled to nJ/cycle by
`LEAK_NJ_PER_UNIT_CYCLE`) plus the measured dynamic DRAM totals give the
whole-memory-controller energy picture the paper's "energy-efficient"
claim is about.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core.params import SimConfig

# relative cost per bit (CAM cell 9-10T vs 6T SRAM; match-line leakage)
SRAM_AREA = 1.0
CAM_AREA = 1.7
SRAM_LEAK = 1.0
CAM_LEAK = 3.0

ENTRY_BITS_PAYLOAD = 48      # src, birth, metadata (SRAM in both designs)
ENTRY_BITS_MATCH = 24        # row+bank tag (CAM in centralized, SRAM in SMS)
CMP_AREA_PER_ENTRY = 20.0    # age/priority comparator tree, per entry
CMP_LEAK_PER_ENTRY = 20.0
FIFO_CTRL_AREA = 24.0        # head/tail pointers + full/empty per FIFO
FIFO_CTRL_LEAK = 10.0
RANK_LOGIC_AREA_PER_SRC = 60.0   # ATLAS/TCM/PAR-BS ranking (per source)
RANK_LOGIC_LEAK_PER_SRC = 40.0


def centralized_cost(cfg: SimConfig, policy: str = "frfcfs") -> Dict[str, float]:
    entries = cfg.n_channels * cfg.buf_entries
    area = entries * (ENTRY_BITS_MATCH * CAM_AREA +
                      ENTRY_BITS_PAYLOAD * SRAM_AREA + CMP_AREA_PER_ENTRY)
    leak = entries * (ENTRY_BITS_MATCH * CAM_LEAK +
                      ENTRY_BITS_PAYLOAD * SRAM_LEAK + CMP_LEAK_PER_ENTRY)
    if policy != "frfcfs":
        area += cfg.n_src * RANK_LOGIC_AREA_PER_SRC
        leak += cfg.n_src * RANK_LOGIC_LEAK_PER_SRC
    return {"area": area, "leakage": leak, "entries": entries}


def sms_cost(cfg: SimConfig) -> Dict[str, float]:
    s1_entries = cfg.n_channels * cfg.n_src * cfg.fifo_size
    s3_entries = cfg.n_channels * cfg.n_banks * cfg.dcs_size
    entries = s1_entries + s3_entries
    n_fifos = cfg.n_channels * (cfg.n_src + cfg.n_banks)
    bits = ENTRY_BITS_MATCH + ENTRY_BITS_PAYLOAD
    area = entries * bits * SRAM_AREA + n_fifos * FIFO_CTRL_AREA \
        + cfg.n_channels * (cfg.n_src * 8.0)   # batch scheduler compare
    leak = entries * bits * SRAM_LEAK + n_fifos * FIFO_CTRL_LEAK \
        + cfg.n_channels * (cfg.n_src * 5.0)
    return {"area": area, "leakage": leak, "entries": entries}


# leakage-unit -> nJ/cycle conversion for the full-MC energy combine. At
# the §5.2 configuration this puts the centralized CAM scheduler's static
# power at a few nJ/cycle — same order as the DRAM dynamic power it
# schedules, which is the regime where the paper's structure-simplification
# argument bites.
LEAK_NJ_PER_UNIT_CYCLE = 2e-5


def structure_cost(cfg: SimConfig, policy: str) -> Dict[str, float]:
    """Area/leakage of the scheduler structures `policy` needs."""
    if policy.startswith("sms"):
        return sms_cost(cfg)
    return centralized_cost(cfg, policy)


def scheduler_static_power(cfg: SimConfig, policy: str) -> float:
    """Scheduler-structure leakage power in nJ/cycle (for energy_breakdown)."""
    return structure_cost(cfg, policy)["leakage"] * LEAK_NJ_PER_UNIT_CYCLE


def full_mc_energy(cfg: SimConfig, policy: str, dram_dynamic_nj: float,
                   dram_background_nj: float, n_cycles: int,
                   requests: float) -> Dict[str, float]:
    """Static scheduler leakage + measured dynamic DRAM totals, per request.

    dram_dynamic_nj / dram_background_nj come from the `energy_*` counters
    (`metrics.energy_breakdown` or raw `simulate` outputs) over `n_cycles`
    measured cycles in which `requests` requests completed.
    """
    static = scheduler_static_power(cfg, policy) * n_cycles
    total = static + dram_dynamic_nj + dram_background_nj
    reqs = max(requests, 1.0)
    return {
        "scheduler_static_nj": static,
        "dram_dynamic_nj": dram_dynamic_nj,
        "dram_background_nj": dram_background_nj,
        "total_nj": total,
        "energy_per_request_nj": total / reqs,
        "static_frac": static / max(total, 1e-9),
    }


def compare(cfg: SimConfig) -> Dict[str, float]:
    fr = centralized_cost(cfg, "frfcfs")
    sm = sms_cost(cfg)
    return {
        "frfcfs_area": fr["area"], "sms_area": sm["area"],
        "frfcfs_leakage": fr["leakage"], "sms_leakage": sm["leakage"],
        "area_reduction_pct": 100.0 * (1 - sm["area"] / fr["area"]),
        "leakage_reduction_pct": 100.0 * (1 - sm["leakage"] / fr["leakage"]),
        "frfcfs_entries": fr["entries"], "sms_entries": sm["entries"],
    }
