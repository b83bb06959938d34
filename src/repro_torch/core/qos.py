"""Per-class QoS accounting: request-latency histograms in the cycle loop.

Port of ``repro/core/qos.py``: a per-source latency histogram (W, S, BINS)
accumulated at issue commit. Measurement-only, like energy: no histogram
value feeds back into a scheduling decision.

Accounting identity: ``lat_hist[w, s].sum() == issued[w, s]``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.params import SimConfig

# dram_state keys owned by this module
STATE_KEYS = ("lat_hist",)


def qos_state(cfg: SimConfig, W: int, device) -> Dict[str, Any]:
    """QoS counters merged into `engine.dram_state` when enabled."""
    if not cfg.qos_enabled:
        return {}
    return {"lat_hist": torch.zeros((W, cfg.n_src, cfg.lat_bins),
                                    dtype=torch.int32, device=device)}


def bin_upper_edges(cfg: SimConfig) -> np.ndarray:
    """Host-side upper edge (cycles) of each histogram bin."""
    return (np.arange(cfg.lat_bins, dtype=np.float64) + 1.0) \
        * cfg.lat_bin_width


def on_issue(cfg: SimConfig, hist: torch.Tensor, src: torch.Tensor,
             lat: torch.Tensor, do_issue: torch.Tensor) -> torch.Tensor:
    """hist[..., src[c], bin(lat[c])] += 1 where do_issue[c]; src, lat and
    do_issue are (..., C). A one-hot (..., C, S, BINS) summed over channels;
    duplicate sources across channels accumulate."""
    from repro_torch.core import engine
    dev = hist.device
    b = torch.clamp(torch.div(lat, cfg.lat_bin_width, rounding_mode="floor"),
                    0, cfg.lat_bins - 1)
    onehot = (engine.arange(cfg.n_src, dev)[:, None]
              == src[..., None, None]) \
        & (engine.arange(cfg.lat_bins, dev) == b[..., None, None]) \
        & do_issue[..., None, None]
    return hist + torch.sum(onehot.to(hist.dtype), dim=-3, dtype=hist.dtype)
