"""Roofline constants of one NVIDIA H100 SXM.

Port of ``repro/roofline/analysis.py``, which holds TPU v5e constants; the
port's come from NVIDIA's H100 SXM data sheet (dense rates, no sparsity, at
the full 700 W power limit). The rest of the reference roofline (the
dry-run's three-term model) waits for the launchers (ROADMAP slice F).
"""
from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12        # HBM3
F32_FLOPS_PER_S = 67e12          # float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # bf16 dense tensor cores


def bound_ms(n_bytes: float, n_flops: float,
             flops_per_s: float) -> Tuple[float, str]:
    """The least time the card could take for work that moves ``n_bytes``
    and does ``n_flops`` at ``flops_per_s``: (ms, "bytes" | "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
