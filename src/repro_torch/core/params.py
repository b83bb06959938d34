"""Static simulation parameters: DRAM timing, structure sizes, policy knobs.

Port of ``repro/core/params.py``. Timing values are DDR3-1600-class, in
memory-controller cycles. ``SimConfig`` is the same frozen dataclass with the
same fields and defaults; the value-like knobs (``KNOB_SPECS``) become a
``Knobs`` dataclass of 0-d float32 / int32 / bool tensors.

``bind`` resolves every knob to its host value once, at bind time: the
simulator's cycle loop then reads Python numbers (already rounded to the
knob's dtype), never a device tensor, so no knob read can synchronize with
the card.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

# requester classes (the N-class source model): the class picks a source's
# traffic generator (engine.source_tick) and its reporting bucket
CLS_CPU, CLS_GPU, CLS_HWA = 0, 1, 2
CLASS_NAMES: Tuple[str, ...] = ("cpu", "gpu", "hwa")
N_CLASSES = len(CLASS_NAMES)


@dataclass(frozen=True)
class Timing:
    t_rcd: int = 11      # ACT -> READ
    t_rp: int = 11       # PRE
    t_cas: int = 11      # READ -> data
    t_ras: int = 28      # ACT -> PRE (folded into busy window)
    t_faw: int = 32      # four-ACT window
    t_burst: int = 4     # data burst on the bus

    @property
    def lat_hit(self) -> int:
        return self.t_cas

    @property
    def lat_conflict(self) -> int:          # open row, wrong row
        return self.t_rp + self.t_rcd + self.t_cas

    @property
    def lat_closed(self) -> int:            # bank closed
        return self.t_rcd + self.t_cas


@dataclass(frozen=True)
class SimConfig:
    """Static config: shapes, cycle-gated periods, feature gates, and the
    default values of the tunable knobs."""

    n_cpu: int = 8
    n_gpu: int = 1
    n_hwa: int = 0                   # frame-deadline accelerators (CLS_HWA)
    n_channels: int = 1
    n_banks: int = 8                 # banks per channel
    n_rows: int = 4096               # rows per bank (address space)

    # centralized request buffer (per channel); SMS uses fifo/dcs sizes below
    buf_entries: int = 64
    cpu_reserve: float = 0.5         # fraction of entries GPU may NOT occupy

    # SMS structures (per channel)
    fifo_size: int = 16              # stage-1 per-source FIFO
    dcs_size: int = 12               # stage-3 per-bank FIFO
    batch_age_cap: int = 200         # stage-1 age threshold
    sjf_prob: float = 0.9            # stage-2 SJF probability p

    # cores
    cpu_ipc: float = 2.0             # 3-wide OoO effective IPC between misses
    cpu_mshr: int = 8
    gpu_mshr: int = 128              # wavefront-scale outstanding requests
    hwa_mshr: int = 128              # accelerator outstanding-request bound

    # policy knobs
    atlas_alpha: float = 0.875
    atlas_epoch: int = 2000
    parbs_cap: int = 5
    tcm_quantum: int = 1000
    tcm_lat_frac: float = 0.25
    bliss_threshold: int = 4
    bliss_clear_interval: int = 10_000
    squash_epoch: int = 100
    squash_lead: int = 150
    squash_pb: float = 0.75
    squash_gpu_pb: float = 0.15
    squash_cpu_pb: float = 0.35
    # SMS-DASH: deadline-aware stage 2 (urgent accelerator batches preempt)
    dash: bool = False
    dash_svc_est: float = 24.0
    # DRAM energy accounting (core.energy): measurement-only
    energy_enabled: bool = True
    energy_act: float = 2.5          # ACT+PRE pair, charged per row miss
    energy_rw: float = 1.2           # RD/WR burst, charged per issue
    energy_standby: float = 0.10     # active-standby, per channel-cycle
    energy_pd: float = 0.025         # power-down, per channel-cycle
    energy_wake: float = 0.8         # power-down exit penalty, per wake
    energy_pd_idle: int = 48         # all-banks-idle cycles before power-down
    # per-source request-latency histogram (core.qos): measurement-only
    qos_enabled: bool = True
    # invariant sanitizer (core.validate): measurement-only, a debug mode
    validate_enabled: bool = False
    lat_bins: int = 32               # histogram bins per source
    lat_bin_width: int = 64          # cycles per bin (last bin open-ended)
    # windowed flight recorder (core.telemetry): measurement-only
    telemetry_enabled: bool = False
    telemetry_window: int = 32       # ring slots (the last epochs retained)
    telemetry_epoch: int = 256       # cycles per epoch
    timing: Timing = Timing()

    @property
    def n_src(self) -> int:
        return self.n_cpu + self.n_gpu + self.n_hwa

    @property
    def gpu_cap(self) -> int:
        return max(1, int(self.buf_entries * (1.0 - self.cpu_reserve)))

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Tunable knobs. VALUE-LIKE knobs (KNOB_SPECS) are elementwise operands;
# PERIOD-LIKE knobs (PERIOD_KNOBS) gate cycle-only boundary predicates and
# stay per-config Python ints.
# ---------------------------------------------------------------------------

KNOB_SPECS: Tuple[Tuple[str, Any], ...] = (
    ("cpu_reserve", torch.float32),
    ("batch_age_cap", torch.int32),
    ("sjf_prob", torch.float32),
    ("atlas_alpha", torch.float32),
    ("parbs_cap", torch.int32),
    ("tcm_lat_frac", torch.float32),
    ("bliss_threshold", torch.int32),
    ("squash_lead", torch.int32),
    ("squash_pb", torch.float32),
    ("squash_gpu_pb", torch.float32),
    ("squash_cpu_pb", torch.float32),
    ("dash", torch.bool),
    ("dash_svc_est", torch.float32),
    ("energy_pd_idle", torch.int32),
)
KNOB_FIELDS: Tuple[str, ...] = tuple(n for n, _ in KNOB_SPECS)
PERIOD_KNOBS: Tuple[str, ...] = ("atlas_epoch", "tcm_quantum",
                                 "squash_epoch", "bliss_clear_interval")
_KNOB_SET = frozenset(KNOB_FIELDS)


@dataclass(frozen=True)
class Knobs:
    """The tunable-value half of a SimConfig: 0-d tensors in the dtypes of
    ``KNOB_SPECS``. Build with ``Knobs.from_cfg``."""

    cpu_reserve: Any
    batch_age_cap: Any
    sjf_prob: Any
    atlas_alpha: Any
    parbs_cap: Any
    tcm_lat_frac: Any
    bliss_threshold: Any
    squash_lead: Any
    squash_pb: Any
    squash_gpu_pb: Any
    squash_cpu_pb: Any
    dash: Any
    dash_svc_est: Any
    energy_pd_idle: Any

    @classmethod
    def from_cfg(cls, cfg: "SimConfig", **overrides) -> "Knobs":
        """Knobs at `cfg`'s values, with optional value-knob overrides.
        Period-like knobs are rejected (vary them with `cfg.replace`)."""
        bad_period = sorted(set(overrides) & set(PERIOD_KNOBS))
        if bad_period:
            raise ValueError(
                f"period-like knobs {bad_period} cannot batch (they gate "
                f"t-only boundary conds); vary them per slice via "
                f"cfg.replace / simulate_stacked_grid")
        bad = sorted(set(overrides) - _KNOB_SET)
        if bad:
            raise ValueError(f"not tunable value knobs: {bad}; "
                             f"known: {sorted(_KNOB_SET)}")
        return cls(**{n: torch.as_tensor(overrides.get(n, getattr(cfg, n)),
                                         dtype=dt)
                      for n, dt in KNOB_SPECS})

    def replace(self, **kw) -> "Knobs":
        kw = {n: torch.as_tensor(v, dtype=dict(KNOB_SPECS)[n])
              for n, v in kw.items()}
        return dataclasses.replace(self, **kw)


def split_overrides(overrides: Dict[str, Any]):
    """Split a mixed override dict into (period-like, value-like) parts."""
    per = {k: v for k, v in overrides.items() if k in PERIOD_KNOBS}
    val = {k: v for k, v in overrides.items() if k in _KNOB_SET}
    bad = sorted(set(overrides) - set(per) - set(val))
    if bad:
        raise ValueError(f"not tunable knobs: {bad}")
    return per, val


def static_bool(x) -> Any:
    """Concrete truth value of a knob as the bound config serves it (a host
    number), or None for a tensor: the port never reads a tensor's value
    to pick a code path, so a batched knob keeps the masked form."""
    if isinstance(x, torch.Tensor):
        return None
    return bool(x)


class BoundConfig:
    """A SimConfig view with value-like knobs served from a `Knobs` point.

    Shape-, period- and timing-like fields delegate to the SimConfig. The
    knobs are resolved to host numbers here, once: an f32 knob becomes the
    Python float of its f32 value, an int32 knob an int, `dash` a bool, so
    an op between a tensor and a knob computes in the tensor's dtype
    exactly as the reference's f32/i32 operands do. `gpu_cap` is computed
    in f32 from the bound `cpu_reserve`, as the reference's bound path does.
    """

    __slots__ = ("_cfg", "_knobs", "_host", "_gpu_cap")

    def __init__(self, cfg: SimConfig, knobs: Knobs):
        host = {}
        for n in KNOB_FIELDS:
            v = getattr(knobs, n)
            if v.device.type != "cpu" or v.dim() != 0:
                raise ValueError(f"knob {n!r} must be a 0-d CPU tensor "
                                 f"(got {tuple(v.shape)} on {v.device})")
            host[n] = v.item()          # a CPU tensor: no device sync
        cap = int(np.float32(cfg.buf_entries)
                  * (np.float32(1.0) - np.float32(host["cpu_reserve"])))
        object.__setattr__(self, "_cfg", cfg)
        object.__setattr__(self, "_knobs", knobs)
        object.__setattr__(self, "_host", host)
        object.__setattr__(self, "_gpu_cap", max(1, cap))

    def __setattr__(self, name, value):
        raise AttributeError("BoundConfig is read-only")

    def __getattr__(self, name):
        if name in _KNOB_SET:
            return self._host[name]
        return getattr(self._cfg, name)

    @property
    def base(self) -> SimConfig:
        return self._cfg

    @property
    def knobs(self) -> Knobs:
        return self._knobs

    @property
    def gpu_cap(self) -> int:
        return self._gpu_cap

    def __repr__(self):
        return f"BoundConfig({self._cfg!r}, {self._knobs!r})"


def bind(cfg: SimConfig, knobs: Knobs) -> BoundConfig:
    """The config view the simulator hands to hooks: cfg + live knobs."""
    if isinstance(cfg, BoundConfig):
        cfg = cfg.base
    return BoundConfig(cfg, knobs)


class RowConfig:
    """The config that the shared work of a folded step reads (the engine
    half of the cycle, run once over every slice's rows): the static fields
    of `cfg`, and the only two value knobs that work touches, admission's
    `gpu_cap` and the power-down threshold `energy_pd_idle`, one value per
    row as an (R, 1) tensor. Reading any other value knob raises: those are per slice, and each
    slice's hooks read them from their own `BoundConfig`."""

    __slots__ = ("_cfg", "gpu_cap", "energy_pd_idle")

    def __init__(self, cfg: SimConfig, gpu_cap, energy_pd_idle):
        object.__setattr__(self, "_cfg", cfg)
        object.__setattr__(self, "gpu_cap", gpu_cap)
        object.__setattr__(self, "energy_pd_idle", energy_pd_idle)

    def __setattr__(self, name, value):
        raise AttributeError("RowConfig is read-only")

    def __getattr__(self, name):
        if name in _KNOB_SET:
            raise AttributeError(
                f"value knob {name!r} differs per slice; the shared work "
                f"of a folded step reads only gpu_cap and energy_pd_idle")
        return getattr(self._cfg, name)


def row_config(cfg: SimConfig, bound, W: int, device) -> RowConfig:
    """The shared-work config of slices `bound` (their `BoundConfig`s), W
    rows each, policy-major: each knob an (len(bound)·W, 1) int32 device
    tensor, made here once, so no later cycle copies it to the device."""
    if isinstance(cfg, BoundConfig):
        cfg = cfg.base

    def col(vals):
        return torch.tensor(vals, dtype=torch.int32).repeat_interleave(
            W)[:, None].to(device)

    return RowConfig(cfg, col([b.gpu_cap for b in bound]),
                     col([b.energy_pd_idle for b in bound]))


def knob_points(cfg: SimConfig, points) -> list:
    """A sequence of knob points (value-knob override dicts or `Knobs`) as
    `Knobs`, one per grid slice."""
    return [Knobs.from_cfg(cfg, **pt) if isinstance(pt, dict) else pt
            for pt in points]


@dataclass(frozen=True)
class SourcePool:
    """Per-source trace parameters, as numpy arrays of len n_src."""

    mpki: np.ndarray        # CPU memory intensity (LLC MPKI); GPU ignores
    rbl: np.ndarray         # P(next request same (bank,row))
    blp: np.ndarray         # bank-level parallelism (stripe width)
    is_gpu: np.ndarray      # bool
    dl_period: np.ndarray = None
    dl_reqs: np.ndarray = None
    src_class: np.ndarray = None    # CLS_* id per source
    dl_jitter: np.ndarray = None    # max per-frame release jitter, cycles

    def inst_per_miss(self) -> np.ndarray:
        return np.maximum(1000.0 / np.maximum(self.mpki, 1e-3), 1.0)
