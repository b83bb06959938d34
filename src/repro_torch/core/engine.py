"""Shared simulator machinery: source/core models, DRAM state, completion.

Port of ``repro/core/engine.py``. The reference writes one workload at a
time, (S,), (C, ...) and (RING, S), and vmaps over workloads; the port
carries an explicit leading workload axis W through every state tensor:
(W, S), (W, C, ...), (W, RING, S). Every function here also accepts any
number of leading axes where the reference takes one workload's arrays.

The cycle counter ``t`` is a Python int. Integer state is int32 and the
accumulators float32, as in the reference. The reference's uint32 streams
(the source rng, the frame hash) run in int64 holding the uint32 value,
masked to 32 bits after every multiply and add, and export as uint32.

The variable-step driver's witnesses (``next_source_event``,
``next_completion``) return one int64 cycle per row; ``skip_sources`` and
``lcg_skip`` replay a skipped span in closed form. The span length is a host
int common to every row (see ``simulator._run_cycles``).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import energy, qos, telemetry, validate
from repro_torch.core.params import (CLS_CPU, CLS_GPU, CLS_HWA, SimConfig,
                                     SourcePool)

RING = 64
NEG_T = -100_000
# "no event" sentinel of the variable-step driver's witnesses: far beyond any
# simulated horizon
INF_T = 1 << 30
U32 = 0xFFFFFFFF
LCG_A, LCG_C = 1664525, 1013904223

# source_state keys added by the N-class requester model (the golden digests
# predate them)
NCLASS_SRC_KEYS = ("frames_released",)
# state keys holding uint32 streams (int64 here; uint32 on export)
U32_KEYS = ("rng", "rng2", "sq_rng")


@functools.lru_cache(maxsize=None)
def addr_base(n_src: int, n_channels: int, n_banks: int) -> np.ndarray:
    """Loop-invariant address-gen stripe origins."""
    return (np.arange(n_src, dtype=np.int32) * 3) % (n_channels * n_banks)


_CONSTS: Dict[tuple, torch.Tensor] = {}


def device_const(key: tuple, device, make) -> torch.Tensor:
    """A read-only constant made on `device` once (by device ops, never a
    host copy) and reused by every later cycle."""
    k = key + (str(device),)
    t = _CONSTS.get(k)
    if t is None:
        t = _CONSTS[k] = make()
    return t


def arange(n: int, device) -> torch.Tensor:
    """The int64 arange(n) on `device`, made once."""
    return device_const(("arange", n), device,
                        lambda: torch.arange(n, device=device))


def take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[..., idx[...]] along the last axis: a (..., N), idx (...)."""
    return torch.gather(a, -1, idx.to(torch.int64)[..., None])[..., 0]


# ---------------------------------------------------------------------------
# one-hot masked writes: a[..., c, idx[..., c]] = v where do[..., c]
# ---------------------------------------------------------------------------

def _lift(v, nd: int):
    """A per-channel value (..., C) broadcast against (..., C, N...)."""
    if isinstance(v, torch.Tensor) and v.dim() > 0:
        return v.reshape(v.shape + (1,) * nd)
    return v


def masked_set(a: torch.Tensor, idx: torch.Tensor, v, do: torch.Tensor
               ) -> torch.Tensor:
    """a[..., c, idx[..., c]] = v[..., c] where do[..., c]; a: (..., C, N)."""
    mask = (arange(a.shape[-1], a.device) == idx[..., None]) & do[..., None]
    return torch.where(mask, _lift(v, 1), a)


def masked_set2(a: torch.Tensor, idx1: torch.Tensor, idx2: torch.Tensor, v,
                do: torch.Tensor) -> torch.Tensor:
    """a[..., c, idx1, idx2] = v[..., c] where do[..., c]; a (..., C, M, N)."""
    mask = (arange(a.shape[-2], a.device)[:, None]
            == idx1[..., None, None]) & \
        (arange(a.shape[-1], a.device) == idx2[..., None, None]) & \
        do[..., None, None]
    return torch.where(mask, _lift(v, 2), a)


def masked_add(a: torch.Tensor, idx: torch.Tensor, v, do: torch.Tensor
               ) -> torch.Tensor:
    """a[..., c, idx[..., c]] += v[..., c] where do[..., c]."""
    mask = (arange(a.shape[-1], a.device) == idx[..., None]) & do[..., None]
    return a + mask.to(a.dtype) * _lift(v, 1)


def accum_by_index(acc: torch.Tensor, idx: torch.Tensor, v, do: torch.Tensor
                   ) -> torch.Tensor:
    """acc[..., idx[..., c]] += v[..., c] where do[..., c]; acc: (..., N),
    idx/do: (..., C). Duplicate indices across channels accumulate: the
    one-hot product, then the sum over the channel axis, as the reference.
    """
    onehot = (arange(acc.shape[-1], acc.device) == idx[..., None]) \
        & do[..., None]
    return acc + torch.sum(onehot.to(acc.dtype) * _lift(v, 1), dim=-2,
                           dtype=acc.dtype)


def fma_f32(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """float32 `a * b + c` rounded once, as XLA contracts the reference's
    multiply-adds (`energy_bg`, ATLAS's decay). a, c: float32; b: a Python
    float holding a float32 value. The product is exact in float64 (24 x 24
    bits); the sum is rounded to odd (TwoSum gives its error; an inexact
    sum with an even last bit moves one ulp toward the exact value), and
    53 >= 24 + 2 bits makes the one rounding to float32 that follows the
    correctly rounded fused result, on any device."""
    b = float(np.float32(b))
    p = a.to(torch.float64) * b
    c = c.to(torch.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


# ---------------------------------------------------------------------------
# cheap counter RNG: the uint32 LCG, held in int64
# ---------------------------------------------------------------------------

def lcg_step(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: int64 holding a uint32 state. Returns (new_state, u01 float32)."""
    x = (x * LCG_A + LCG_C) & U32
    u = (x >> 8).to(torch.float32) / float(1 << 24)
    return x, u


@functools.lru_cache(maxsize=4096)
def lcg_power(k: int) -> Tuple[int, int]:
    """(A_k, C_k) with f^k(x) = A_k·x + C_k (mod 2^32) for the LCG step f:
    binary exponentiation over the bits of k mod 2^32, in Python integers,
    as the reference composes it in uint32."""
    k &= U32
    acc_a, acc_c = 1, 0
    pow_a, pow_c = LCG_A, LCG_C
    while k:
        if k & 1:
            acc_a, acc_c = (pow_a * acc_a) & U32, (pow_a * acc_c + pow_c) & U32
        pow_a, pow_c = (pow_a * pow_a) & U32, (pow_a * pow_c + pow_c) & U32
        k >>= 1
    return acc_a, acc_c


def lcg_skip(x: torch.Tensor, k: int) -> torch.Tensor:
    """Advance LCG states (int64 holding uint32) by a host int number of
    steps k >= 0 in closed form: the affine pair is composed on the host
    (`lcg_power`) and applied on the device. A_k·x can reach 2^64, so A_k is
    split into 16-bit halves: no product exceeds 2^48 before the mask."""
    a, c = lcg_power(k)
    if (a, c) == (1, 0):
        return x
    hi = ((x * (a >> 16)) & 0xFFFF) << 16
    return (hi + x * (a & 0xFFFF) + c) & U32


def u32_init(n: int, mul: int, add: int, device) -> torch.Tensor:
    """(arange(n) * mul + add) mod 2^32, as int64."""
    return (torch.arange(n, dtype=torch.int64, device=device) * mul
            + add) & U32


# ---------------------------------------------------------------------------
# state construction: (W, ...) tensors on `device`
# ---------------------------------------------------------------------------

def source_state(cfg: SimConfig, W: int, device) -> Dict[str, Any]:
    S = cfg.n_src
    z_i = lambda: torch.zeros((W, S), dtype=torch.int32, device=device)
    z_f = lambda: torch.zeros((W, S), dtype=torch.float32, device=device)
    return {
        "insts_acc": z_f(), "insts_done": z_f(),
        "outstanding": z_i(), "emitted": z_i(), "completed": z_i(),
        "sum_lat": z_f(),
        "pend_valid": torch.zeros((W, S), dtype=torch.bool, device=device),
        "pend_bank": z_i(), "pend_row": z_i(), "pend_birth": z_i(),
        "cur_bank": z_i(), "cur_row": z_i(), "bank_ptr": z_i(),
        "rng": u32_init(S, 2654435761, 12345, device).expand(W, S).clone(),
        "blp_sum": z_f(), "blp_n": z_f(),
        "period_done": z_i(), "dl_met": z_i(), "dl_missed": z_i(),
        "frames_released": z_i(),
    }


def dram_state(cfg: SimConfig, W: int, device) -> Dict[str, Any]:
    C, B, S = cfg.n_channels, cfg.n_banks, cfg.n_src
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "bank_free": torch.zeros((W, C, B), **i32),
        "open_row": torch.full((W, C, B), -1, **i32),
        "open_valid": torch.zeros((W, C, B), dtype=torch.bool, device=device),
        "act_ring": torch.full((W, C, 4), NEG_T, **i32),
        "bus_free": torch.zeros((W, C), **i32),
        "ring": torch.zeros((W, RING, S), **i32),
        "hits": torch.zeros((W, S), **i32),
        "issued": torch.zeros((W, S), **i32),
        **energy.energy_state(cfg, W, device),
        **qos.qos_state(cfg, W, device),
        # invariant-sanitizer counters (empty when cfg.validate_enabled off)
        **validate.validate_state(cfg, W, device),
        # flight-recorder ring (empty when cfg.telemetry_enabled off)
        **telemetry.telemetry_state(cfg, W, device),
    }


def derive_src_class(is_gpu: torch.Tensor, dl_period: torch.Tensor
                     ) -> torch.Tensor:
    """Class ids for legacy pools without `src_class`: the GPU flag wins, a
    deadline stream marks an HWA, everything else is a CPU core."""
    is_gpu = torch.as_tensor(is_gpu, dtype=torch.bool)
    dl_period = torch.as_tensor(dl_period, device=is_gpu.device)
    return torch.where(is_gpu, CLS_GPU,
                       torch.where(dl_period > 0, CLS_HWA, CLS_CPU)
                       ).to(torch.int32)


def pool_arrays(pool: SourcePool, device=None) -> Dict[str, torch.Tensor]:
    S = len(pool.mpki)
    dlp = pool.dl_period if pool.dl_period is not None else np.zeros(S)
    dlr = pool.dl_reqs if pool.dl_reqs is not None else np.zeros(S)
    dlj = pool.dl_jitter if pool.dl_jitter is not None else np.zeros(S)
    col = lambda v, dt: torch.as_tensor(np.asarray(v), device=device).to(dt)
    out = {
        "mpki": col(pool.mpki, torch.float32),
        "inst_per_miss": col(np.asarray(pool.inst_per_miss(), np.float32),
                             torch.float32),
        "rbl": col(pool.rbl, torch.float32),
        "blp": col(pool.blp, torch.int32),
        "is_gpu": col(pool.is_gpu, torch.bool),
        "dl_period": col(dlp, torch.int32),
        "dl_reqs": col(dlr, torch.int32),
        "dl_jitter": col(dlj, torch.int32),
    }
    out["src_class"] = (col(pool.src_class, torch.int32)
                        if pool.src_class is not None else
                        derive_src_class(out["is_gpu"], out["dl_period"]))
    return out


# ---------------------------------------------------------------------------
# per-cycle: core progress + request generation into the pending register
# ---------------------------------------------------------------------------

def frame_release_offset(S: int, frame: torch.Tensor, dl_jitter: torch.Tensor
                         ) -> torch.Tensor:
    """Per-(source, frame) release jitter in [0, dl_jitter] cycles: a
    stateless uint32 hash of the source id and the frame index (never a
    draw from the source rng). frame/dl_jitter: (..., S)."""
    sid = device_const(("frame_sid", S), frame.device,
                       lambda: u32_init(S, 2654435761, 0, frame.device))
    mix = sid ^ ((frame.to(torch.int64) & U32) * 2246822519 & U32)
    h = (mix * 1664525 + 1013904223) & U32
    span = (dl_jitter.to(torch.int64) & U32) + 1
    return ((h >> 8) % span).to(torch.int32)


def source_tick(cfg: SimConfig, pool: Dict[str, torch.Tensor],
                st: Dict[str, Any], active: torch.Tensor, t: int
                ) -> Dict[str, Any]:
    """Advance cores one cycle; fill empty pending registers.

    active: (W, S) bool. The class picks the generator: CPU cores are
    MLP-limit cores, the GPU an always-wanting stream, HWAs periodic frame
    bursts released after a per-frame jitter offset.
    """
    S = cfg.n_src
    n_banks_total = cfg.n_channels * cfg.n_banks
    cls = pool["src_class"]
    is_gpu = cls == CLS_GPU
    is_hwa = cls == CLS_HWA
    is_cpu = cls == CLS_CPU
    mshr = torch.where(is_gpu, cfg.gpu_mshr,
                       torch.where(is_hwa, cfg.hwa_mshr, cfg.cpu_mshr))
    room = st["outstanding"] < mshr
    can_run = active & is_cpu & room & ~st["pend_valid"]
    st = dict(st)
    step = torch.where(can_run, float(cfg.cpu_ipc), 0.0).to(torch.float32)
    st["insts_acc"] = st["insts_acc"] + step
    st["insts_done"] = st["insts_done"] + step

    want_cpu = active & is_cpu & (st["insts_acc"] >= pool["inst_per_miss"]) \
        & ~st["pend_valid"] & room
    want_gpu = active & is_gpu & ~st["pend_valid"] & room
    period = torch.clamp(pool["dl_period"], min=1)
    released = (t % period) >= \
        frame_release_offset(S, t // period, pool["dl_jitter"])
    want_accel = active & is_hwa & ~st["pend_valid"] & room & released & \
        (st["period_done"] + st["outstanding"] < pool["dl_reqs"])
    want = want_cpu | want_gpu | want_accel

    # address generation: two LCG draws per source per cycle
    rng, u = lcg_step(st["rng"])
    rng2, u2 = lcg_step(rng)
    st["rng"] = rng2
    same = u < pool["rbl"]
    base = device_const(
        ("addr_base", S, n_banks_total), cls.device,
        lambda: (torch.arange(S, dtype=torch.int32, device=cls.device) * 3)
        % n_banks_total)
    new_ptr = st["bank_ptr"] + 1
    new_bank = (base + new_ptr % torch.clamp(pool["blp"], min=1)) \
        % n_banks_total
    new_row = (u2 * cfg.n_rows).to(torch.int32)
    bank = torch.where(same, st["cur_bank"], new_bank)
    row = torch.where(same, st["cur_row"], new_row)

    st["cur_bank"] = torch.where(want, bank, st["cur_bank"])
    st["cur_row"] = torch.where(want, row, st["cur_row"])
    st["bank_ptr"] = torch.where(want & ~same, new_ptr, st["bank_ptr"])
    st["pend_bank"] = torch.where(want, bank, st["pend_bank"])
    st["pend_row"] = torch.where(want, row, st["pend_row"])
    st["pend_birth"] = torch.where(want, t, st["pend_birth"])
    st["pend_valid"] = st["pend_valid"] | want
    st["insts_acc"] = torch.where(want_cpu, st["insts_acc"]
                                  - pool["inst_per_miss"], st["insts_acc"])
    st["emitted"] = st["emitted"] + want.to(torch.int32)
    st["outstanding"] = st["outstanding"] + want.to(torch.int32)
    return st


def completions_tick(st: Dict[str, Any], dram: Dict[str, Any], t: int
                     ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Return requests whose data completed this cycle to their sources."""
    slot = t % RING
    done = dram["ring"][..., slot, :]                    # (W, S)
    st = dict(st)
    dram = dict(dram)
    st["outstanding"] = st["outstanding"] - done
    st["completed"] = st["completed"] + done
    st["period_done"] = st["period_done"] + done
    ring = dram["ring"].clone()
    ring[..., slot, :] = 0
    dram["ring"] = ring
    return st, dram


def deadline_tick(cfg: SimConfig, pool: Dict[str, torch.Tensor],
                  st: Dict[str, Any], t: int) -> Dict[str, Any]:
    """Frame-boundary accounting for deadline (HWA/DASH) sources: every
    elapsed frame is settled at its boundary as met or missed."""
    has_dl = pool["dl_period"] > 0
    boundary = has_dl & (t > 0) & \
        ((t % torch.clamp(pool["dl_period"], min=1)) == 0)
    met = boundary & (st["period_done"] >= pool["dl_reqs"])
    st = dict(st)
    st["frames_released"] = st["frames_released"] + boundary.to(torch.int32)
    st["dl_met"] = st["dl_met"] + met.to(torch.int32)
    st["dl_missed"] = st["dl_missed"] + (boundary & ~met).to(torch.int32)
    st["period_done"] = torch.where(boundary, 0, st["period_done"])
    return st


# ---------------------------------------------------------------------------
# variable-step driver witnesses (ROADMAP "Variable-step driver contract").
#
# Each witness returns, per row, the earliest cycle > t at which its part of
# the cycle could do anything beyond the closed-form accruals of a skipped
# span, evaluated on post-cycle-t state: conservative-early, never late.
# INF_T means "no event". A witness is an int tensor with one value per row,
# or a host int where it depends on t alone; `earliest` combines them into
# one int64 tensor per row.
# ---------------------------------------------------------------------------

class SkipBody(NamedTuple):
    """The variable-step half of a run, beside its ticked step.

    witness(carry, t) -> (R,) int64: each row's next event after cycle t;
    accrue(carry, t, t_new) -> carry: the closed-form accruals of the
    skipped cycles t+1 .. t_new-1 (called only when there is one);
    fold: rows per clock group. The R rows are `fold` slices of R / fold
    clock groups, policy-major: a stacked family shares one clock per
    workload across its slices, a solo or grid run has one per row;
    meter: the step takes a per-row mask of the rows whose own cycle this
    is (the telemetry `steps` channel counts only those).
    """

    witness: Callable
    accrue: Callable
    fold: int = 1
    meter: bool = False


def earliest(a, b):
    """The earlier of two witnesses (an int tensor per row, a host int, or
    None for none); a tensor result is int64."""
    if b is None:
        return a
    if a is None:
        return b
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    if not isinstance(a, torch.Tensor):
        return min(a, b)
    a = a.to(torch.int64)
    if not isinstance(b, torch.Tensor):
        return torch.clamp(a, max=b)
    return torch.minimum(a, b.to(torch.int64))


def row_min(x: torch.Tensor) -> torch.Tensor:
    """Minimum over every axis but the leading row axis."""
    return torch.amin(x.reshape(x.shape[0], -1), dim=-1)


def row_any(x: torch.Tensor) -> torch.Tensor:
    """Any over every axis but the leading row axis."""
    return torch.any(x.reshape(x.shape[0], -1), dim=-1)


def source_mshr(cfg: SimConfig, cls: torch.Tensor) -> torch.Tensor:
    """Each source's outstanding-request limit, by class."""
    return torch.where(cls == CLS_GPU, cfg.gpu_mshr,
                       torch.where(cls == CLS_HWA, cfg.hwa_mshr,
                                   cfg.cpu_mshr))


def next_source_event(cfg: SimConfig, pool: Dict[str, torch.Tensor],
                      st: Dict[str, Any], active: torch.Tensor, t: int
                      ) -> torch.Tensor:
    """(R,) earliest cycle > t at which `source_tick` could emit a request or
    `deadline_tick` could settle a frame boundary, assuming no completion
    or issue lands first (their own witnesses cover those)."""
    S = cfg.n_src
    cls = pool["src_class"]
    is_gpu = cls == CLS_GPU
    is_hwa = cls == CLS_HWA
    is_cpu = cls == CLS_CPU
    free = active & ~st["pend_valid"] & \
        (st["outstanding"] < source_mshr(cfg, cls))
    t1 = t + 1
    # GPU: wants every cycle while its pending register is free
    w_gpu = torch.where(torch.any(free & is_gpu, dim=-1), t1, INF_T)
    # CPU: the next inter-miss crossing, floor((ipm - acc)/ipc) cycles on
    # (conservative-early). A span's batch accrual k*ipc is exact only for a
    # power-of-two ipc, so any other ipc pins the witness at t+1.
    can_run = free & is_cpu
    ipc = float(cfg.cpu_ipc)
    if ipc > 0.0 and math.log2(ipc).is_integer():
        kf = (pool["inst_per_miss"] - st["insts_acc"]) / ipc
        k = torch.clamp(torch.floor(kf).to(torch.int32), min=1)
        w_cpu = torch.amin(torch.where(can_run, t + k, INF_T), dim=-1)
    else:
        w_cpu = torch.where(torch.any(can_run, dim=-1), t1, INF_T)
    # HWA: the current frame's jittered release point, at least t+1
    period = torch.clamp(pool["dl_period"], min=1)
    frame = t1 // period
    rel = frame * period + frame_release_offset(S, frame, pool["dl_jitter"])
    demand = st["period_done"] + st["outstanding"] < pool["dl_reqs"]
    hwa_ok = free & is_hwa & demand & (pool["dl_period"] > 0)
    w_hwa = torch.amin(torch.where(hwa_ok, torch.clamp(rel, min=t1), INF_T),
                       dim=-1)
    # frame boundary: `deadline_tick` settles every deadline source of the
    # pool at its boundary, whatever `active` says
    has_dl = pool["dl_period"] > 0
    w_bnd = torch.amin(torch.where(has_dl, (t // period + 1) * period, INF_T),
                       dim=-1)
    return torch.minimum(torch.minimum(w_gpu, w_cpu),
                         torch.minimum(w_hwa, w_bnd)).to(torch.int64)


def next_completion(dram: Dict[str, Any], t: int) -> torch.Tensor:
    """(R,) earliest cycle > t whose completion-ring slot holds a request:
    every request lands within RING cycles of its issue."""
    pend = torch.any(dram["ring"] > 0, dim=-1)                 # (R, RING)
    dt = (arange(RING, pend.device) - (t + 1)) % RING
    return torch.amin(torch.where(pend, t + 1 + dt, INF_T), dim=-1)


def skip_sources(cfg: SimConfig, pool: Dict[str, torch.Tensor],
                 st: Dict[str, Any], active: torch.Tensor, k: int
                 ) -> Dict[str, Any]:
    """Replay k skipped (event-free) cycles of `source_tick` in closed form:
    the two rng draws per cycle and the CPU instruction accrual; the rest is
    frozen by the witness contract. k: a host int."""
    st = dict(st)
    st["rng"] = lcg_skip(st["rng"], 2 * k)
    cls = pool["src_class"]
    can_run = active & (cls == CLS_CPU) & \
        (st["outstanding"] < source_mshr(cfg, cls)) & ~st["pend_valid"]
    # f32(k) * f32(ipc), rounded once in float32 as the reference's product
    add = torch.where(can_run, float(np.float32(k) * np.float32(cfg.cpu_ipc)),
                      0.0).to(torch.float32)
    st["insts_acc"] = st["insts_acc"] + add
    st["insts_done"] = st["insts_done"] + add
    return st


# ---------------------------------------------------------------------------
# DRAM eligibility + issue
# ---------------------------------------------------------------------------

def eligibility(cfg: SimConfig, dram: Dict[str, Any], bank: torch.Tensor,
                row: torch.Tensor, valid: torch.Tensor, t: int):
    """Per-candidate issue legality on every channel at once.

    bank/row/valid: (W, C, N) candidates (bank is the bank-in-channel
    index); dram's per-channel tensors are (W, C, B). The reference takes
    one channel `c` and (N,) candidates. Returns (eligible, lat, is_hit),
    each (W, C, N).
    """
    tm = cfg.timing
    bank = bank.to(torch.int64)
    openv = torch.gather(dram["open_valid"], -1, bank)
    openr = torch.gather(dram["open_row"], -1, bank)
    is_hit = openv & (openr == row)
    lat = torch.where(is_hit, tm.lat_hit,
                      torch.where(openv, tm.lat_conflict, tm.lat_closed)
                      ).to(torch.int32)
    ok_bank = torch.gather(dram["bank_free"], -1, bank) <= t
    oldest_act = torch.amin(dram["act_ring"], dim=-1)         # (W, C)
    ok_faw = is_hit | ((t - oldest_act) >= tm.t_faw)[..., None]
    ok_bus = (t + lat) >= dram["bus_free"][..., None]
    return valid & ok_bank & ok_faw & ok_bus, lat, is_hit


def issue_channels(cfg: SimConfig, dram: Dict[str, Any], st: Dict[str, Any],
                   do_issue: torch.Tensor, bank: torch.Tensor,
                   row: torch.Tensor, src: torch.Tensor, birth: torch.Tensor,
                   lat: torch.Tensor, is_hit: torch.Tensor, t: int):
    """Commit at most one issue per channel (all args (W, C)). Per-channel
    DRAM rows are disjoint; the per-source accumulations add over channels.
    """
    tm = cfg.timing
    dram = dict(dram)
    st = dict(st)
    if cfg.validate_enabled:
        # timing compliance is checked against the PRE-update DRAM state
        dram["viol"] = dram["viol"] + validate.issue_counts(
            cfg, dram, do_issue, bank, lat, is_hit, t)
    done = t + lat + tm.t_burst                                 # (W, C)
    dram["bank_free"] = masked_set(dram["bank_free"], bank, done, do_issue)
    dram["open_row"] = masked_set(dram["open_row"], bank, row, do_issue)
    dram["open_valid"] = masked_set(dram["open_valid"], bank, True, do_issue)
    # activate bookkeeping (tFAW): replace the oldest entry per channel
    do_act = do_issue & ~is_hit
    amin = torch.argmin(dram["act_ring"], dim=-1)               # (W, C)
    dram["act_ring"] = masked_set(dram["act_ring"], amin, t, do_act)
    dram["bus_free"] = torch.where(do_issue, done, dram["bus_free"])
    # completion ring: one scatter-add per channel into (RING, S)
    S = dram["ring"].shape[-1]
    slot = done % RING
    safe_src = torch.where(do_issue, src, 0)
    ring = dram["ring"]
    flat = (slot * S + safe_src).to(torch.int64)
    lead = ring.shape[:-2]
    dram["ring"] = ring.reshape(lead + (-1,)).scatter_add(
        -1, flat, do_issue.to(ring.dtype)).reshape(ring.shape)
    dram["hits"] = accum_by_index(dram["hits"], src, 1, do_issue & is_hit)
    dram["issued"] = accum_by_index(dram["issued"], src, 1, do_issue)
    st["sum_lat"] = accum_by_index(
        st["sum_lat"], src, (done - birth).to(torch.float32), do_issue)
    dram = energy.on_issue(cfg, dram, do_issue, src, is_hit, done)
    if cfg.qos_enabled:
        dram["lat_hist"] = qos.on_issue(cfg, dram["lat_hist"], src,
                                        done - birth, do_issue)
    return dram, st


def channel_of(cfg: SimConfig, bank_global: torch.Tensor) -> torch.Tensor:
    return bank_global % cfg.n_channels


def bank_in_channel(cfg: SimConfig, bank_global: torch.Tensor
                    ) -> torch.Tensor:
    return bank_global // cfg.n_channels
