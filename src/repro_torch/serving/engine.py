"""Continuous-batching engine with SMS-staged admission.

Two backends share the control plane:
  * CostModelBackend — step latency from a calibrated cost model
    (ms = c0 + c_tok·tokens + c_page·distinct_pages). Used by the scheduling
    benchmarks: page-distinctness is exactly what stage-1 locality batching
    optimizes (shared-prefix pages are counted once per step — the "row hit").
  * Real backend (examples/tests) — repro_torch.serving.paged_lm running a
    real model over the paged pool with the CUDA paged-attention kernel
    (examples/serve_heterogeneous_torch.py drives it).

The engine admits from the scheduler under slot/page budgets, chunk-prefills,
then decodes one token per running sequence per step.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.serving.kv_cache import PagedAllocator
from repro_torch.serving.scheduler import SCHEDULERS, SchedulerBase
from repro_torch.serving.types import ClientSpec, Request


@dataclass
class RunningSeq:
    req: Request
    pages: List[int]
    target_len: int          # prompt + max_new
    cur_len: int = 0         # tokens materialized in KV
    n_shared: int = 0


@dataclass
class EngineConfig:
    page_size: int = 16
    n_pages: int = 4096
    max_slots: int = 32
    prefill_budget: int = 256       # prompt tokens per step
    # cost model (ms)
    c0: float = 0.5
    c_tok: float = 0.004
    c_page: float = 0.010


@dataclass
class StepStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0
    distinct_pages: int = 0


class ServingEngine:
    def __init__(self, cfg: EngineConfig, scheduler: SchedulerBase,
                 seed: int = 0):
        self.cfg = cfg
        self.sched = scheduler
        self.alloc = PagedAllocator(cfg.n_pages, cfg.page_size)
        self.running: List[RunningSeq] = []
        self.now = 0.0
        self.finished: List[Request] = []
        self.steps = 0
        self.rng = np.random.RandomState(seed)

    # -- admission -----------------------------------------------------
    def _try_admit(self) -> None:
        while len(self.running) < self.cfg.max_slots:
            req = self.sched.pop_admission(self.now)
            if req is None:
                return
            total = req.prompt_len + req.max_new
            prefix_id = req.prefix_id if req.prefix_id >= 0 else None  # <0: private
            got = self.alloc.alloc_seq(total, prefix_id,
                                       prefix_len=min(req.prompt_len,
                                                      self._prefix_len(req)))
            if got is None:
                # out of pages: put it back at the head (engine backpressure)
                self.sched.admission.appendleft(req) if hasattr(
                    self.sched, "admission") else self.sched.enqueue(
                        req, self.now)
                return
            pages, n_shared = got
            req.admitted = self.now
            shared_tokens = n_shared * self.cfg.page_size
            self.running.append(RunningSeq(
                req, pages, total, cur_len=shared_tokens, n_shared=n_shared))
            req.prefilled = shared_tokens

    def _prefix_len(self, req: Request) -> int:
        return getattr(req, "shared_prefix_len", 0)

    # -- one engine iteration -------------------------------------------
    def step(self) -> StepStats:
        self._try_admit()
        st = StepStats()
        touched: Set[int] = set()
        budget = self.cfg.prefill_budget
        done: List[RunningSeq] = []
        for rs in self.running:
            if rs.cur_len < rs.req.prompt_len and budget > 0:
                chunk = min(budget, rs.req.prompt_len - rs.cur_len)
                lo, hi = rs.cur_len, rs.cur_len + chunk
                touched.update(rs.pages[lo // self.cfg.page_size:
                                        -(-hi // self.cfg.page_size)])
                rs.cur_len = hi
                rs.req.prefilled = hi
                st.prefill_tokens += chunk
                budget -= chunk
        for rs in self.running:
            if rs.cur_len >= rs.req.prompt_len:
                # decode one token: reads all of the sequence's pages
                touched.update(rs.pages[: -(-rs.cur_len //
                                            self.cfg.page_size)])
                rs.cur_len += 1
                rs.req.generated += 1
                st.decode_tokens += 1
                if rs.req.first_token is None:
                    rs.req.first_token = self.now
                if rs.req.done:
                    done.append(rs)
        st.distinct_pages = len(touched)
        dt = self.cfg.c0 + self.cfg.c_tok * (
            st.prefill_tokens + st.decode_tokens) + \
            self.cfg.c_page * st.distinct_pages
        self.now += dt
        self.steps += 1
        for rs in done:
            rs.req.finished = self.now
            self.alloc.free_seq(rs.pages)
            self.sched.on_finish(rs.req)
            self.finished.append(rs.req)
            self.running.remove(rs)
        return st


# ---------------------------------------------------------------------------
# workload generation + driver
# ---------------------------------------------------------------------------

def generate_requests(clients: List[ClientSpec], horizon_ms: float,
                      seed: int = 0) -> List[Request]:
    rng = np.random.RandomState(seed)
    out: List[Request] = []
    rid = 0
    for ci, spec in enumerate(clients):
        if spec.kind == "interactive":
            t = float(rng.exponential(spec.rate_ms))
            while t < horizon_ms:
                # unique (non-shared) prefix per interactive request
                r = Request(rid, ci, prefix_id=-(rid + 1),
                            prompt_len=spec.prompt_len, max_new=spec.max_new,
                            arrival=t)
                r.shared_prefix_len = 0
                out.append(r)
                rid += 1
                t += float(rng.exponential(spec.rate_ms))
        else:
            for k in range(spec.n_queued):
                pfx = 10_000 * (ci + 1) + (k % spec.n_prefixes)
                r = Request(rid, ci, prefix_id=pfx,
                            prompt_len=spec.prompt_len, max_new=spec.max_new,
                            arrival=0.0)
                r.shared_prefix_len = spec.shared_prefix_len
                out.append(r)
                rid += 1
    out.sort(key=lambda r: r.arrival)
    return out


def run_serving(policy: str, clients: List[ClientSpec],
                horizon_ms: float = 8_000.0, engine_cfg: EngineConfig = None,
                active: Optional[Set[int]] = None, seed: int = 0,
                max_steps: int = 200_000) -> Dict:
    """Run one policy; `active` restricts to a client subset (alone runs)."""
    engine_cfg = engine_cfg or EngineConfig()
    sched = SCHEDULERS.get(policy)(len(clients), seed=seed)
    eng = ServingEngine(engine_cfg, sched, seed=seed)
    reqs = generate_requests(clients, horizon_ms, seed=seed)
    if active is not None:
        reqs = [r for r in reqs if r.client in active]
    i = 0
    while eng.steps < max_steps:
        while i < len(reqs) and reqs[i].arrival <= eng.now:
            sched.enqueue(reqs[i], eng.now)
            i += 1
        if i >= len(reqs) and not eng.running and sched.queued() == 0:
            break
        if eng.now > horizon_ms * 4:        # runaway guard
            break
        eng.step()

    per_client: Dict[int, List[Request]] = {}
    for r in eng.finished:
        per_client.setdefault(r.client, []).append(r)
    stats = {}
    for ci, spec in enumerate(clients):
        rs = per_client.get(ci, [])
        if not rs:
            continue
        lat = np.array([r.latency for r in rs])
        ttft = np.array([(r.first_token - r.arrival) for r in rs
                         if r.first_token is not None])
        stats[spec.name] = {
            "n": len(rs),
            "mean_latency_ms": float(lat.mean()),
            "p99_latency_ms": float(np.percentile(lat, 99)),
            "mean_ttft_ms": float(ttft.mean()) if len(ttft) else None,
            "throughput_tok_s": float(sum(r.generated for r in rs)
                                      / max(eng.now / 1e3, 1e-9)),
        }
    return {
        "policy": policy,
        "clients": stats,
        "total_finished": len(eng.finished),
        "elapsed_ms": eng.now,
        "engine_steps": eng.steps,
        "total_tok_s": float(sum(r.generated for r in eng.finished)
                             / max(eng.now / 1e3, 1e-9)),
    }


def fairness_report(policy: str, clients: List[ClientSpec],
                    horizon_ms: float = 8_000.0,
                    engine_cfg: EngineConfig = None, seed: int = 0) -> Dict:
    """Shared run + per-client alone runs -> slowdowns (paper's metric)."""
    shared = run_serving(policy, clients, horizon_ms, engine_cfg, seed=seed)
    slowdowns = {}
    for ci, spec in enumerate(clients):
        alone = run_serving(policy, clients, horizon_ms, engine_cfg,
                            active={ci}, seed=seed)
        a = alone["clients"].get(spec.name)
        s = shared["clients"].get(spec.name)
        if a and s:
            slowdowns[spec.name] = s["mean_latency_ms"] / \
                max(a["mean_latency_ms"], 1e-9)
    shared["slowdowns"] = slowdowns
    shared["max_slowdown"] = max(slowdowns.values()) if slowdowns else None
    return shared
