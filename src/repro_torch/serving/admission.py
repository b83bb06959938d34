"""Utilization-aware admission control for the serving engine.

Port of the GPU-scheduler admission-control ideas (ROADMAP item 2): a
moving-average utilization tracker with spike detection and a cooldown
window, as a registered serving `SCHEDULERS` policy. The scheduler
estimates each request's cost as its total token footprint
(prompt + max_new), tracks the in-flight total against a capacity, and:

  * admits lightest-first while the *effective* load — in-flight plus the
    candidate's cost scaled by a safety headroom — stays under
    ``threshold`` of capacity (admit-below-threshold);
  * maintains an exponential moving average of utilization and flags a
    spike when instantaneous utilization exceeds ``spike_ratio`` times
    the average AND jumped by more than ``spike_jump`` in one observation
    (a burst the average hasn't caught up with — the jump term keeps a
    gradual self-induced ramp from idle out of the detector);
  * on a spike, enters a cooldown window during which nothing is
    admitted, letting the running batch drain before taking more load.

Queued work is never dropped — admission is deferred, not refused — so
request conservation holds (everything is admitted once load allows).
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

from repro_torch.serving.scheduler import SCHEDULERS, SchedulerBase
from repro_torch.serving.types import Request


def request_cost(req: Request) -> int:
    """Token-footprint estimate: KV pages + compute both scale with it."""
    return req.prompt_len + req.max_new


@SCHEDULERS.register
class AdmissionControlScheduler(SchedulerBase):
    name = "admission"

    def __init__(self, n_clients: int, seed: int = 0,
                 capacity_tokens: int = 8192, threshold: float = 0.85,
                 headroom: float = 1.1, ema_alpha: float = 0.1,
                 spike_ratio: float = 1.5, spike_jump: float = 0.25,
                 util_floor: float = 0.2, cooldown_ms: float = 25.0):
        super().__init__(n_clients, seed)
        self.capacity = float(capacity_tokens)
        self.threshold = threshold
        self.headroom = headroom
        self.ema_alpha = ema_alpha
        self.spike_ratio = spike_ratio
        self.spike_jump = spike_jump
        self.util_floor = util_floor
        self.cooldown = cooldown_ms
        # lightest-first admission order; arrival then rid break ties so
        # equal-cost requests stay FCFS and the heap never compares Requests
        self.q: List[Tuple[int, float, int, Request]] = []
        self.inflight_tokens = 0
        self.util_ema = 0.0
        self.cooldown_until = -1.0
        self.spikes = 0
        self.util_trace: List[float] = []

    # -- utilization tracking ----------------------------------------------
    def _utilization(self) -> float:
        return self.inflight_tokens / self.capacity

    def _observe(self, now: float) -> float:
        """One tracker step: update the moving average, detect a spike."""
        util = self._utilization()
        prev = self.util_ema
        self.util_ema = (1.0 - self.ema_alpha) * prev + self.ema_alpha * util
        self.util_trace.append(util)
        if now >= self.cooldown_until \
                and util - prev > self.spike_jump \
                and util > self.spike_ratio * max(prev, self.util_floor):
            self.spikes += 1
            self.cooldown_until = now + self.cooldown
        return util

    # -- SchedulerBase protocol --------------------------------------------
    def enqueue(self, req: Request, now: float) -> None:
        heapq.heappush(self.q, (request_cost(req), req.arrival, req.rid, req))

    def pop_admission(self, now: float) -> Optional[Request]:
        util = self._observe(now)
        if not self.q or now < self.cooldown_until:
            return None
        cost, _, _, req = self.q[0]
        effective = util + (cost * self.headroom) / self.capacity
        if effective > self.threshold:
            return None
        heapq.heappop(self.q)
        self.inflight_tokens += cost
        return req

    def on_finish(self, req: Request) -> None:
        self.inflight_tokens -= request_cost(req)

    def queued(self) -> int:
        return len(self.q)
