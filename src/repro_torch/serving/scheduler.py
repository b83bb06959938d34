"""SMS-staged request scheduler for the serving engine + baselines.

Stage 1 (batch formation): one FIFO per client; consecutive requests hitting
the same shared prefix ("row") form a batch; ready on prefix-change, age
threshold, or full FIFO.

Stage 2 (batch scheduler): among ready batches pick SJF (client with fewest
in-flight requests across all stages) with probability p, else round-robin;
drain the picked batch into stage 3.

Stage 3 (admission FIFO): per-engine FIFO the continuous-batching engine pops
under its token/page budget — the analogue of the DCS issuing under DRAM
timing constraints.

Baselines: FCFS (single global queue) and LOCALITY-FIRST (FR-FCFS analogue:
always prefer requests whose prefix pages are already hot).

Schedulers register with `SCHEDULERS`, an instance of
`repro_torch.core.policy.Registry`, the registry class the cycle sim's memory
policies use, so both domains enumerate and resolve policies through one
mechanism:

    @SCHEDULERS.register
    class MyScheduler(SchedulerBase):
        name = "mine"
        ...
"""
from __future__ import annotations

import collections
import functools
import random
from typing import Deque, Dict, List, Optional

from repro_torch.core.policy import Registry
from repro_torch.serving.types import Request

SCHEDULERS = Registry("serving scheduler")


class SchedulerBase:
    name = "base"

    def __init__(self, n_clients: int, seed: int = 0):
        self.n_clients = n_clients
        self.seed = seed

    def enqueue(self, req: Request, now: float) -> None:
        raise NotImplementedError

    def pop_admission(self, now: float) -> Optional[Request]:
        """Next request to admit into the running batch (or None)."""
        raise NotImplementedError

    def on_finish(self, req: Request) -> None:
        pass

    def queued(self) -> int:
        raise NotImplementedError


@SCHEDULERS.register
class FCFSScheduler(SchedulerBase):
    """Single global arrival-ordered queue (no client awareness)."""

    name = "fcfs"

    def __init__(self, n_clients: int, seed: int = 0):
        super().__init__(n_clients, seed)
        self.q: Deque[Request] = collections.deque()

    def enqueue(self, req, now):
        self.q.append(req)

    def pop_admission(self, now):
        return self.q.popleft() if self.q else None

    def queued(self):
        return len(self.q)


@SCHEDULERS.register
class LocalityFirstScheduler(SchedulerBase):
    """FR-FCFS analogue: requests hitting the currently-open prefix first,
    then oldest. Maximizes page reuse; starves low-locality clients."""

    name = "locality"

    def __init__(self, n_clients: int, seed: int = 0):
        super().__init__(n_clients, seed)
        self.q: List[Request] = []
        self.open_prefix: Optional[int] = None

    def enqueue(self, req, now):
        self.q.append(req)

    def pop_admission(self, now):
        if not self.q:
            return None
        hit = [r for r in self.q if r.prefix_id == self.open_prefix]
        pick = min(hit, key=lambda r: r.arrival) if hit else \
            min(self.q, key=lambda r: r.arrival)
        self.q.remove(pick)
        self.open_prefix = pick.prefix_id
        return pick

    def queued(self):
        return len(self.q)


@SCHEDULERS.register
class SMSScheduler(SchedulerBase):
    """The paper's three stages on serving requests.

    ``adaptive_p`` (beyond paper, from its §5 p-sensitivity study): a
    feedback controller replaces the static SJF probability — when the
    longest-waiting head-of-FIFO belongs to a light (latency-sensitive)
    client, p rises toward SJF; when a heavy client's queue stalls, p falls
    toward round-robin. Bounded to [p_min, p_max].
    """

    name = "sms"

    def __init__(self, n_clients: int, fifo_size: int = 16,
                 age_cap_ms: float = 10.0, sjf_prob: float = 0.9,
                 admission_depth: int = 64, seed: int = 0,
                 adaptive_p: bool = False, p_min: float = 0.5,
                 p_max: float = 0.98, wait_target_ms: float = 30.0):
        super().__init__(n_clients, seed)
        self.fifos: List[Deque[Request]] = [collections.deque()
                                            for _ in range(n_clients)]
        self.fifo_size = fifo_size
        self.age_cap = age_cap_ms
        self.p = sjf_prob
        self.admission: Deque[Request] = collections.deque()
        self.admission_depth = admission_depth
        self.rr = 0
        self.rng = random.Random(seed)
        self.inflight = [0] * n_clients     # across all stages + running
        self.adaptive_p = adaptive_p
        self.p_min, self.p_max = p_min, p_max
        self.wait_target = wait_target_ms
        self.p_trace: List[float] = []

    def _adapt(self, now: float) -> None:
        """One controller step per batch pick."""
        waits = [(now - f[0].arrival, c) for c, f in enumerate(self.fifos)
                 if f]
        if not waits:
            return
        worst_wait, worst_client = max(waits)
        if worst_wait <= self.wait_target:
            return
        median_inflight = sorted(self.inflight)[self.n_clients // 2]
        if self.inflight[worst_client] <= median_inflight:
            self.p = min(self.p + 0.02, self.p_max)   # light client waiting
        else:
            self.p = max(self.p - 0.02, self.p_min)   # heavy client starving
        self.p_trace.append(self.p)

    def enqueue(self, req, now):
        self.fifos[req.client].append(req)
        self.inflight[req.client] += 1

    def _batch_len(self, c: int) -> int:
        f = self.fifos[c]
        if not f:
            return 0
        n, pfx = 0, f[0].prefix_id
        for r in f:
            if r.prefix_id != pfx:
                break
            n += 1
        return n

    def _ready(self, c: int, now: float) -> bool:
        f = self.fifos[c]
        if not f:
            return False
        blen = self._batch_len(c)
        return (blen < len(f)) or (now - f[0].arrival >= self.age_cap) \
            or (len(f) >= self.fifo_size)

    def _drain_one_batch(self, now: float) -> bool:
        ready = [c for c in range(self.n_clients) if self._ready(c, now)]
        if not ready:
            return False
        if self.adaptive_p:
            self._adapt(now)
        if self.rng.random() < self.p:                      # SJF
            pick = min(ready, key=lambda c: (self.inflight[c], c))
        else:                                               # round-robin
            pick = min(ready, key=lambda c: ((c - self.rr) % self.n_clients))
            self.rr = (pick + 1) % self.n_clients
        blen = self._batch_len(pick)
        for _ in range(blen):
            self.admission.append(self.fifos[pick].popleft())
        return True

    def pop_admission(self, now):
        while len(self.admission) < self.admission_depth:
            if not self._drain_one_batch(now):
                break
        return self.admission.popleft() if self.admission else None

    def on_finish(self, req):
        self.inflight[req.client] -= 1

    def queued(self):
        return len(self.admission) + sum(len(f) for f in self.fifos)


SCHEDULERS.register("sms_adaptive")(
    functools.partial(SMSScheduler, adaptive_p=True, sjf_prob=0.7))

# registers the utilization-aware admission-control policy ("admission");
# bottom import so its SchedulerBase/SCHEDULERS imports resolve
from repro_torch.serving import admission as _admission  # noqa: E402,F401
