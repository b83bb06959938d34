"""Serving request/client types for the SMS-as-LLM-scheduler adaptation.

Mapping from the paper (DESIGN.md §2):
  DRAM row       <-> shared prefix block (KV pages reused across requests)
  CPU core       <-> interactive client (few outstanding, latency-sensitive)
  GPU            <-> bulk client (deep queue, heavy shared-prefix locality)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Request:
    rid: int
    client: int
    prefix_id: int              # "row address": which shared prefix it hits
    prompt_len: int
    max_new: int
    arrival: float              # engine time (ms)
    # lifecycle
    admitted: Optional[float] = None
    first_token: Optional[float] = None
    finished: Optional[float] = None
    generated: int = 0
    prefilled: int = 0

    @property
    def done(self) -> bool:
        return self.generated >= self.max_new

    @property
    def latency(self) -> float:
        return (self.finished - self.arrival) if self.finished else float("inf")


@dataclass
class ClientSpec:
    name: str
    kind: str                   # "interactive" | "bulk"
    rate_ms: float              # mean inter-arrival (interactive)
    n_queued: int               # initial queue depth (bulk)
    prompt_len: int
    shared_prefix_len: int      # tokens served from shared prefix pages
    max_new: int
    n_prefixes: int             # distinct prefixes the client cycles over


def default_clients() -> List[ClientSpec]:
    return [
        ClientSpec("chat0", "interactive", 40.0, 0, 96, 0, 24, 1 << 30),
        ClientSpec("chat1", "interactive", 55.0, 0, 64, 0, 24, 1 << 30),
        ClientSpec("chat2", "interactive", 70.0, 0, 128, 0, 32, 1 << 30),
        ClientSpec("chat3", "interactive", 90.0, 0, 80, 0, 16, 1 << 30),
        # bulk batch-inference tenant: deep queue, strong prefix locality
        ClientSpec("bulk", "bulk", 0.0, 600, 544, 512, 24, 3),
    ]
