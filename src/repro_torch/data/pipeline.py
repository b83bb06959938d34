"""Deterministic, shardable synthetic token pipeline.

Every (step, global-row) cell is generated from a counter-based hash, so:
  * any data-parallel host can materialize exactly its rows (no broadcast),
  * restarts resume mid-stream bit-identically (fault tolerance),
  * elastic re-sharding (different host counts) yields the same global batch.

A real deployment swaps `synthetic_batch` for a tokenized corpus reader with
the same (step, row) -> example contract.

Port of ``repro/data/pipeline.py``: a numpy copy, so the port imports
nothing of the JAX package; its batches are bit-identical to the
reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


def _hash2(a: np.ndarray, b: np.ndarray, seed: int) -> np.ndarray:
    """64-bit mix of two uint64 arrays (splitmix-style)."""
    x = (a * np.uint64(0x9E3779B97F4A7C15) ^
         (b + np.uint64(seed) * np.uint64(0xBF58476D1CE4E5B9)))
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # markov-ish structure so the loss actually decreases
    n_patterns: int = 64
    pattern_len: int = 16


def synthetic_batch(cfg: DataConfig, step: int, row_start: int = 0,
                    n_rows: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Rows [row_start, row_start+n_rows) of step's global batch.

    Tokens follow repeated vocab patterns with hash-seeded phase, giving a
    learnable distribution (bigram structure) rather than iid noise.
    """
    n_rows = cfg.global_batch if n_rows is None else n_rows
    rows = (np.arange(row_start, row_start + n_rows, dtype=np.uint64)
            + np.uint64(step) * np.uint64(cfg.global_batch))
    pos = np.arange(cfg.seq_len + 1, dtype=np.uint64)
    h = _hash2(rows[:, None], pos[None, :] // np.uint64(cfg.pattern_len),
               cfg.seed)
    pattern = (h % np.uint64(cfg.n_patterns)).astype(np.int64)
    phase = pos[None, :] % np.uint64(cfg.pattern_len)
    toks = (pattern * cfg.pattern_len + phase.astype(np.int64)) \
        % max(cfg.vocab_size - 2, 1) + 1
    noise = _hash2(rows[:, None], pos[None, :], cfg.seed + 1)
    flip = (noise % np.uint64(100)) < np.uint64(3)      # 3% noise tokens
    toks = np.where(flip, (noise % np.uint64(cfg.vocab_size)).astype(np.int64),
                    toks)
    toks = toks.astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def host_iterator(cfg: DataConfig, host_id: int, n_hosts: int,
                  start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """This host's shard of each step (contiguous row block)."""
    assert cfg.global_batch % n_hosts == 0
    per = cfg.global_batch // n_hosts
    step = start_step
    while True:
        yield synthetic_batch(cfg, step, row_start=host_id * per, n_rows=per)
        step += 1


def batch_checksum(batch: Dict[str, np.ndarray]) -> int:
    return int(sum(int(v.astype(np.int64).sum()) for v in batch.values()))
