"""Production training loop: checkpoint/restart, straggler mitigation,
emergency save, deterministic data, metrics.

Port of ``repro/train/trainer.py``: ``Trainer(cfg, run, mesh, shape, ...)``
trains over a mesh (one process per rank; params and optimizer state laid
out by the train step's ``in_placements``; checkpoints hold full arrays,
written by rank 0, and restore onto whatever mesh the run has), and with
``mesh=None`` on one device. The one-device form ``Trainer(cfg, run,
shape, ...)`` of earlier callers is kept.
Fault-tolerance model (multi-host semantics):
  * checkpoint every N steps (async, atomic) + emergency save on exception;
  * resume picks up step + data position bit-identically;
  * straggler detection: per-step wall time vs the median; a host
    consistently above `straggler_factor`x median is reported and (policy
    "exclude") dropped from the healthy set -> the run continues on the
    remaining hosts with re-balanced data shards (elastic restart path);
  * `HostDelayInjector` simulates slow/failed hosts for tests/examples.

Each step synchronizes once: it reads the step's metrics to floats (one
device-to-host copy of the three), as the reference does.

The update writes the params and the optimizer state in place, so from
its first write until ``state`` advances no whole state exists: a failure
in that window saves no emergency checkpoint (the event says so), and a
restart resumes from the last periodic one.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.distributed import sharding as shlib
from repro_torch.models.registry import get_model
from repro_torch.optim import adamw
from repro_torch.train import steps as steps_lib

_METRICS = ("loss", "grad_norm", "lr")


@dataclass
class StragglerPolicy:
    factor: float = 3.0          # x median step time
    patience: int = 3            # consecutive slow steps before action
    action: str = "report"       # "report" | "exclude"


@dataclass
class HostDelayInjector:
    """Simulated per-host extra step latency (seconds); tests/demo only."""
    delays: Dict[int, float] = field(default_factory=dict)
    fail_at: Dict[int, int] = field(default_factory=dict)   # host -> step

    def step_time(self, host: int, base: float, step: int) -> float:
        if host in self.fail_at and step >= self.fail_at[host]:
            return float("inf")
        return base + self.delays.get(host, 0.0)


@dataclass
class TrainState:
    params: Any
    opt: adamw.AdamWState
    err: Any
    step: int


class Trainer:
    def __init__(self, cfg: ModelConfig, run: RunConfig, mesh,
                 shape: Optional[ShapeConfig] = None,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 n_hosts: int = 1,
                 straggler: StragglerPolicy = StragglerPolicy(),
                 injector: Optional[HostDelayInjector] = None,
                 device="cuda"):
        if isinstance(mesh, ShapeConfig):    # Trainer(cfg, run, shape, ...)
            mesh, shape = None, mesh
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device; pass device='cpu' "
                               "to train on the CPU")
        self.cfg, self.run, self.mesh, self.shape = cfg, run, mesh, shape
        self.bundle = get_model(cfg)
        self.ckpt_dir = Path(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.n_hosts = n_hosts
        self.healthy_hosts = list(range(n_hosts))
        self.straggler = straggler
        self.injector = injector
        self.slow_counts = [0] * n_hosts
        self.step_times: List[float] = []
        self.metrics_log: List[Dict[str, float]] = []
        self.events: List[str] = []

        self._step = steps_lib.build_train_step(cfg, run, shape, mesh)
        self.data_cfg = DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=shape.seq_len,
                                   global_batch=shape.global_batch,
                                   seed=run.seed)

    # -- state ------------------------------------------------------------
    def init_state(self, seed: int = 0) -> TrainState:
        """Random weights from a ``torch.Generator`` on the device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self.bundle.init(gen)
        opt = adamw.init(params)
        err = (tree_lib.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
            if self.run.grad_compression == "topk"
            else torch.zeros((), device=self.device))
        if self.mesh is not None:
            lay = steps_lib.in_placements(self.cfg, self.run, self.mesh,
                                          self.shape)
            params, opt, err = (shlib.place(t, pl, self.mesh) for t, pl in
                                zip((params, opt, err), lay))
        return TrainState(params, opt, err, 0)

    def maybe_restore(self) -> Optional[TrainState]:
        if not self.ckpt_dir:
            return None
        step = ckpt.latest_step(self.ckpt_dir)
        if step is None:
            return None
        st = self.init_state()
        tree = {"params": st.params, "opt": st.opt, "err": st.err}
        restored, manifest = ckpt.restore(self.ckpt_dir, step, tree)
        self.events.append(f"restored step {step}")
        return TrainState(restored["params"], restored["opt"],
                          restored["err"], step)

    # -- straggler handling -------------------------------------------------
    def _host_step_times(self, base: float, step: int) -> List[float]:
        if self.injector is None:
            return [base] * len(self.healthy_hosts)
        return [self.injector.step_time(h, base, step)
                for h in self.healthy_hosts]

    def _check_stragglers(self, times: List[float], step: int) -> None:
        med = float(np.median([t for t in times if np.isfinite(t)]))
        for i, h in enumerate(list(self.healthy_hosts)):
            slow = (not np.isfinite(times[i])) or \
                times[i] > self.straggler.factor * max(med, 1e-9)
            self.slow_counts[h] = self.slow_counts[h] + 1 if slow else 0
            if self.slow_counts[h] >= self.straggler.patience or \
                    not np.isfinite(times[i]):
                self.events.append(
                    f"step {step}: host {h} straggling "
                    f"({times[i]:.3f}s vs median {med:.3f}s)")
                if self.straggler.action == "exclude":
                    self.healthy_hosts.remove(h)
                    self.events.append(
                        f"step {step}: excluded host {h}; "
                        f"{len(self.healthy_hosts)} hosts remain; "
                        f"data re-balanced")
                self.slow_counts[h] = 0

    # -- loop ---------------------------------------------------------------
    def _save(self, state: TrainState, extra=None, sync=False) -> None:
        tree = {"params": state.params, "opt": state.opt, "err": state.err}
        if sync:
            ckpt.save(self.ckpt_dir, state.step, tree, extra=extra)
        else:
            ckpt.save_async(self.ckpt_dir, state.step, tree).join()
        if self.mesh is not None:
            dist.barrier()      # rank 0 has written before anyone reads

    def train(self, n_steps: int, state: Optional[TrainState] = None
              ) -> TrainState:
        state = state or self.maybe_restore() or self.init_state()
        mutating = False

        def begin_update():
            nonlocal mutating
            mutating = True

        try:
            for _ in range(n_steps):
                t0 = time.time()
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in synthetic_batch(self.data_cfg,
                                                     state.step).items()}
                params, opt, err, metrics = self._step(
                    state.params, state.opt, state.err, batch, state.step,
                    before_update=begin_update)
                vals = torch.stack([metrics[k].float()
                                    for k in _METRICS]).tolist()
                metrics = dict(zip(_METRICS, vals))
                state = TrainState(params, opt, err, state.step + 1)
                mutating = False
                dt = time.time() - t0
                self.step_times.append(dt)
                host_times = self._host_step_times(dt, state.step)
                self._check_stragglers(host_times, state.step)
                metrics["step"] = state.step
                metrics["step_time_s"] = dt
                self.metrics_log.append(metrics)
                if self.ckpt_dir and state.step % self.ckpt_every == 0:
                    self._save(state)
                    ckpt.prune_old(self.ckpt_dir)
        except Exception:
            if self.ckpt_dir and mutating:
                self.events.append(f"no emergency checkpoint at "
                                   f"{state.step}: the step had begun to "
                                   f"update the state")
            elif self.ckpt_dir:
                self._save(state, extra={"emergency": True}, sync=True)
                self.events.append(f"emergency checkpoint at {state.step}")
            raise
        return state
