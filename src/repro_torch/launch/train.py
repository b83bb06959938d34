"""Production training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
      --steps 200 [--seq 512 --batch 8 --ckpt DIR --smoke --device cpu]

Port of ``repro/launch/train.py``: resolves the arch config, builds the
local mesh and runs the fault-tolerant Trainer (checkpoint/restart,
straggler watchdog), on the card by default. The mesh is
``make_local_mesh()`` over the default process group, which the caller
owns (``distributed.world.init`` in each rank, then ``main``); a process
with no group trains on its one device, with no mesh.
"""
from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from repro_torch.configs.base import RunConfig, ShapeConfig, reduced
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.train.trainer import StragglerPolicy, Trainer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m", choices=list(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "topk"])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    return ap.parse_args(argv)


def make_trainer(args: argparse.Namespace) -> Trainer:
    """The Trainer the command line asks for (its schedule spans
    ``--steps``)."""
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    run = RunConfig(seq_len=args.seq, global_batch=args.batch, lr=args.lr,
                    warmup_steps=max(args.steps // 10, 1),
                    total_steps=args.steps,
                    compute_dtype="float32", remat="none",
                    zero1=args.zero1, grad_compression=args.grad_compression)
    shape = ShapeConfig("train", "train", args.seq, args.batch)
    mesh = (make_local_mesh(device_type=torch.device(args.device).type)
            if dist.is_initialized() else None)
    return Trainer(cfg, run, mesh, shape, ckpt_dir=args.ckpt,
                   ckpt_every=args.ckpt_every,
                   straggler=StragglerPolicy(action="report"),
                   device=args.device)


def main(argv=None):
    args = parse_args(argv)
    trainer = make_trainer(args)
    cfg, shape = trainer.cfg, trainer.shape
    print(f"[train] {cfg.name}: {cfg.n_params() / 1e6:.1f}M params, "
          f"{shape.tokens} tokens/step, {args.steps} steps")
    state = trainer.train(args.steps)
    losses = [m["loss"] for m in trainer.metrics_log]
    print(f"[train] done at step {state.step}: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    for e in trainer.events:
        print(f"[train] event: {e}")
    return trainer, state


if __name__ == "__main__":
    main()
