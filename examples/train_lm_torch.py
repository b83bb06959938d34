"""End-to-end training on one NVIDIA GPU: ~100M-param xLSTM for a
few hundred steps.

  python examples/train_lm_torch.py --arch xlstm-125m --steps 300
  python examples/train_lm_torch.py --smoke --device cpu   # tiny + fast

Port of ``examples/train_lm.py``: deterministic sharded data, AdamW +
cosine schedule, async atomic checkpointing with resume, straggler
detection. The checkpoints go to ``--ckpt`` (default: a directory under
the system's temporary directory).
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs.base import RunConfig, ShapeConfig, reduced
from repro_torch.configs.registry import get_config
from repro_torch.train.trainer import StragglerPolicy, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
        args.steps = min(args.steps, 30)
        args.seq = 128
    run = RunConfig(seq_len=args.seq, global_batch=args.batch,
                    compute_dtype="float32", remat="none", lr=3e-4,
                    warmup_steps=20, total_steps=args.steps)
    shape = ShapeConfig("train", "train", args.seq, args.batch)
    trainer = Trainer(cfg, run, shape, ckpt_dir=args.ckpt, ckpt_every=50,
                      straggler=StragglerPolicy(action="report"),
                      device=args.device)
    print(f"arch={cfg.name} params={cfg.n_params() / 1e6:.1f}M "
          f"tokens/step={shape.tokens}")
    state = trainer.train(args.steps)
    for m in trainer.metrics_log[:: max(len(trainer.metrics_log) // 10, 1)]:
        print(f"step {m['step']:4d} loss {m['loss']:.4f} "
              f"({m['step_time_s']:.2f}s)")
    print(f"final loss {trainer.metrics_log[-1]['loss']:.4f} "
          f"at step {state.step}")
    if trainer.events:
        print("events:", trainer.events)


if __name__ == "__main__":
    main()
