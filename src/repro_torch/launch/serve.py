"""Serving launcher: SMS-scheduled multi-tenant engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --scheduler sms [--horizon 4000]

Runs the heterogeneous-client workload (4 interactive + 1 bulk tenant)
through the continuous-batching engine under the chosen scheduler and
prints per-client slowdowns — the serving analogue of the paper's Fig 4.
Use examples/serve_heterogeneous_torch.py for the real-model (paged CUDA
kernel) path.
"""
from __future__ import annotations

import argparse

from repro_torch.serving.engine import EngineConfig, fairness_report
from repro_torch.serving.scheduler import SCHEDULERS
from repro_torch.serving.types import default_clients


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheduler", default="sms",
                    choices=sorted(SCHEDULERS.keys()))
    ap.add_argument("--horizon", type=float, default=4_000.0,
                    help="workload horizon (engine ms)")
    ap.add_argument("--pages", type=int, default=4096)
    ap.add_argument("--slots", type=int, default=32)
    args = ap.parse_args()

    clients = default_clients()
    cfg = EngineConfig(n_pages=args.pages, max_slots=args.slots)
    r = fairness_report(args.scheduler, clients, horizon_ms=args.horizon,
                        engine_cfg=cfg)
    print(f"[serve] scheduler={args.scheduler} finished="
          f"{r['total_finished']} throughput={r['total_tok_s']:.0f} tok/s")
    print(f"[serve] {'client':8s} {'n':>5s} {'mean_ms':>9s} {'p99_ms':>9s} "
          f"{'slowdown':>9s}")
    for spec in clients:
        s = r["clients"].get(spec.name)
        if not s:
            continue
        sd = r["slowdowns"].get(spec.name, float("nan"))
        print(f"[serve] {spec.name:8s} {s['n']:5d} "
              f"{s['mean_latency_ms']:9.1f} {s['p99_latency_ms']:9.1f} "
              f"{sd:9.2f}")
    print(f"[serve] max slowdown: {r['max_slowdown']:.2f}")


if __name__ == "__main__":
    main()
