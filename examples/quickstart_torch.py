"""Quickstart on the PyTorch port: SMS vs FR-FCFS, on the GPU by default.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
      [--policies frfcfs,sms] [--cycles 8000] [--warmup 1000]

The port of ``examples/quickstart.py``: the same configuration, workloads and
cycle counts, and the same table of nine rows (the eight built-in policies
in the registry's order, then the `Oldest` policy below). Every scheduler is a
`MemoryPolicy` object in the port's registry (`repro_torch.core.policy`);
`Oldest` is a complete custom policy: subclass `CentralizedPolicy`, override
`score`, decorate with `@policy.register`.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core import metrics as met  # noqa: E402
from repro_torch.core import policy  # noqa: E402
from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.core import workloads as wl  # noqa: E402
from repro_torch.core.params import SimConfig  # noqa: E402
from repro_torch.core.schedulers import CentralizedPolicy, base_score  # noqa


@policy.register
class Oldest(CentralizedPolicy):
    """Pure FCFS: age only, ignoring row hits — a 5-line custom policy."""

    name = "oldest"

    def score(self, cfg, pool, buf, is_hit, t):
        return base_score(cfg, buf, 0 * is_hit, t)


# 4 CPU cores + 1 GPU sharing 2 memory channels, high-intensity mix
CFG = SimConfig(n_cpu=4, n_channels=2, buf_entries=72, fifo_size=8,
                dcs_size=4)


def workloads(cfg=CFG):
    return [w for w in wl.make_workloads(cfg.n_cpu, n_per_cat=3, seed=0)
            if w.category in ("H", "HM")]


def aggregate(pol, n_cycles=8_000, warmup=1_000, device=None, cfg=CFG):
    """The quickstart's aggregate metrics for one policy: alone runs for
    the per-benchmark baselines, then the shared workloads."""
    wls = workloads(cfg)
    pool, active = wl.pool_batch(cfg, wls)
    apool, aactive, amap = wl.alone_batch(cfg)
    am = sim.simulate(cfg, pol, apool, aactive, n_cycles, warmup,
                      device=device)
    alone = wl.alone_perf_lookup(cfg, am, amap)
    m = sim.simulate(cfg, pol, pool, active, n_cycles, warmup, device=device)
    perf = sim.perf_vector(cfg, m, pool)
    rows = [met.workload_metrics(cfg, w, perf[i], alone)
            for i, w in enumerate(wls)]
    return met.aggregate(rows)


def format_row(pol, a):
    return (f"{pol:12s} {a['weighted_speedup']:6.3f} "
            f"{a['cpu_weighted_speedup']:6.3f} {a['gpu_speedup']:6.3f} "
            f"{a['max_slowdown']:6.2f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs anywhere)")
    ap.add_argument("--policies", default=",".join(policy.names()),
                    help="comma-separated registry names")
    ap.add_argument("--cycles", type=int, default=8_000,
                    help="measured cycles per run")
    ap.add_argument("--warmup", type=int, default=1_000)
    args = ap.parse_args(argv)
    wls = workloads()
    print(f"{len(wls)} workloads x {CFG.n_src} sources, "
          f"{CFG.n_channels} channels\n")
    print(f"{'policy':12s} {'WS':>6s} {'cpuWS':>6s} {'gpuSU':>6s} "
          f"{'maxSD':>6s}")
    out = {}
    for pol in args.policies.split(","):
        out[pol] = aggregate(pol, args.cycles, args.warmup, args.device)
        print(format_row(pol, out[pol]), flush=True)
    print("\nExpected: SMS best WS and (much) best max-slowdown — the "
          "paper's Fig 4 in miniature.")
    return out


if __name__ == "__main__":
    main()
