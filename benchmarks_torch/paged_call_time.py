"""Host and device time of one K1 call through the public wrapper.

  python3 benchmarks_torch/paged_call_time.py [--src DIR]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``), so that
one run on one card and host can time two commits of the port: unpack the
other commit with ``git archive`` into a git-ignored directory and pass its
``src``. At the serving shape (B=32, H=20, d=128, page 16, 36 slots, 2048
pages, f32) and the kernel bench's two K1 shapes, all with the kernel
bench's inputs (``kernel_bench.paged_inputs``, seed 0),
``ops.paged_attention`` is timed three ways:

* ``eager_ms``: one call between two CUDA events, median of 50 (how
  ``chip_smoke.py`` reports K1's ``ms``);
* ``host_us``: host time per call, a loop of 100 calls on the host clock
  with no synchronisation inside, median of 10 loops (the device queue
  takes the launches; it is drained between loops, untimed);
* ``device_ms``: device time per call, CUDA-graph replays of 20 calls.

Prints one JSON line with the card's name and power limit, the package
directory and its K1 launch count. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

SHAPES = {"serving": (32, 20, 20, 128, 16, 36, 2048),
          "bench_B8H8/2d128p64": (8, 8, 2, 128, 64, 8, 128),
          "bench_B32H4/4d64p16": (32, 4, 4, 64, 16, 16, 1024)}
LOOP, LOOPS = 100, 10


def host_us(fn) -> float:
    import torch
    times = []
    for _ in range(LOOPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LOOP):
            fn()
        times.append((time.perf_counter() - t0) / LOOP * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("paged_call_time: needs a CUDA device")
    # the package first, from --src, so that kernel_bench's own path entry
    # cannot pull in another copy
    import repro_torch
    from repro_torch.kernels.paged_attention import ops
    sys.path.insert(1, ROOT)
    from benchmarks_torch import kernel_bench
    if not os.path.abspath(repro_torch.__file__).startswith(src):
        raise SystemExit(f"paged_call_time: imported {repro_torch.__file__}, "
                         f"not from {src}")
    rows = {}
    for name, shape in SHAPES.items():
        x, _, _ = kernel_bench.paged_inputs("cuda", *shape)
        fn = lambda: ops.paged_attention(*x)      # noqa: E731
        fn()
        rows[name] = {"eager_ms": kernel_bench.time_ms(fn, 50),
                      "host_us": host_us(fn),
                      "device_ms": kernel_bench.device_ms(fn)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    out = {"card": smi.stdout.strip().splitlines()[0],
           "package": os.path.dirname(os.path.abspath(repro_torch.__file__)),
           "launches": ops.paged_attention.launches,
           "shapes": rows}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
