"""Where one full-width forward and loss spends its time on the GPU.

  python3 benchmarks_torch/forward_profile.py

Qwen1.5-4B at full width and depth (random bf16 weights from a seed), one
batch of B=2 sequences of S=4096 tokens scored by
``get_model(cfg).train_loss`` with ``RunConfig(compute_dtype="bfloat16",
use_pallas=True)``: the forward that chip_smoke.py's forward phase runs,
attention through the flash-attention kernel. It times forwards with the
host clock (each ending in a synchronize), then traces one with
torch.profiler and sums device time by kernel. The device's idle share is
1 - (device busy time / untraced host time). Prints one JSON line, with
the card's name and power limit.
"""
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch
from torch.autograd import DeviceType

from repro_torch.configs.base import RunConfig
from repro_torch.configs.registry import get_config
from repro_torch.models.registry import get_model

B, S = 2, 4096
TIMED = 3


def _category(name: str) -> str:
    low = name.lower()
    if "flash_attention" in low:
        return "flash_attention"
    if any(s in low for s in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
        return "matmul"
    if any(s in low for s in ("index", "scatter", "gather")):
        return "index"
    if any(s in low for s in ("reduce", "softmax", "logsumexp")):
        return "reduce"
    return "elementwise"


def _busy_us(intervals):
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def main():
    if not torch.cuda.is_available():
        raise SystemExit("forward_profile: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("qwen1.5-4b")
    bundle = get_model(cfg)
    run = RunConfig(compute_dtype="bfloat16", use_pallas=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = bundle.init(gen, torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def forward():
        with torch.no_grad():
            loss = bundle.train_loss(params, run, batch)
        torch.cuda.synchronize()
        return loss

    forward()
    host = []
    for _ in range(TIMED):
        t0 = time.perf_counter()
        forward()
        host.append(time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        forward()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_cat, by_name = {}, {}
    for e in kern:
        us = e.time_range.end - e.time_range.start
        by_cat[_category(e.name)] = by_cat.get(_category(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end)
                        for e in kern]) / 1e3
    host_ms = 1e3 * statistics.median(host)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({
        "card": smi.stdout.strip().splitlines()[0],
        "batch": B, "seq": S,
        "host_forward_ms": [1e3 * t for t in host],
        "host_forward_ms_median": host_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / host_ms),
        "kernels_per_forward": len(kern),
        "device_ms_by_category": {k: v / 1e3 for k, v in by_cat.items()},
        "top_kernels_ms": [[k[:90], v / 1e3] for k, v in top],
        "scored_tok_s": B * S / (host_ms / 1e3),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}))


if __name__ == "__main__":
    main()
