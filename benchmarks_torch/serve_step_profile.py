"""Where one full-width paged decode step spends its time on the GPU.

  python3 benchmarks_torch/serve_step_profile.py

Qwen1.5-4B at full width and depth (random bf16 weights from a seed,
float32 KV pools, page 16), 32 sequences decoding one token each at
position 284 through ``repro_torch.serving.paged_lm`` — the step that
chip_smoke.py's serve phase repeats (pos 284 is the mean position of its
bulk replays). It times steps with the host clock, each ending in a copy of
the next tokens to the host as the serving loop does, then traces a few
steps with torch.profiler and sums device time by kernel. The device's
idle share is 1 - (device time per step / untraced host time per step).
Prints one JSON line, with the card's name and power limit.
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
from repro_torch.models import lm
from repro_torch.serving import paged_lm

PAGE = 16
BATCH, POS = 32, 284
TIMED, TRACED = 20, 5       # steps timed untraced, steps traced


def _category(name: str) -> str:
    low = name.lower()
    if "paged_attention" in low:
        return "paged_attention"
    if any(s in low for s in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
        return "matmul"
    if any(s in low for s in ("index", "scatter", "gather")):
        return "index"
    return "other"


def _busy_us(intervals):
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def main():
    if not torch.cuda.is_available():
        raise SystemExit("serve_step_profile: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("qwen1.5-4b")
    run = RunConfig(compute_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm.init(gen, cfg, dtype=torch.bfloat16)
    B = BATCH
    n_slots = -(-(POS + 1) // PAGE)
    pools = paged_lm.init_pools(cfg, B * n_slots, PAGE)
    pt = torch.arange(B * n_slots, dtype=torch.int32,
                      device="cuda").reshape(B, n_slots)
    tok = torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                        device="cuda", dtype=torch.int32)
    pos = torch.full((B,), POS, dtype=torch.int32, device="cuda")

    def step():
        logits, _ = paged_lm.paged_decode_step(params, cfg, run, pools, tok,
                                               pos, pt, page_size=PAGE)
        return logits.argmax(-1).tolist()

    for _ in range(3):
        step()
    host = []
    for _ in range(TIMED):
        t0 = time.perf_counter()
        step()
        host.append(time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(TRACED):
            step()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_cat, by_name = {}, {}
    for e in kern:
        us = e.time_range.end - e.time_range.start
        by_cat[_category(e.name)] = by_cat.get(_category(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    n = TRACED
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end)
                        for e in kern]) / n / 1e3
    host_ms = 1e3 * statistics.median(host)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({
        "card": smi.stdout.strip().splitlines()[0],
        "batch": B, "pos": POS,
        "host_step_ms_median": host_ms,
        "host_step_ms_min": 1e3 * min(host),
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / host_ms),
        "kernels_per_step": len(kern) / n,
        "device_ms_per_step_by_category": {k: v / n / 1e3
                                           for k, v in by_cat.items()},
        "top_kernels_ms_per_step": [[k[:90], v / n / 1e3] for k, v in top],
        "decode_tok_s": B / (host_ms / 1e3)}))


if __name__ == "__main__":
    main()
