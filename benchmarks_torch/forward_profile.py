"""Where one full-width forward and loss spends its time on the GPU.

  python3 benchmarks_torch/forward_profile.py [--model qwen1.5-4b|xlstm-125m]

At full width and depth, with random weights from a seed, one batch scored
by ``get_model(cfg).train_loss`` with bf16 compute: the forwards that
chip_smoke.py runs.

* ``qwen1.5-4b`` (the default): bf16 weights, B=2 sequences of S=4096
  tokens, ``use_pallas=True``, so attention runs the flash-attention kernel;
* ``xlstm-125m``: float32 weights, B=8 sequences of S=2048 tokens; the
  mLSTM layers run the model's own chunk scan and the sLSTM layers a loop
  over time steps.

It times forwards with the host clock (each ending in a synchronize), then
traces one with torch.profiler and sums device time by kernel. The device's
idle share is 1 - (device busy time / untraced host time). Prints one JSON
line, with the card's name and power limit.
"""
import argparse
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

# model -> (batch, sequence length, weight dtype, RunConfig overrides)
MODELS = {"qwen1.5-4b": (2, 4096, torch.bfloat16, {"use_pallas": True}),
          "xlstm-125m": (8, 2048, torch.float32, {})}
TIMED = 3


def _category(name: str) -> str:
    low = name.lower()
    if "flash_attention" in low:
        return "flash_attention"
    if "mlstm_scan" in low:
        return "mlstm_scan"
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="qwen1.5-4b", choices=sorted(MODELS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("forward_profile: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, S, wdtype, knobs = MODELS[args.model]
    cfg = get_config(args.model)
    bundle = get_model(cfg)
    run = RunConfig(compute_dtype="bfloat16", **knobs)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = bundle.init(gen, wdtype)
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
        "model": args.model, "batch": B, "seq": S,
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
