"""SMS-scheduled serving with a REAL model over a paged KV pool (PyTorch).

  PYTHONPATH=src python examples/serve_heterogeneous_torch.py [--device cpu]

The port of examples/serve_heterogeneous.py. Two clients — an interactive
chat stream and a bulk tenant whose requests share a prefix — are scheduled
by the three SMS stages into a continuous-batching loop that runs a tiny
dense model through ``repro_torch.serving.paged_lm`` (the CUDA
paged-attention kernel on the card, its plain version on the CPU).
Shared-prefix pages are allocated once and ref-counted (stage-1 "row hits").

``serve`` is the loop itself; chip_smoke.py drives it at full width.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np
import torch

from repro_torch.configs.base import RunConfig, reduced
from repro_torch.configs.registry import get_config
from repro_torch.models import lm
from repro_torch.serving import paged_lm
from repro_torch.serving.kv_cache import PagedAllocator
from repro_torch.serving.scheduler import SMSScheduler
from repro_torch.serving.types import Request

PAGE = 8
RUN = RunConfig(compute_dtype="float32")


def example_config():
    return reduced(get_config("qwen1.5-4b"), n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                   vocab_size=256)


def example_requests():
    """Client 0: 3 interactive requests; client 1: 4 bulk requests that
    share a two-page prefix."""
    reqs = []
    rid = 0
    for i in range(3):
        r = Request(rid, 0, prefix_id=-(rid + 1), prompt_len=6, max_new=6,
                    arrival=float(i))
        r.shared_prefix_len = 0
        reqs.append(r)
        rid += 1
    for i in range(4):
        r = Request(rid, 1, prefix_id=42, prompt_len=2 * PAGE + 3, max_new=6,
                    arrival=0.0)
        r.shared_prefix_len = 2 * PAGE
        reqs.append(r)
        rid += 1
    return reqs


def serve(cfg, params, device, requests, n_running=4, *, run=RUN,
          page_size=PAGE, n_pages=64,
          decode=paged_lm.paged_decode_step):
    """Serve ``requests`` and yield one record per decode step.

    Each request is enqueued into the SMS scheduler once the loop's clock
    (1.0 per step) reaches its arrival. Up to ``n_running`` admitted
    sequences share each decode step; a prompt is replayed token by token
    through the same paged step (chunked prefill), then ``max_new`` tokens
    are generated greedily. Prompts are drawn at admission from
    ``np.random.RandomState(0)``. ``decode`` has the signature of
    ``paged_lm.paged_decode_step``. Each record is a dict with ``step``,
    ``now``, ``batch`` (sequences in the step), ``admitted`` (requests) and
    ``finished`` (``(request, generated tokens)`` pairs) of that step. The
    generator ends when every request has finished.
    """
    reqs = sorted(requests, key=lambda r: r.arrival)
    n_clients = 1 + max(r.client for r in reqs)
    alloc = PagedAllocator(n_pages=n_pages, page_size=page_size)
    sched = SMSScheduler(n_clients=n_clients, sjf_prob=0.9, age_cap_ms=5.0)
    pools = paged_lm.init_pools(cfg, n_pages=n_pages, page_size=page_size,
                                device=device)
    rng = np.random.RandomState(0)
    running = []   # [req, pages, tokens, pos]
    now, step, i, n_done = 0.0, 0, 0, 0
    while n_done < len(reqs):
        while i < len(reqs) and reqs[i].arrival <= now:
            sched.enqueue(reqs[i], now)
            i += 1
        admitted = []
        while len(running) < n_running:
            req = sched.pop_admission(now)
            if req is None:
                break
            got = alloc.alloc_seq(req.prompt_len + req.max_new,
                                  req.prefix_id if req.prefix_id >= 0 else
                                  None, prefix_len=req.shared_prefix_len)
            if got is None:
                raise RuntimeError(f"out of KV pages admitting r{req.rid}")
            pages, _ = got
            prompt = [int(t) for t in rng.randint(1, cfg.vocab_size,
                                                  req.prompt_len)]
            running.append([req, pages, prompt, 0])
            admitted.append(req)
        if not running:
            now += 1.0
            continue
        # one decode step for every running sequence (prompt replay =
        # chunked prefill through the same paged step)
        B = len(running)
        tok = torch.tensor([r[2][r[3]] if r[3] < len(r[2]) else r[2][-1]
                            for r in running], dtype=torch.int32)
        pos = torch.tensor([r[3] for r in running], dtype=torch.int32)
        n_slots = max(len(r[1]) for r in running)
        pt = torch.tensor([r[1] + [r[1][-1]] * (n_slots - len(r[1]))
                           for r in running], dtype=torch.int32)
        logits, pools = decode(params, cfg, run, pools, tok.to(device),
                               pos.to(device), pt.to(device),
                               page_size=page_size)
        nxt = logits.argmax(-1).tolist()
        done = []
        for b, r in enumerate(running):
            r[3] += 1
            if r[3] >= len(r[2]):                  # generating
                r[2].append(int(nxt[b]))
            if r[3] >= r[0].prompt_len + r[0].max_new:
                done.append(r)
        finished = []
        for r in done:
            running.remove(r)
            alloc.free_seq(r[1])
            sched.on_finish(r[0])
            finished.append((r[0], r[2][r[0].prompt_len:]))
        n_done += len(done)
        yield {"step": step, "now": now, "batch": B, "admitted": admitted,
               "finished": finished}
        step += 1
        now += 1.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel) or cpu (its plain version)")
    args = ap.parse_args()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu for the plain "
                         "path")
    cfg = example_config()
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = lm.init(gen, cfg)
    n = 0
    for rec in serve(cfg, params, args.device, example_requests()):
        for req in rec["admitted"]:
            print(f"t={rec['now']:5.1f} admit r{req.rid} client{req.client}")
        for req, gen_toks in rec["finished"]:
            n += 1
            print(f"t={rec['now']:5.1f} done  r{req.rid} client{req.client} "
                  f"generated={gen_toks}")
    print(f"\nall {n} requests served")


if __name__ == "__main__":
    main()
