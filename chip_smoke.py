"""Run the PyTorch port on one NVIDIA GPU, end to end.

  python3 chip_smoke.py

Phases (any failure exits non-zero):

1. build   — nvcc builds every CUDA source of the port (one process each,
             all at once) from src/repro_torch/csrc.
2. kernels — each kernel against its plain PyTorch version on the card, at
             the main path's shape and at edge cases; the main path's shape
             is timed (CUDA events, median) beside its bound, the plain
             version and one PyTorch library call. K1 paged attention has
             two routes, by shape in kernels/paged_attention/ops.py: the
             split, bulk-copy kernel (csrc/paged_attention_sm90.cu) takes
             every shape here, the simt kernel (csrc/paged_attention.cu,
             one block per sequence and kv head) any other; both are held
             against the plain version at the serving shape, the kernel
             bench's shapes, GQA d=256 softcap bf16, GQA g=4 softcap bf16,
             lengths 0, 1 and on split boundaries, empty trailing splits,
             d=16 and a bad page id (NaN on its sequence only), the sm90
             route at several splits; three shapes the sm90 route refuses
             go through the wrapper to the simt kernel. K1 is timed as one
             call between two CUDA events (``ms``, host work included, the
             kernels line's measure) and as device time per call from
             CUDA-graph replays (``device_ms``), at the chosen split and
             (device time) at one split, beside the simt kernel and SDPA.
             K2 flash attention at the forward shape (B=2, H=20, S=4096,
             d=128, bf16, causal), the tests/test_kernels.py sweep
             in f32 and bf16, gemma2's widths, ragged tails (f32 and bf16),
             rows that see no key, and strided views. K2 has two routes:
             bf16 goes to the wgmma/TMA kernel
             (csrc/flash_attention_sm90.cu), f32 to the CUDA-core kernel
             (csrc/flash_attention.cu); the forward shape prints the bf16
             kernel's TFLOP/s and its registers, shared memory and spills,
             and times the CUDA-core kernel on f32 copies of the same
             inputs.
3. small   — the reduced models, kernel path on the card against the plain
             path on the CPU from the same weights: the serving example
             (same generated tokens) and a 2-layer Qwen forward with
             use_pallas (same logits and loss).
4. serve   — Qwen1.5-4B at full width and depth (random bf16 weights from
             a seed, float32 KV pools) served through the SMS scheduler and
             the paged allocator until at least 8 requests of both client
             kinds have finished. Every logit must be finite, K1 must have
             run once per layer per step, every call on the sm90 route,
             and one mid-run step is recomputed with the plain attention.
5. forward — the same weights, the pools freed: the full-sequence forward
             and loss (``get_model(cfg).train_loss`` with use_pallas, B=2,
             S=4096, bf16). The loss must be finite, K2 must have run once
             per layer per forward, every launch through the bf16 route,
             K2 at the first and last layer is held
             against the plain version, and the logits and loss against a
             forward with the plain attention.
6. kernel bench — ``benchmarks_torch/kernel_bench.py``'s main: K1, K2 and
             K3 at the reference bench's sweeps against their plain
             versions, timed beside their bounds; every K1 call on the sm90
             route. It is K3's main path: the xLSTM model keeps its own
             chunk scan, as the reference does.
7. xlstm   — xLSTM-125m at full width and depth (random float32 weights
             from a seed, bf16 compute): ``get_model(cfg).train_loss`` at
             B=8, S=2048 timed; the loss finite and near ln(vocab); K3 on
             layer 1's own q, k, v and gates against the layer's chunk
             scan; ``prefill`` of S-1 tokens and 8 greedy ``decode_step``s,
             the first held against the forward's last position.

The kernel phase also holds K3 (mLSTM scan) against its plain version: the
tests/test_kernels.py sweep in f32 (also against another chunk) and bf16,
the kernel bench's widths, strided views, and the xLSTM-125m layer shape
(B=8, H=4, S=2048, dh=384) at chunk 256 and 128, timed. The small phase
also runs a reduced 5-layer xLSTM on the card against the CPU.

It prints a JSON ``kernels`` line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``. TF32 is off throughout.
"""
import gc
import importlib.util
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np
import torch

from benchmarks_torch import kernel_bench
from benchmarks_torch.kernel_bench import device_ms as _device_ms
from benchmarks_torch.kernel_bench import time_ms as _time_ms
from repro_torch.configs.base import RunConfig, reduced
from repro_torch.configs.registry import get_config
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.mlstm_scan import ops as ml_ops
from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_ref
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.models import lm, xlstm
from repro_torch.models.common import rms_norm, softmax_xent
from repro_torch.models.registry import get_model
from repro_torch.roofline.analysis import (BF16_FLOPS_PER_S, F32_FLOPS_PER_S,
                                           bound_ms)
from repro_torch.serving import paged_lm
from repro_torch.serving.engine import generate_requests
from repro_torch.serving.types import default_clients

F32_TOL = dict(atol=2e-5, rtol=2e-4)     # tests/test_kernels.py
BF16_TOL = dict(atol=2e-3, rtol=2e-2)

SERVE_LAYERS_PER_STEP = 40       # Qwen1.5-4B depth
SERVE_PAGE, SERVE_PAGES, SERVE_SLOTS = 16, 2048, 32
SERVE_HORIZON_MS = 2000.0
SERVE_STEP_CAP = 1600            # the first interactive finish is near 1256
SERVE_CHECK_STEP = 300           # recomputed with the plain attention

FWD_B, FWD_S = 2, 4096           # S: the RunConfig.seq_len default
FWD_TIMED = 3                    # timed forwards, after one warm-up
FLASH_SWEEP = [                  # tests/test_kernels.py:21-28
    # B, Hq, Hkv, Sq, Sk, d, causal, window, softcap
    (2, 4, 2, 128, 128, 64, True, 0, 0.0),      # GQA
    (1, 8, 4, 256, 256, 32, True, 64, 0.0),     # sliding window
    (1, 2, 2, 128, 256, 64, False, 0, 50.0),    # softcap, cross length
    (2, 6, 1, 64, 128, 128, True, 0, 0.0),      # MQA
    (1, 4, 4, 192, 192, 16, True, 128, 30.0),   # window + softcap
]
MLSTM_SWEEP = [                  # tests/test_kernels.py:97-100
    # B, H, S, dh, chunk
    (2, 2, 64, 16, 16),
    (1, 4, 128, 32, 32),
    (1, 1, 96, 8, 96),           # single chunk
    (2, 1, 64, 16, 8),           # many small chunks
]
XLSTM_B, XLSTM_S = 8, 2048       # 16,384 scored tokens per call
XLSTM_TIMED = 3                  # timed forwards, after one warm-up
XLSTM_DECODE = 8                 # greedy decode steps after the prefill
XLSTM_CHUNK = 256                # models/xlstm.mlstm_chunk_scan's chunk


def _example():
    spec = importlib.util.spec_from_file_location(
        "serve_heterogeneous_torch",
        os.path.join(ROOT, "examples", "serve_heterogeneous_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_close(name, got, want, tol, *, rtol_of_max=False):
    """Elementwise ``|got - want| <= atol + rtol * |want|``; with
    ``rtol_of_max`` the rtol term is taken of ``max |want|`` instead."""
    err = (got.float() - want.float()).abs()
    ref = want.float().abs()
    bound = tol["atol"] + tol["rtol"] * (ref.max() if rtol_of_max else ref)
    worst = float(err.max()) if err.numel() else 0.0
    if not bool((err <= bound).all()):
        raise AssertionError(f"{name}: kernel and plain version disagree, "
                             f"max |err| {worst:.3e}")
    return worst


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device)


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _zero_counts():
    """Every kernel's launch count to 0, before a main path is driven."""
    for fn in (ops.paged_attention, fa_ops.flash_attention, ml_ops.mlstm_scan):
        fn.launches = 0
    ops.paged_attention.launches_sm90 = 0
    fa_ops.flash_attention.launches_sm90 = 0


def _paged_inputs(gen, B, Hq, Hkv, d, page, n_slots, P, lengths, dtype):
    dev = "cuda"
    q = torch.randn(B, Hq, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(P, Hkv, page, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(P, Hkv, page, d, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P, generator=gen, device=dev)
    pt = perm[: B * n_slots].reshape(B, n_slots).to(torch.int32)
    ln = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, pt.contiguous(), ln


def phase_build():
    t0 = time.perf_counter()
    took = _build.build()
    print(f"[build] {json.dumps({n: round(s, 2) for n, s in took.items()})} "
          f"total {time.perf_counter() - t0:.2f} s")
    for name in took:
        log = _build.build_log(name)
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", log)]
        smem = [int(w) for w in re.findall(r"(\d+) bytes smem", log)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill", log))
        print(f"[build] {name}: {len(regs)} kernels, registers <= "
              f"{max(regs, default=0)}, smem <= {max(smem, default=0)} B, "
              f"spill bytes {spills}")


def _paged_case(errs, name, x, tol, *, softcap=0.0, splits=(None,)):
    """K1 on x against its plain version: the sm90 route at each
    pages_per_split (None: ``_pages_per_split``'s choice), every call
    checked to have taken that route, and the simt kernel."""
    want = paged_attention_ref(*x, softcap=softcap)
    for pps in splits:
        before = ops.paged_attention.launches_sm90
        if pps is None:
            got = ops.paged_attention(*x, softcap=softcap)
            if ops.paged_attention.launches_sm90 != before + 1:
                raise AssertionError(f"paged_attention {name}: not the sm90 "
                                     f"route")
        else:
            got = ops._run_sm90(*x, softcap, pps)
        errs[f"{name} sm90 pps={pps or 'auto'}"] = _assert_close(
            f"paged_attention {name} sm90 pps={pps}", got, want, tol)
    errs[f"{name} simt"] = _assert_close(
        f"paged_attention {name} simt", ops._run_simt(*x, softcap), want, tol)


def _paged_times(x, n_bytes, n_flops, enable_gqa=True):
    """K1 timed two ways: ``ms`` keys are one call between two CUDA events
    (median of 50), the wrapper's host work included, the kernels line's
    measure; ``device_ms`` keys are device time per call from CUDA-graph
    replays of 20 calls. For the public wrapper (the sm90 route at
    ``_pages_per_split``'s choice), the sm90 route at one split (device
    only), the simt kernel behind the same input checks as the wrapper
    (``_check`` + ``_run_simt``) and SDPA over
    pre-gathered pages; beside the byte bound."""
    n_slots = x[3].shape[1]
    wrapper = lambda: ops.paged_attention(*x)
    simt = lambda: (ops._check(*x), ops._run_simt(*x, 0.0))
    lib = kernel_bench.paged_sdpa(x, enable_gqa)
    t = {"pages_per_split": ops._pages_per_split(
        x[0].shape[0], x[1].shape[1], n_slots, ops._sm_count(0)),
        "ms": _time_ms(wrapper, 50), "device_ms": _device_ms(wrapper),
        "device_ms_one_split": _device_ms(
            lambda: ops._run_sm90(*x, 0.0, n_slots)),
        "simt_ms": _time_ms(simt, 50), "simt_device_ms": _device_ms(simt),
        "library_ms": _time_ms(lib, 50), "library_device_ms": _device_ms(lib)}
    t["bound_ms"], t["bound_by"] = bound_ms(n_bytes, n_flops,
                                            F32_FLOPS_PER_S)
    for k in ("ms", "device_ms"):
        t[f"gb_s_{k}"] = n_bytes / t[k] / 1e6
        t[f"bound_share_{k}"] = t["bound_ms"] / t[k]
    return t


def _paged_refused(errs, gen):
    """Shapes ``_sm90_ok`` refuses, through the public wrapper: each must
    move ``launches`` and not ``launches_sm90`` (the simt kernel), and
    agree with the plain version."""
    xa = _paged_inputs(gen, 3, 4, 2, 6, 16, 4, 16, [0, 37, 64],
                       torch.float32)
    xb = _paged_inputs(gen, 2, 4, 2, 256, 64, 3, 8, [100, 192],
                       torch.float32)
    xc = list(_paged_inputs(gen, 3, 4, 2, 32, 16, 4, 16, [20, 64, 41],
                            torch.float32))
    for i in (1, 2):                 # base 4 bytes past an aligned address
        flat = torch.empty(xc[i].numel() + 1, device="cuda")
        xc[i] = flat[1:].view(xc[i].shape).copy_(xc[i])
    for name, x in (("f32 d=6, 24-byte rows", xa),
                    ("f32 d=256 page 64, 64 KiB pages", xb),
                    ("pools 4 bytes off 16-byte alignment", xc)):
        if ops._sm90_ok(x[1], x[2]):
            raise AssertionError(f"paged_attention (i) {name}: expected "
                                 f"the sm90 route to refuse it")
        n, n_sm90 = (ops.paged_attention.launches,
                     ops.paged_attention.launches_sm90)
        got = ops.paged_attention(*x)
        if (ops.paged_attention.launches, ops.paged_attention.launches_sm90) \
                != (n + 1, n_sm90):
            raise AssertionError(f"paged_attention (i) {name}: not the simt "
                                 f"route")
        errs[f"(i) simt route via the wrapper, {name}"] = _assert_close(
            f"paged_attention (i) {name}", got, paged_attention_ref(*x),
            F32_TOL)


def phase_kernels():
    """K1 against its plain version on both routes, timed; returns the
    serving-shape record."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    B, H, d, page, n_slots, P = 32, 20, 128, 16, 36, SERVE_PAGES
    lens = torch.randint(1, page * n_slots + 1, (B,), generator=gen,
                         device="cuda")
    x = _paged_inputs(gen, B, H, H, d, page, n_slots, P, lens, torch.float32)
    _paged_case(errs, "(a) serving shape f32", x, F32_TOL,
                splits=(None, 1, 4, 9))
    err_a = errs["(a) serving shape f32 sm90 pps=auto"]
    lens_b = torch.randint(1, 16 * 8 + 1, (6,), generator=gen, device="cuda")
    xb = _paged_inputs(gen, 6, 8, 4, 256, 16, 8, 64, lens_b, torch.bfloat16)
    _paged_case(errs, "(b) GQA d=256 softcap bf16", xb, BF16_TOL,
                softcap=50.0, splits=(None, 1, 3))
    # lengths 0, 1, an exact page multiple, ragged; ids -1 past the length
    xc = list(_paged_inputs(gen, 5, 6, 2, 80, 16, 4, 32,
                            [0, 1, 16, 48, 37], torch.float32))
    starts = torch.arange(4, device="cuda") * 16
    xc[3] = torch.where(starts[None, :] < xc[4][:, None], xc[3],
                        torch.full_like(xc[3], -1)).contiguous()
    for pps in (None, 1, 2, 3):
        got = (ops.paged_attention(*xc) if pps is None
               else ops._run_sm90(*xc, 0.0, pps))
        if bool(got[0].abs().max() != 0):
            raise AssertionError(f"paged_attention (c) pps={pps}: length 0 "
                                 f"must give 0")
    _paged_case(errs, "(c) edge lengths, g=3, d=80", xc, F32_TOL,
                splits=(None, 1, 2, 3))
    xd = _paged_inputs(gen, 4, 4, 2, 16, 8, 3, 16, [5, 8, 24, 13],
                       torch.float32)
    _paged_case(errs, "(d) d=16 (example width)", xd, F32_TOL,
                splits=(None, 1, 2))
    # runs of 2 pages (32 keys): lengths on split boundaries, and splits 3-5
    # of every sequence empty
    xe = _paged_inputs(gen, 4, 8, 2, 128, 16, 12, 64, [32, 64, 96, 17],
                       torch.float32)
    _paged_case(errs, "(e) split boundaries, empty trailing splits",
                xe, F32_TOL, splits=(2, 3, 4, 12))
    xf = _paged_inputs(gen, 3, 16, 4, 128, 16, 6, 64, [0, 48, 77],
                       torch.bfloat16)
    _paged_case(errs, "(f) GQA g=4 softcap bf16, length 0", xf,
                BF16_TOL, softcap=30.0, splits=(None, 1, 2, 3))
    bench = {}
    for shape in kernel_bench.PAGED_SHAPES:
        xk, keys, pages = kernel_bench.paged_inputs("cuda", *shape)
        name = "B{}H{}/{}d{}p{}".format(*shape[:5])
        _paged_case(errs, f"(g) kernel bench {name}", xk, F32_TOL,
                    splits=(None, 1, shape[5]))
        Bk, Hq, Hkv, dk = shape[:4]
        bench[name] = _paged_times(
            xk, 4 * 2 * keys * Hkv * dk + 4 * 2 * xk[0].numel()
            + 4 * (Bk + pages), 4 * keys * Hq * dk)
    # a page id outside [0, P) inside sequence 1's length: NaN there only;
    # an id of -3 past sequence 2's length is never read
    xh = list(_paged_inputs(gen, 3, 4, 2, 64, 16, 6, 32, [90, 70, 40],
                            torch.float32))
    want_h = paged_attention_ref(*xh)
    xh[3] = xh[3].clone()
    xh[3][1, 2], xh[3][2, 4] = 32 + 7, -3
    for pps in (None, 1, 2, 6, "simt"):
        got = (ops._run_simt(*xh, 0.0) if pps == "simt"
               else ops.paged_attention(*xh) if pps is None
               else ops._run_sm90(*xh, 0.0, pps))
        if not bool(torch.isnan(got[1]).all()):
            raise AssertionError(f"paged_attention (h) pps={pps}: a bad id "
                                 f"inside the length must give NaN")
        errs[f"(h) bad id, the other sequences, pps={pps or 'auto'}"] = \
            _assert_close(f"paged_attention (h) pps={pps}", got[[0, 2]],
                          want_h[[0, 2]], F32_TOL)
    _paged_refused(errs, gen)
    print("[kernels] paged_attention max|err| " + "; ".join(
        f"{n} {e:.3e}" for n, e in errs.items()))

    # timing at the serving shape
    S = n_slots * page
    keys = int(torch.clamp(x[4], max=S).sum())
    elt = x[0].element_size()
    n_bytes = (2 * keys * H * d * elt            # live K and V rows
               + 2 * x[0].numel() * elt          # q in, out
               + 4 * (B + int(((x[4] + page - 1) // page).sum())))
    t = _paged_times(x, n_bytes, 4 * keys * H * d, enable_gqa=False)
    plain_ms = _time_ms(lambda: paged_attention_ref(*x), 10)
    _assert_close("sdpa yardstick",
                  kernel_bench.paged_sdpa(x, False)()[:, :, 0],
                  paged_attention_ref(*x), dict(atol=1e-4, rtol=1e-3))
    plan = ops.sm90_plan(1, d, page, torch.float32)
    log = _build.build_log("paged_attention_sm90")
    regs = max(int(w) for w in re.findall(r"Used (\d+) registers", log))
    spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill", log))
    sm90_src = "src/repro_torch/csrc/paged_attention_sm90.cu"
    rec = {"name": "paged_attention", "route": "cuda", "source": sm90_src,
           "replaces": "src/repro/kernels/paged_attention/kernel.py:67",
           "launches": None, "max_abs_err": err_a, "ms": t["ms"],
           "plain_ms": plain_ms, "bound_ms": t["bound_ms"],
           "bound_by": t["bound_by"], "library_ms": t["library_ms"],
           "timing": "ms, library_ms: one call between two CUDA events, "
                     "host work included; *device_ms: device "
                     "time per call, CUDA-graph replays of 20 calls",
           "device_ms": t["device_ms"],
           "library_device_ms": t["library_device_ms"],
           "routes": {
               "sm90": {"launches": None, "ms": t["ms"],
                        "device_ms": t["device_ms"],
                        "device_ms_one_split": t["device_ms_one_split"],
                        "pages_per_split": t["pages_per_split"],
                        "source": sm90_src, **plan},
               "simt": {"launches": None, "ms": t["simt_ms"],
                        "device_ms": t["simt_device_ms"],
                        "source": "src/repro_torch/csrc/paged_attention.cu"}},
           "kernel_bench_shapes": bench}
    print(f"[kernels] paged_attention serving shape B={B} H={H} d={d} "
          f"page={page} slots={n_slots} keys={keys}, bound "
          f"{t['bound_ms']:.4f} ms; one eager call (host work included): "
          f"sm90 {t['ms']:.4f} ms ({t['gb_s_ms']:.1f} GB/s, "
          f"{t['bound_share_ms']:.3f} of the bound), simt kernel "
          f"{t['simt_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms, plain "
          f"{plain_ms:.4f} ms; device ms per call (graph replays): sm90 "
          f"{t['device_ms']:.4f} ms at {t['pages_per_split']} pages per "
          f"split ({t['gb_s_device_ms']:.1f} GB/s, "
          f"{t['bound_share_device_ms']:.3f} of the bound), "
          f"{t['device_ms_one_split']:.4f} ms at one split, simt kernel "
          f"{t['simt_device_ms']:.4f} ms, sdpa {t['library_device_ms']:.4f}"
          f" ms; sm90 kernel: {plan['stages']} stages, "
          f"{plan['smem_bytes']} B dynamic shared memory, registers <= "
          f"{regs} (all instances), spill bytes {spills}")
    if t["bound_share_ms"] < 0.5:
        print(f"[kernels] note: one eager call of the sm90 route reaches "
              f"{t['bound_share_ms']:.3f} of the bound at the serving shape, "
              f"under half")
    for name, b in bench.items():
        print(f"[kernels] paged_attention kernel bench {name}, bound "
              f"{b['bound_ms']:.4f} ms; one eager call: sm90 {b['ms']:.4f} "
              f"ms, simt kernel {b['simt_ms']:.4f} ms, sdpa "
              f"{b['library_ms']:.4f} ms; device ms per call: sm90 "
              f"{b['device_ms']:.4f} ms at {b['pages_per_split']} pages per "
              f"split ({b['gb_s_device_ms']:.1f} GB/s, "
              f"{b['bound_share_device_ms']:.3f} of the bound), "
              f"{b['device_ms_one_split']:.4f} ms at one split, simt kernel "
              f"{b['simt_device_ms']:.4f} ms, sdpa "
              f"{b['library_device_ms']:.4f} ms")
        for k in ("ms", "device_ms"):
            if not b[k] < min(b[f"simt_{k}"], b[f"library_{k}"]):
                print(f"[kernels] note: at {name} the sm90 route is not the "
                      f"fastest of the three by {k}")
    return rec


def _flash_inputs(gen, B, Hq, Hkv, Sq, Sk, d, dtype):
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    return rnd(B, Hq, Sq, d), rnd(B, Hkv, Sk, d), rnd(B, Hkv, Sk, d)


def phase_flash_kernels():
    """K2 against its plain version; returns the forward-shape record."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {}

    def check(name, x, tol, **kw):
        errs[name] = _assert_close(f"flash_attention {name}",
                                   fa_ops.flash_attention(*x, **kw),
                                   attention_ref(*x, **kw), tol)

    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for B, Hq, Hkv, Sq, Sk, d, causal, window, cap in FLASH_SWEEP:
            x = _flash_inputs(gen, B, Hq, Hkv, Sq, Sk, d, dtype)
            check(f"(b) {str(dtype)[6:]} B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} "
                  f"Sk={Sk} d={d} causal={causal} window={window} "
                  f"softcap={cap}", x, tol, causal=causal, window=window,
                  softcap=cap)
    check("(c) gemma2 widths d=256 GQA softcap 50 bf16",
          _flash_inputs(gen, 2, 8, 4, 512, 512, 256, torch.bfloat16),
          BF16_TOL, softcap=50.0)
    # tails that are no multiple of a tile, and the model's strided views
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        name = str(dtype)[6:]
        check(f"(d) ragged Sq=Sk=200 window 70 d=80 {name}",
              _flash_inputs(gen, 1, 4, 2, 200, 200, 80, dtype), tol,
              window=70)
        check(f"(d) ragged non-causal Sq=72 Sk=136 d=48 {name}",
              _flash_inputs(gen, 2, 2, 1, 72, 136, 48, dtype), tol,
              causal=False)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in
             _flash_inputs(gen, 2, 6, 3, 192, 192, 64, torch.bfloat16)]
    check("(d) strided (B,S,H,d) views bf16", views, BF16_TOL)
    errs["(e) rows that see no key, causal Sq=256 Sk=64 window 32 bf16"] = \
        _check_no_key_rows(gen, 256, 64, 32)
    print("[kernels] flash_attention max|err| " + "; ".join(
        f"{n} {e:.3e}" for n, e in errs.items()))

    # (a) the forward's shape: Qwen1.5-4B attention at S=4096
    B, H, S, d = FWD_B, 20, FWD_S, 128
    x = _flash_inputs(gen, B, H, H, S, S, d, torch.bfloat16)
    want = attention_ref(*x)
    err_a = _assert_close("flash_attention (a) forward shape bf16",
                          fa_ops.flash_attention(*x), want, BF16_TOL)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # SDPA's bf16 path rounds the probabilities to bf16 before P.V, so it
    # sits further from the float32 plain version than K2 does
    _assert_close("sdpa yardstick", sdpa(*x, is_causal=True), want,
                  dict(atol=3e-2, rtol=5e-2))
    del want
    ms = _time_ms(lambda: fa_ops.flash_attention(*x), 20)
    plain_ms = _time_ms(lambda: attention_ref(*x), 5)
    library_ms = _time_ms(lambda: sdpa(*x, is_causal=True), 20)
    # the f32 route: the CUDA-core kernel on f32 copies
    xf = [t.float() for t in x]
    simt_f32_ms = _time_ms(lambda: fa_ops.flash_attention(*xf), 5)
    del xf
    elt = x[0].element_size()
    n_bytes = 4 * B * H * S * d * elt             # q, k, v in; out
    n_flops = 4 * B * H * d * S * (S + 1) // 2    # q.k and p.v, causal pairs
    bound, by = bound_ms(n_bytes, n_flops, BF16_FLOPS_PER_S)
    cfg = fa_ops.sm90_config(d)
    # the kernel's own work: whole 128 x 128 tiles up to the diagonal, and
    # P.V twice (P_hi and P_lo)
    n_qt = S // cfg["block_q"]
    tiles = B * H * sum((min((qt + 1) * cfg["block_q"], S) + cfg["block_k"]
                         - 1) // cfg["block_k"] for qt in range(n_qt))
    kernel_flops = tiles * cfg["block_q"] * cfg["block_k"] * d * 2 * 3
    log = _build.build_log("flash_attention_sm90")
    regs = max(int(w) for w in re.findall(r"Used (\d+) registers", log))
    spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill", log))
    rec = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:75",
           "launches": None, "max_abs_err": err_a, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
           "library_ms": library_ms,
           "bound_f32_ms": n_flops / F32_FLOPS_PER_S * 1e3,
           "routes": {
               "sm90": {"dtype": "bfloat16", "launches": None, "ms": ms,
                        "source": "src/repro_torch/csrc/"
                                  "flash_attention_sm90.cu"},
               "simt": {"dtype": "float32", "launches": None,
                        "ms": simt_f32_ms,
                        "source": "src/repro_torch/csrc/flash_attention.cu"}}}
    print(f"[kernels] flash_attention forward shape B={B} H={H} S={S} d={d} "
          f"bf16 causal: {ms:.4f} ms ({n_flops / ms / 1e9:.1f} TFLOP/s of "
          f"the function's {n_flops / 1e9:.1f} GFLOP, "
          f"{kernel_flops / ms / 1e9:.1f} TFLOP/s executed by the kernel: "
          f"{kernel_flops / 1e9:.1f} GFLOP with whole diagonal tiles and the "
          f"split P.V), bound {rec['bound_ms']:.4f} ms at the "
          f"bf16 tensor-core peak, {rec['bound_f32_ms']:.4f} ms at the f32 "
          f"rate; plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms; the "
          f"f32 route (CUDA-core kernel) {simt_f32_ms:.4f} ms on f32 copies; "
          f"max|err| {err_a:.3e}; sm90 kernel: {cfg['block_q']} q rows x "
          f"{cfg['block_k']} keys per tile, 384 threads, registers <= "
          f"{regs} (launch), {cfg['smem_bytes']} B dynamic shared memory, "
          f"spill bytes {spills}")
    return rec


def _check_no_key_rows(gen, Sq, Sk, window):
    """Causal with a window, Sk < Sq: rows q >= Sk + window - 1 see no key.
    Rows that see one are held against the plain version; the others
    against the kernel's convention, the mean of v over the keys of the
    tiles their 128-row q tile visited (or 0 when it visited none)."""
    d = 64
    x = _flash_inputs(gen, 1, 2, 2, Sq, Sk, d, torch.bfloat16)
    got = fa_ops.flash_attention(*x, window=window)
    want = attention_ref(*x, window=window).float()
    cfg = fa_ops.sm90_config(d)
    bq, bk = cfg["block_q"], cfg["block_k"]
    v = x[2].float()
    blind = 0
    for qp in range(Sq):
        if max(0, qp - window + 1) <= min(qp, Sk - 1):
            continue                      # the row sees a key
        blind += 1
        q0 = qp // bq * bq
        k_end = min(Sk, q0 + bq, Sq)
        k_first = max(0, q0 - window + 1) // bk * bk
        n_tiles = max(0, -(-(k_end - k_first) // bk))
        keys = v[:, :, k_first:min(Sk, k_first + n_tiles * bk)]
        want[:, :, qp] = keys.mean(2) if keys.shape[2] else 0.0
    if not blind:
        raise AssertionError("no-key check: every row sees a key")
    return _assert_close(f"flash_attention (e) {blind} of {Sq} rows see no "
                         f"key", got, want.bfloat16(), BF16_TOL)


def _scan_f64(q, k, v, lf, li, chunk):
    """The plain mLSTM scan in float64, as the yardstick of f32 rounding."""
    B, H, _, dh = q.shape
    f64 = dict(dtype=torch.float64, device=q.device)
    h, _ = xlstm.mlstm_chunk_scan(
        q.double(), k.double(), v.double(), lf.double(), li.double(),
        (torch.zeros((B, H, dh, dh), **f64), torch.zeros((B, H, dh), **f64),
         torch.full((B, H), xlstm.MMIN, **f64)), chunk=chunk)
    return h


def _scan_close(name, x, chunk, got, want):
    """K3 against its plain version at the f32 tolerance, elementwise.

    Where that fails, both are held against the same scan in float64: when
    the f32 plain version is itself at least half the elementwise bound away
    from it, the bound is below the rounding of float32 sums over dh and the
    chunk, and the rtol is taken of max |h| instead (the reason is printed);
    otherwise the failure stands. Returns (max |err|, the form used)."""
    try:
        return _assert_close(name, got, want, F32_TOL), "elementwise"
    except AssertionError as e:
        exact = _scan_f64(*x, chunk)
        plain, kern = (kernel_bench.compare(t, exact)[1] for t in (want, got))
        del exact
        if plain < 0.5:
            raise
        form = (f"rtol of max |h|: against the float64 scan the f32 plain "
                f"version is {plain:.3f}x the elementwise bound, the kernel "
                f"{kern:.3f}x")
        print(f"[kernels] {e}; {form}")
        return _assert_close(name, got, want, F32_TOL, rtol_of_max=True), form


def phase_mlstm_kernels():
    """K3 against its plain version; returns the xLSTM-125m layer-shape
    record."""
    rng = np.random.RandomState(3)
    errs = {}

    def check(name, x, chunk, tol, plain_chunk=None):
        got = ml_ops.mlstm_scan(*x, chunk=chunk)
        want = mlstm_scan_ref(*x, chunk=plain_chunk or chunk)
        if tol is F32_TOL:
            errs[name] = _scan_close(f"mlstm_scan {name}", x, chunk, got,
                                     want)[0]
        else:
            errs[name] = _assert_close(f"mlstm_scan {name}", got, want, tol)

    for B, H, S, dh, chunk in MLSTM_SWEEP:
        x = kernel_bench.mlstm_inputs(rng, B, H, S, dh, "cuda")
        name = f"B={B} H={H} S={S} dh={dh} chunk={chunk}"
        check(f"(b) f32 {name}", x, chunk, F32_TOL)
        # as tests/test_kernels.py: the plain version at another chunk
        check(f"(b) f32 {name} vs plain chunk 8", x, chunk, F32_TOL, 8)
        bf = [t.bfloat16() for t in x[:3]] + list(x[3:])
        check(f"(c) bf16 {name}", bf, chunk, BF16_TOL)
    # tests/test_kernels.py:118-131's property inputs and tolerance
    x = kernel_bench.mlstm_inputs(rng, 1, 2, 48, 8, "cuda", (0.3, 0.999), 1.0)
    check("(b) f32 property B=1 H=2 S=48 dh=8 chunk=16 vs plain chunk 48", x,
          16, dict(atol=5e-5, rtol=5e-4), 48)
    for B, H, S, dh, chunk in kernel_bench.MLSTM_SHAPES:
        check(f"(d) f32 kernel-bench widths B={B} H={H} S={S} dh={dh} "
              f"chunk={chunk}",
              kernel_bench.mlstm_inputs(rng, B, H, S, dh, "cuda"), chunk,
              F32_TOL)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in
             kernel_bench.mlstm_inputs(rng, 2, 3, 128, 48, "cuda")]
    check("(d) strided (B,S,H,dh) views f32 chunk=32", views, 32, F32_TOL)
    print("[kernels] mlstm_scan max|err| " + "; ".join(
        f"{n} {e:.3e}" for n, e in errs.items()))

    # (a) the xLSTM-125m mLSTM layer's shape, at the model's chunk (256) and
    # the kernel's default (128)
    B, H, S, dh = XLSTM_B, 4, XLSTM_S, 384
    x = kernel_bench.mlstm_inputs(rng, B, H, S, dh, "cuda")
    rec = {"name": "mlstm_scan", "route": "cuda",
           "source": "src/repro_torch/csrc/mlstm_scan.cu",
           "replaces": "src/repro/kernels/mlstm_scan/kernel.py:74",
           "launches": None, "library_ms": None}
    for chunk in (XLSTM_CHUNK, 128):
        err, form = _scan_close(
            f"mlstm_scan (a) layer shape chunk={chunk} f32", x, chunk,
            ml_ops.mlstm_scan(*x, chunk=chunk),
            mlstm_scan_ref(*x, chunk=chunk))
        ms = _time_ms(lambda: ml_ops.mlstm_scan(*x, chunk=chunk), 10)
        plain_ms = _time_ms(lambda: mlstm_scan_ref(*x, chunk=chunk), 5)
        full, needed = kernel_bench.mlstm_flops(B, H, S, dh, chunk)
        bound, by = bound_ms(kernel_bench.mlstm_bytes(B, H, S, dh), needed,
                             F32_FLOPS_PER_S)
        sfx = "" if chunk == XLSTM_CHUNK else f"_chunk{chunk}"
        rec.update({f"max_abs_err{sfx}": err, f"check{sfx}": form,
                    f"ms{sfx}": ms,
                    f"plain_ms{sfx}": plain_ms, f"bound_ms{sfx}": bound,
                    f"bound_by{sfx}": by})
        print(f"[kernels] mlstm_scan layer shape B={B} H={H} S={S} dh={dh} "
              f"chunk={chunk} f32: {ms:.4f} ms ({needed / ms / 1e9:.1f} "
              f"TFLOP/s of {needed / 1e9:.2f} GFLOP needed; {full / 1e9:.2f} "
              f"GFLOP with the full L x L), bound {bound:.4f} ms ({by}, f32 "
              f"rate); plain {plain_ms:.4f} ms; max|err| {err:.3e} ({form})")
    return rec


def phase_small_input():
    """The example's reduced model: kernel path on the card against the
    plain path on the CPU, from the same weights; same generated tokens."""
    ex = _example()
    cfg = ex.example_config()
    params = lm.init(torch.Generator().manual_seed(0), cfg)
    toks = {}
    for dev in ("cpu", "cuda"):
        out = {}
        for rec in ex.serve(cfg, _tree_to(params, dev), dev,
                            ex.example_requests()):
            out.update({r.rid: g for r, g in rec["finished"]})
        toks[dev] = out
    if toks["cpu"] != toks["cuda"] or len(toks["cuda"]) != 7:
        raise AssertionError(f"small input: card {toks['cuda']} != "
                             f"cpu {toks['cpu']}")
    print(f"[serve] small input: 7 requests, card tokens == cpu tokens")


def phase_small_forward():
    """Reduced Qwen (2 layers, head_dim 32), f32: the forward and loss with
    use_pallas on the card (K2's f32 route) against the same on the CPU
    (plain)."""
    cfg = reduced(get_config("qwen1.5-4b"), n_layers=2, head_dim=32)
    run = RunConfig(compute_dtype="float32", use_pallas=True)
    params = lm.init(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 129),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    before = fa_ops.flash_attention.launches
    before_sm90 = fa_ops.flash_attention.launches_sm90
    with torch.no_grad():
        for dev in ("cpu", "cuda"):
            p, b = _tree_to(params, dev), _tree_to(batch, dev)
            logits, _ = lm.forward_train(p, cfg, run, b)
            loss = get_model(cfg).train_loss(p, run, b)
            out[dev] = (logits.cpu(), loss.cpu())
    if fa_ops.flash_attention.launches - before != 2 * cfg.n_layers:
        raise AssertionError("small forward: K2 did not run on the card")
    if fa_ops.flash_attention.launches_sm90 != before_sm90:
        raise AssertionError("small forward: f32 took the bf16 route")
    err = _assert_close("small forward logits, card vs cpu", out["cuda"][0],
                        out["cpu"][0], F32_TOL)
    err_l = _assert_close("small forward loss, card vs cpu", out["cuda"][1],
                          out["cpu"][1], F32_TOL)
    print(f"[forward] small input: reduced qwen B=2 S=128 f32, logits "
          f"max|err| {err:.3e}, loss {float(out['cuda'][1]):.6f} (cpu "
          f"{float(out['cpu'][1]):.6f}, |err| {err_l:.3e})")


def phase_small_xlstm():
    """Reduced xLSTM (5 layers: sLSTM at 0 and 4), f32: the forward and loss,
    and prefill plus 4 greedy decode steps, on the card against the CPU."""
    cfg = reduced(get_config("xlstm-125m"), n_layers=5)
    bundle = get_model(cfg)
    run = RunConfig(compute_dtype="float32")
    params = bundle.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 97),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    with torch.no_grad():
        for dev in ("cpu", "cuda"):
            p, b = _tree_to(params, dev), _tree_to(batch, dev)
            logits, _ = xlstm.forward_train(p, cfg, run, b)
            loss = bundle.train_loss(p, run, b)
            lg, cache, lens = bundle.prefill(p, run, None, b["tokens"])
            gen = [lg.argmax(-1)]
            for _ in range(4):
                lg, cache = bundle.decode_step(p, run, cache, gen[-1], lens)
                lens = lens + 1
                gen.append(lg.argmax(-1))
            out[dev] = (logits.cpu(), loss.cpu(), torch.stack(gen, 1).cpu())
    err = _assert_close("small xlstm logits, card vs cpu", out["cuda"][0],
                        out["cpu"][0], F32_TOL)
    err_l = _assert_close("small xlstm loss, card vs cpu", out["cuda"][1],
                          out["cpu"][1], F32_TOL)
    if not torch.equal(out["cuda"][2], out["cpu"][2]):
        raise AssertionError(f"small xlstm: card tokens {out['cuda'][2]} != "
                             f"cpu tokens {out['cpu'][2]}")
    print(f"[xlstm] small input: reduced xlstm 5 layers B=2 S=96 f32, logits "
          f"max|err| {err:.3e}, loss {float(out['cuda'][1]):.6f} (|err| "
          f"{err_l:.3e}); prefill + 4 decode steps: card tokens == cpu "
          f"tokens {out['cpu'][2].tolist()}")


def phase_serve():
    ex = _example()
    cfg = get_config("qwen1.5-4b")
    assert cfg.n_layers == SERVE_LAYERS_PER_STEP
    run = RunConfig(compute_dtype="bfloat16")
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                     dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {n_params / 1e9:.3f} B params (bf16), init "
          f"{time.perf_counter() - t0:.1f} s")
    requests = generate_requests(default_clients(), SERVE_HORIZON_MS, seed=0)
    kind = {r.rid: default_clients()[r.client].kind for r in requests}
    calls = {"n": 0, "plain_err": None, "attn_err": 0.0, "argmax": None}

    def checked_attention(*args, softcap):
        """The served kernel call, held at each layer against the plain
        version on the same inputs (float32 pools: the f32 tolerance)."""
        out = ops.paged_attention(*args, softcap=softcap)
        err = _assert_close("serve step attention vs plain", out,
                            paged_attention_ref(*args, softcap=softcap),
                            F32_TOL)
        calls["attn_err"] = max(calls["attn_err"], err)
        return out

    def decode(params, cfg, run, pools, tok, pos, pt, *, page_size):
        if calls["n"] != SERVE_CHECK_STEP:
            logits, pools = paged_lm.paged_decode_step(
                params, cfg, run, pools, tok, pos, pt, page_size=page_size)
        else:
            # The plain step writes the same pool slots the kernel step
            # then rewrites, so the pools end as the kernel step alone
            # leaves them.
            plain, _ = paged_lm.paged_decode_step(
                params, cfg, run, pools, tok, pos, pt, page_size=page_size,
                attention=paged_attention_ref)
            logits, pools = paged_lm.paged_decode_step(
                params, cfg, run, pools, tok, pos, pt, page_size=page_size,
                attention=checked_attention)
            # 40 bf16 layers: rounding flips of the attention output move
            # the bf16 residual stream by its ulp, so near-zero logits
            # differ by more than an elementwise rtol allows; the rtol is
            # taken of the logits' largest magnitude.
            calls["plain_err"] = _assert_close(
                "serve step logits vs plain attention", logits, plain,
                BF16_TOL, rtol_of_max=True)
            calls["argmax"] = float((logits.argmax(-1) == plain.argmax(-1))
                                    .float().mean())
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"non-finite logits at step {calls['n']}")
        calls["n"] += 1
        return logits, pools

    torch.cuda.reset_peak_memory_stats()
    finished, step_s, tokens = [], [], 0
    _zero_counts()
    t_prev = time.perf_counter()
    stream = ex.serve(cfg, params, "cuda", requests, SERVE_SLOTS, run=run,
                      page_size=SERVE_PAGE, n_pages=SERVE_PAGES, decode=decode)
    for rec in stream:
        t_now = time.perf_counter()
        if rec["step"] not in (0, SERVE_CHECK_STEP):   # warm-up, check step
            step_s.append(t_now - t_prev)
            tokens += rec["batch"]
        t_prev = t_now
        finished += [kind[r.rid] for r, _ in rec["finished"]]
        if len(finished) >= 8 and "bulk" in finished \
                and "interactive" in finished:
            break
        if rec["step"] + 1 >= SERVE_STEP_CAP:
            raise AssertionError(f"step cap {SERVE_STEP_CAP}: finished "
                                 f"{finished}")
    launches = ops.paged_attention.launches
    launches_sm90 = ops.paged_attention.launches_sm90
    stream.close()                     # frees the KV pools
    if fa_ops.flash_attention.launches:
        raise AssertionError("serving decode launched flash_attention")
    steps = rec["step"] + 1
    if launches != SERVE_LAYERS_PER_STEP * steps:
        raise AssertionError(f"paged_attention launches {launches} != "
                             f"{SERVE_LAYERS_PER_STEP} x {steps} steps")
    if launches_sm90 != launches:
        raise AssertionError(f"serve: {launches - launches_sm90} of "
                             f"{launches} paged_attention calls did not "
                             f"take the sm90 route")
    if calls["plain_err"] is None:
        raise AssertionError("the plain-attention check step never ran")
    total = sum(step_s)
    print(f"[serve] steps {steps}, finished {len(finished)} "
          f"({finished.count('bulk')} bulk, "
          f"{finished.count('interactive')} interactive), decode "
          f"{tokens / total:.1f} tok/s, mean step {1e3 * total / len(step_s):.3f}"
          f" ms, median step {1e3 * statistics.median(step_s):.3f} ms, "
          f"paged_attention launches {launches} (sm90 route "
          f"{launches_sm90}); step {SERVE_CHECK_STEP}: "
          f"attention vs plain max|err| {calls['attn_err']:.3e} (40 layers),"
          f" logits vs plain-attention step max|err| "
          f"{calls['plain_err']:.3e}, argmax agreement {calls['argmax']:.3f};"
          f" peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return launches, launches_sm90, params


def phase_forward(params, flash_ms):
    """Full-width, full-depth Qwen1.5-4B: the full-sequence forward and loss
    through ``get_model(cfg).train_loss`` with K2; returns K2's launches,
    all of them and those of the bf16 route."""
    cfg = get_config("qwen1.5-4b")
    bundle = get_model(cfg)
    run = RunConfig(compute_dtype="bfloat16", use_pallas=True)
    assert run.seq_len == FWD_S
    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (FWD_B, FWD_S + 1), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    checked = {"layer": 0, "err": []}

    def checked_flash(q, k, v, **kw):
        """K2 as the forward calls it, held at the first and the last layer
        against the plain version on the same inputs."""
        out = fa_ops.flash_attention(q, k, v, **kw)
        if checked["layer"] in (0, cfg.n_layers - 1):
            checked["err"].append(_assert_close(
                f"forward layer {checked['layer']} attention vs plain", out,
                attention_ref(q, k, v, **kw), BF16_TOL))
        checked["layer"] += 1
        return out

    _zero_counts()
    wall, n_fwd = [], 0
    with torch.no_grad():
        for i in range(1 + FWD_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = bundle.train_loss(params, run, batch)
            torch.cuda.synchronize()
            if i:
                wall.append(time.perf_counter() - t0)
            n_fwd += 1
            if not bool(torch.isfinite(loss)):
                raise AssertionError(f"forward {i}: loss {float(loss)}")
        logits, _ = lm.forward_train(params, cfg, run, batch,
                                     flash=checked_flash)
        n_fwd += 1
        launches = fa_ops.flash_attention.launches
        launches_sm90 = fa_ops.flash_attention.launches_sm90
        if ops.paged_attention.launches:
            raise AssertionError("the forward launched paged_attention")
        peak = torch.cuda.max_memory_allocated()
        loss_k = softmax_xent(logits, batch["labels"])
        plain, _ = lm.forward_train(params, cfg,
                                    run.replace(use_pallas=False), batch)
        loss_p = softmax_xent(plain, batch["labels"])
        # 40 bf16 layers: as in the serve check, the rtol is taken of the
        # logits' largest magnitude
        err_logits = _assert_close("forward logits vs plain attention",
                                   logits, plain, BF16_TOL, rtol_of_max=True)
        del logits, plain
        err_loss = _assert_close("forward loss vs plain attention", loss_k,
                                 loss_p, BF16_TOL)
    if launches != cfg.n_layers * n_fwd or launches_sm90 != launches:
        raise AssertionError(f"flash_attention launches {launches} (bf16 "
                             f"route {launches_sm90}) != {cfg.n_layers} x "
                             f"{n_fwd} forwards, all on the bf16 route")
    if len(checked["err"]) != 2:
        raise AssertionError("the layer checks of the forward never ran")
    fwd_ms = 1e3 * statistics.median(wall)
    print(f"[forward] {cfg.name} B={FWD_B} S={FWD_S} bf16 use_pallas: "
          f"{n_fwd} forwards, flash_attention launches {launches} (bf16 "
          f"wgmma route {launches_sm90}); loss "
          f"{float(loss):.6f} (plain attention {float(loss_p):.6f}, |err| "
          f"{err_loss:.3e}); logits vs plain attention max|err| "
          f"{err_logits:.3e}; K2 vs plain at layers 0 and "
          f"{cfg.n_layers - 1} max|err| {max(checked['err']):.3e}; "
          f"median forward+loss {fwd_ms:.3f} ms "
          f"({', '.join(f'{1e3 * t:.3f}' for t in wall)}), "
          f"{FWD_B * FWD_S / (fwd_ms / 1e3):.1f} scored tokens/s, K2 share "
          f"{cfg.n_layers * flash_ms / fwd_ms:.3f} ({cfg.n_layers} x "
          f"{flash_ms:.4f} ms); peak memory {peak / 2**30:.1f} GiB")
    return launches, launches_sm90


def phase_kernel_bench():
    """benchmarks_torch/kernel_bench.py's main, K3's main path and K2's f32
    route's; returns the launches of each kernel in it."""
    counters = (ops.paged_attention, fa_ops.flash_attention,
                ml_ops.mlstm_scan)
    _zero_counts()
    t0 = time.perf_counter()
    kernel_bench.main([])
    launches = {fn.__name__: fn.launches for fn in counters}
    if not all(launches.values()):
        raise AssertionError(f"kernel bench: a kernel never ran {launches}")
    n_sm90 = fa_ops.flash_attention.launches_sm90
    if n_sm90:
        raise AssertionError(f"kernel bench: {n_sm90} f32 flash_attention "
                             f"calls took the bf16 route")
    launches["paged_attention_sm90"] = ops.paged_attention.launches_sm90
    if launches["paged_attention_sm90"] != launches["paged_attention"]:
        raise AssertionError(f"kernel bench: paged_attention calls off the "
                             f"sm90 route {launches}")
    print(f"[kernel_bench] launches {json.dumps(launches)}, "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


def phase_xlstm():
    """Full-width, full-depth xLSTM-125m: forward and loss, prefill and
    greedy decode through ``get_model(cfg)``; K3 on layer 1's own inputs.
    Returns K3's launches on the model path (the model keeps its own chunk
    scan, as the reference does, so 0)."""
    cfg = get_config("xlstm-125m")
    bundle = get_model(cfg)
    run = RunConfig(compute_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = bundle.init(gen)        # float32 weights, the reference's default
    n_params = sum(t.numel() for t in _leaves(params))
    toks = torch.randint(0, cfg.vocab_size, (XLSTM_B, XLSTM_S + 1),
                         generator=gen, device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    wall = []
    with torch.no_grad():
        for i in range(1 + XLSTM_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = bundle.train_loss(params, run, batch)
            torch.cuda.synchronize()
            if i:
                wall.append(time.perf_counter() - t0)
            if not bool(torch.isfinite(loss)):
                raise AssertionError(f"xlstm forward {i}: loss {float(loss)}")
        peak = torch.cuda.max_memory_allocated()
        if abs(float(loss) - math.log(cfg.vocab_size)) > 1.0:
            raise AssertionError(f"xlstm loss {float(loss)} is not near "
                                 f"ln V = {math.log(cfg.vocab_size):.3f}")
        prompt = batch["tokens"][:, :-1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache, lens = bundle.prefill(params, run, None, prompt)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        gen_toks, step_ms, first = [lg.argmax(-1)], [], None
        for _ in range(XLSTM_DECODE):
            t0 = time.perf_counter()
            lg, cache = bundle.decode_step(params, run, cache, gen_toks[-1],
                                           lens)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            if not bool(torch.isfinite(lg).all()):
                raise AssertionError("xlstm decode: non-finite logits")
            first = lg if first is None else first
            lens = lens + 1
            gen_toks.append(lg.argmax(-1))
        model_launches = {fn.__name__: fn.launches for fn in
                          (ops.paged_attention, fa_ops.flash_attention,
                           ml_ops.mlstm_scan)}
        if any(model_launches.values()):
            raise AssertionError(f"the xlstm path launched {model_launches}")
        # the forward over the prompt and the first greedy token: its last
        # position is what the first decode step computed. bf16 through 12
        # layers, the chunk scan against the decode cell: the rtol is taken
        # of the logits' largest magnitude, as in the Qwen checks.
        seq = torch.cat([prompt, gen_toks[0][:, None]], dim=1)
        full, _ = xlstm.forward_train(params, cfg, run, {"tokens": seq})
        err_dec = _assert_close("xlstm first decode vs the forward", first,
                                full[:, -1], BF16_TOL, rtol_of_max=True)
        del full
        # K3 on the q, k, v and gates that layer 1 (the first mLSTM block)
        # computes, against the layer's own chunk scan (chunk 256)
        p1 = params["blocks"][1]
        x1, _ = xlstm.slstm_block(params["blocks"][0], cfg,
                                  xlstm._embed(params, run, batch["tokens"]))
        q, k, v, lf, li, _, _ = xlstm._mlstm_qkvg(
            p1, cfg, rms_norm(x1, p1["ln"], cfg.norm_eps))
        q, k, v = q.float(), k.float(), v.float()
        B, H, S, dh = q.shape
        f32 = dict(dtype=torch.float32, device="cuda")
        want, _ = xlstm.mlstm_chunk_scan(
            q, k, v, lf, li, (torch.zeros((B, H, dh, dh), **f32),
                              torch.zeros((B, H, dh), **f32),
                              torch.full((B, H), xlstm.MMIN, **f32)))
        err_layer, form = _scan_close(
            "xlstm layer 1 K3 vs its chunk scan", (q, k, v, lf, li),
            XLSTM_CHUNK, ml_ops.mlstm_scan(q, k, v, lf, li,
                                           chunk=XLSTM_CHUNK), want)
    fwd_ms = 1e3 * statistics.median(wall)
    ntok = XLSTM_B * XLSTM_S
    print(f"[xlstm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e6:.1f} M params (float32), bf16 compute, "
          f"B={XLSTM_B} "
          f"S={XLSTM_S}: loss {float(loss):.6f} (ln V "
          f"{math.log(cfg.vocab_size):.6f}); median forward+loss "
          f"{fwd_ms:.3f} ms ({', '.join(f'{1e3 * t:.3f}' for t in wall)}), "
          f"{ntok / (fwd_ms / 1e3):.1f} scored tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB; prefill {XLSTM_S - 1} tokens "
          f"{prefill_ms:.1f} ms; {XLSTM_DECODE} greedy decode steps, median "
          f"{statistics.median(step_ms):.3f} ms; first decode vs forward "
          f"max|err| {err_dec:.3e}; kernel launches on the model path "
          f"{json.dumps(model_launches)}; K3 at layer 1 (chunk "
          f"{XLSTM_CHUNK}) vs the layer's chunk scan max|err| "
          f"{err_layer:.3e} ({form})")
    return model_launches["mlstm_scan"]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    rec_pa = phase_kernels()
    rec_fa = phase_flash_kernels()
    rec_ml = phase_mlstm_kernels()
    phase_small_input()
    phase_small_forward()
    phase_small_xlstm()
    rec_pa["launches"], n_sm90, params = phase_serve()
    rec_pa["routes"]["sm90"]["launches"] = n_sm90
    rec_pa["routes"]["simt"]["launches"] = rec_pa["launches"] - n_sm90
    rec_fa["launches"], rec_fa["routes"]["sm90"]["launches"] = \
        phase_forward(params, rec_fa["ms"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    bench = phase_kernel_bench()
    # K3's main path is the kernel bench; the model path runs it 0 times
    rec_ml["launches"] = bench["mlstm_scan"]
    # K2's f32 route runs on the kernel bench (all its flash calls are f32)
    rec_fa["routes"]["simt"]["launches"] = bench["flash_attention"]
    rec_ml["model_path_launches"] = phase_xlstm()
    for rec in (rec_pa, rec_fa, rec_ml):
        rec["kernel_bench_launches"] = bench[rec["name"]]
    print(json.dumps({"kernels": [rec_pa, rec_fa, rec_ml]}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"[chip_smoke] wall {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
