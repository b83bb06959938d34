"""Run the PyTorch port on one NVIDIA GPU, end to end.

  python3 chip_smoke.py

Phases (any failure exits non-zero):

1. build   — nvcc builds every CUDA source of the port (one process each,
             all at once) from src/repro_torch/csrc.
2. kernels — each kernel against its plain PyTorch version on the card, at
             the main path's shape and at edge cases; the main path's shape
             is timed (CUDA events, median) beside its bound, the plain
             version and one PyTorch library call. K1 paged attention at
             the serving shape; K2 flash attention at the forward shape
             (B=2, H=20, S=4096, d=128, bf16, causal), the
             tests/test_kernels.py sweep in f32 and bf16, gemma2's widths,
             ragged tails and strided views.
3. small   — the reduced models, kernel path on the card against the plain
             path on the CPU from the same weights: the serving example
             (same generated tokens) and a 2-layer Qwen forward with
             use_pallas (same logits and loss).
4. serve   — Qwen1.5-4B at full width and depth (random bf16 weights from
             a seed, float32 KV pools) served through the SMS scheduler and
             the paged allocator until at least 8 requests of both client
             kinds have finished. Every logit must be finite, K1 must have
             run once per layer per step, and one mid-run step is
             recomputed with the plain attention.
5. forward — the same weights, the pools freed: the full-sequence forward
             and loss (``get_model(cfg).train_loss`` with use_pallas, B=2,
             S=4096, bf16). The loss must be finite, K2 must have run once
             per layer per forward, K2 at the first and last layer is held
             against the plain version, and the logits and loss against a
             forward with the plain attention.

It prints a JSON ``kernels`` line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``. TF32 is off throughout.
"""
import gc
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch

from repro_torch.configs.base import RunConfig, reduced
from repro_torch.configs.registry import get_config
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.models import lm
from repro_torch.models.common import softmax_xent
from repro_torch.models.registry import get_model
from repro_torch.serving import paged_lm
from repro_torch.serving.engine import generate_requests
from repro_torch.serving.types import default_clients

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12          # float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # bf16 dense tensor cores
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


def _example():
    spec = importlib.util.spec_from_file_location(
        "serve_heterogeneous_torch",
        os.path.join(ROOT, "examples", "serve_heterogeneous_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _time_ms(fn, repeats):
    """Median milliseconds of ``fn()`` over ``repeats`` runs, each between
    two CUDA events, after two warm-up runs."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


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


def phase_kernels():
    """K1 against its plain version; returns the serving-shape record."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, H, d, page, n_slots, P = 32, 20, 128, 16, 36, SERVE_PAGES
    lens = torch.randint(1, page * n_slots + 1, (B,), generator=gen,
                         device="cuda")
    x = _paged_inputs(gen, B, H, H, d, page, n_slots, P, lens, torch.float32)
    err_a = _assert_close("paged_attention (a) serving shape f32",
                          ops.paged_attention(*x), paged_attention_ref(*x),
                          F32_TOL)

    lens_b = torch.randint(1, 16 * 8 + 1, (6,), generator=gen, device="cuda")
    xb = _paged_inputs(gen, 6, 8, 4, 256, 16, 8, 64, lens_b, torch.bfloat16)
    err_b = _assert_close(
        "paged_attention (b) GQA d=256 softcap bf16",
        ops.paged_attention(*xb, softcap=50.0),
        paged_attention_ref(*xb, softcap=50.0), BF16_TOL)

    # lengths 0, 1, an exact page multiple, ragged; ids -1 past the length
    xc = list(_paged_inputs(gen, 5, 6, 2, 80, 16, 4, 32,
                            [0, 1, 16, 48, 37], torch.float32))
    starts = torch.arange(4, device="cuda") * 16
    xc[3] = torch.where(starts[None, :] < xc[4][:, None], xc[3],
                        torch.full_like(xc[3], -1)).contiguous()
    got_c = ops.paged_attention(*xc)
    if bool(got_c[0].abs().max() != 0):
        raise AssertionError("paged_attention (c): length 0 must give 0")
    err_c = _assert_close("paged_attention (c) edge lengths, g=3, d=80",
                          got_c, paged_attention_ref(*xc), F32_TOL)
    xd = _paged_inputs(gen, 4, 4, 2, 16, 8, 3, 16, [5, 8, 24, 13],
                       torch.float32)
    err_d = _assert_close("paged_attention (d) d=16 (example width)",
                          ops.paged_attention(*xd), paged_attention_ref(*xd),
                          F32_TOL)
    print(f"[kernels] paged_attention max|err| (a) {err_a:.3e} "
          f"(b) {err_b:.3e} (c) {err_c:.3e} (d) {err_d:.3e}")

    # timing at the serving shape
    q, k, v, pt, ln = x
    ms = _time_ms(lambda: ops.paged_attention(*x), 50)
    plain_ms = _time_ms(lambda: paged_attention_ref(*x), 10)
    S = n_slots * page
    kg = k[pt.long()].transpose(1, 2).reshape(B, H, S, d)
    vg = v[pt.long()].transpose(1, 2).reshape(B, H, S, d)
    mask = (torch.arange(S, device="cuda")[None, :]
            < ln.long()[:, None])[:, None, None, :]
    qs = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(qs, kg, vg, attn_mask=mask)[:, :, 0]
    _assert_close("sdpa yardstick", lib_out, paged_attention_ref(*x),
                  dict(atol=1e-4, rtol=1e-3))
    library_ms = _time_ms(lambda: sdpa(qs, kg, vg, attn_mask=mask), 50)
    keys = int(torch.clamp(ln, max=S).sum())
    elt = q.element_size()
    n_bytes = (2 * keys * H * d * elt            # live K and V rows
               + 2 * q.numel() * elt             # q in, out
               + 4 * (B + int(((ln + page - 1) // page).sum())))
    n_flops = 4 * keys * H * d                   # q.k and p.v
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS_PER_S * 1e3
    rec = {"name": "paged_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/paged_attention.cu",
           "replaces": "src/repro/kernels/paged_attention/kernel.py:67",
           "launches": None, "max_abs_err": err_a, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms}
    print(f"[kernels] paged_attention serving shape B={B} H={H} d={d} "
          f"page={page} slots={n_slots} keys={keys}: {ms:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({n_bytes / ms / 1e6:.1f} GB/s), plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms")
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
    check("(d) ragged Sq=Sk=200 window 70 f32",
          _flash_inputs(gen, 1, 4, 2, 200, 200, 80, torch.float32), F32_TOL,
          window=70)
    check("(d) ragged non-causal Sq=72 Sk=136 f32",
          _flash_inputs(gen, 2, 2, 1, 72, 136, 48, torch.float32), F32_TOL,
          causal=False)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in
             _flash_inputs(gen, 2, 6, 3, 192, 192, 64, torch.bfloat16)]
    check("(d) strided (B,S,H,d) views bf16", views, BF16_TOL)
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
    elt = x[0].element_size()
    n_bytes = 4 * B * H * S * d * elt             # q, k, v in; out
    n_flops = 4 * B * H * d * S * (S + 1) // 2    # q.k and p.v, causal pairs
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / BF16_FLOPS_PER_S * 1e3
    rec = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:75",
           "launches": None, "max_abs_err": err_a, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms,
           "bound_f32_ms": n_flops / F32_FLOPS_PER_S * 1e3}
    print(f"[kernels] flash_attention forward shape B={B} H={H} S={S} d={d} "
          f"bf16 causal: {ms:.4f} ms ({n_flops / ms / 1e9:.1f} TFLOP/s), "
          f"bound {rec['bound_ms']:.4f} ms at the bf16 tensor-core peak, "
          f"{rec['bound_f32_ms']:.4f} ms at the f32 rate; plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms; max|err| "
          f"{err_a:.3e}")
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
    use_pallas on the card (K2) against the same on the CPU (plain)."""
    cfg = reduced(get_config("qwen1.5-4b"), n_layers=2, head_dim=32)
    run = RunConfig(compute_dtype="float32", use_pallas=True)
    params = lm.init(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 129),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    before = fa_ops.flash_attention.launches
    with torch.no_grad():
        for dev in ("cpu", "cuda"):
            p, b = _tree_to(params, dev), _tree_to(batch, dev)
            logits, _ = lm.forward_train(p, cfg, run, b)
            loss = get_model(cfg).train_loss(p, run, b)
            out[dev] = (logits.cpu(), loss.cpu())
    if fa_ops.flash_attention.launches - before != 2 * cfg.n_layers:
        raise AssertionError("small forward: K2 did not run on the card")
    err = _assert_close("small forward logits, card vs cpu", out["cuda"][0],
                        out["cpu"][0], F32_TOL)
    err_l = _assert_close("small forward loss, card vs cpu", out["cuda"][1],
                          out["cpu"][1], F32_TOL)
    print(f"[forward] small input: reduced qwen B=2 S=128 f32, logits "
          f"max|err| {err:.3e}, loss {float(out['cuda'][1]):.6f} (cpu "
          f"{float(out['cpu'][1]):.6f}, |err| {err_l:.3e})")


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
    ops.paged_attention.launches = 0
    fa_ops.flash_attention.launches = 0
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
    stream.close()                     # frees the KV pools
    if fa_ops.flash_attention.launches:
        raise AssertionError("serving decode launched flash_attention")
    steps = rec["step"] + 1
    if launches != SERVE_LAYERS_PER_STEP * steps:
        raise AssertionError(f"paged_attention launches {launches} != "
                             f"{SERVE_LAYERS_PER_STEP} x {steps} steps")
    if calls["plain_err"] is None:
        raise AssertionError("the plain-attention check step never ran")
    total = sum(step_s)
    print(f"[serve] steps {steps}, finished {len(finished)} "
          f"({finished.count('bulk')} bulk, "
          f"{finished.count('interactive')} interactive), decode "
          f"{tokens / total:.1f} tok/s, mean step {1e3 * total / len(step_s):.3f}"
          f" ms, median step {1e3 * statistics.median(step_s):.3f} ms, "
          f"paged_attention launches {launches}; step {SERVE_CHECK_STEP}: "
          f"attention vs plain max|err| {calls['attn_err']:.3e} (40 layers),"
          f" logits vs plain-attention step max|err| "
          f"{calls['plain_err']:.3e}, argmax agreement {calls['argmax']:.3f};"
          f" peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return launches, params


def phase_forward(params, flash_ms):
    """Full-width, full-depth Qwen1.5-4B: the full-sequence forward and loss
    through ``get_model(cfg).train_loss`` with K2; returns K2's launches."""
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

    ops.paged_attention.launches = 0
    fa_ops.flash_attention.launches = 0
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
    if launches != cfg.n_layers * n_fwd:
        raise AssertionError(f"flash_attention launches {launches} != "
                             f"{cfg.n_layers} x {n_fwd} forwards")
    if len(checked["err"]) != 2:
        raise AssertionError("the layer checks of the forward never ran")
    fwd_ms = 1e3 * statistics.median(wall)
    print(f"[forward] {cfg.name} B={FWD_B} S={FWD_S} bf16 use_pallas: "
          f"{n_fwd} forwards, flash_attention launches {launches}; loss "
          f"{float(loss):.6f} (plain attention {float(loss_p):.6f}, |err| "
          f"{err_loss:.3e}); logits vs plain attention max|err| "
          f"{err_logits:.3e}; K2 vs plain at layers 0 and "
          f"{cfg.n_layers - 1} max|err| {max(checked['err']):.3e}; "
          f"median forward+loss {fwd_ms:.3f} ms "
          f"({', '.join(f'{1e3 * t:.3f}' for t in wall)}), "
          f"{FWD_B * FWD_S / (fwd_ms / 1e3):.1f} scored tokens/s, K2 share "
          f"{cfg.n_layers * flash_ms / fwd_ms:.3f} ({cfg.n_layers} x "
          f"{flash_ms:.4f} ms); peak memory {peak / 2**30:.1f} GiB")
    return launches


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
    phase_small_input()
    phase_small_forward()
    rec_pa["launches"], params = phase_serve()
    rec_fa["launches"] = phase_forward(params, rec_fa["ms"])
    print(json.dumps({"kernels": [rec_pa, rec_fa]}))
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
