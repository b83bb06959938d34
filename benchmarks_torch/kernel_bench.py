"""Kernel bench: every hand-written kernel against its plain version.

  python3 benchmarks_torch/kernel_bench.py [--device cuda|cpu]

Port of ``benchmarks/kernel_bench.py``, at its own shape sweeps and with
float32 inputs as there: K1 paged attention, K2 flash attention (causal)
and K3 the mLSTM scan, each held against its ``ref.py`` on the same inputs
and gated as that bench gates them: the run fails unless every max |err|
is below 1e-3. Per row: max |err|; its ratio to the elementwise f32
tolerance of tests/test_kernels.py (``2e-5 + 2e-4 |plain|``; above 1 where
the float32 rounding of long sums exceeds it); GFLOP and MB per call; the
H100 bound (the larger of the bytes over the HBM rate and the operations
over the float32 rate); the bound at the rate the kernel uses
(``bound_used_ms``: K1 runs on the CUDA cores, so the same; K2's float32
route and K3 take each float32 product as three TF32 tensor-core products,
3xTF32, so three times their operations at the TF32 rate); the kernel's
median ms (CUDA events), the plain version's and, for K1 and K2, one
PyTorch library call's (SDPA, the yardstick ``chip_smoke.py`` uses). No
single PyTorch call computes the mLSTM scan, so K3 has no library column.
Every ``ms`` is one call between two CUDA events, the wrapper's host work
included; K3's rows add ``device_ms``, the device time per call from
CUDA-graph replays (``device_ms`` below), which leaves the host out.

With ``--device cpu`` the wrappers take their plain versions, so the check
runs and no time is measured. ``--device cuda`` (the default) exits
non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.mlstm_scan.ops import mlstm_scan
from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_ref
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.roofline.analysis import (F32_FLOPS_PER_S, TF32_FLOPS_PER_S,
                                           bound_ms)

F32_TOL = dict(atol=2e-5, rtol=2e-4)           # tests/test_kernels.py
MAX_ERR = 1e-3          # benchmarks/kernel_bench.py:107-108's pass/FAIL rule
# benchmarks/kernel_bench.py's sweeps
FLASH_SHAPES = [(1, 8, 8, 1024, 128), (1, 16, 4, 2048, 128),
                (2, 8, 2, 512, 64)]            # B, Hq, Hkv, S, d
PAGED_SHAPES = [(8, 8, 2, 128, 64, 8, 128),    # B, Hq, Hkv, d, page, slots, P
                (32, 4, 4, 64, 16, 16, 1024)]
MLSTM_SHAPES = [(2, 4, 512, 96, 128), (1, 4, 1024, 64, 256)]  # B,H,S,dh,chunk


def time_ms(fn: Callable[[], object], repeats: int) -> float:
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


def device_ms(fn: Callable[[], object], calls: int = 20,
              repeats: int = 10) -> float:
    """Median device milliseconds per call of ``fn()``: ``calls`` calls
    captured in one CUDA graph after three warm-up calls on the capturing
    stream, the graph replayed ``repeats`` times between two CUDA events.
    The host's work per call is left out; the gaps between the calls'
    kernels on the card stay in."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def compare(got: torch.Tensor, want: torch.Tensor) -> Tuple[float, float]:
    """(max |got - want|, max of |got - want| / (atol + rtol |want|) at the
    f32 tolerance)."""
    err = (got.float() - want.float()).abs()
    if not err.numel():
        return 0.0, 0.0
    bound = F32_TOL["atol"] + F32_TOL["rtol"] * want.float().abs()
    return float(err.max()), float((err / bound).max())


def _row(kernel, shape, flops, n_bytes, bound_flops, dev, fn, plain,
         library: Optional[Callable], repeats=(20, 5)) -> Dict:
    err, ratio = compare(fn(), plain())
    bound, by = bound_ms(n_bytes, bound_flops, F32_FLOPS_PER_S)
    row = {"kernel": kernel, "shape": shape, "max_abs_err": err,
           "f32_tol_ratio": ratio, "gflop": flops / 1e9,
           "mbytes": n_bytes / 1e6, "bound_ms": bound, "bound_by": by,
           "bound_used_ms": bound, "ms": None, "device_ms": None,
           "plain_ms": None, "library_ms": None}
    if dev == "cuda":
        row["ms"] = time_ms(fn, repeats[0])
        row["plain_ms"] = time_ms(plain, repeats[1])
        if library is not None:
            row["library_ms"] = time_ms(library, repeats[0])
    return row


def bench_flash(dev: str, shapes=FLASH_SHAPES) -> List[Dict]:
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for (B, Hq, Hkv, S, d) in shapes:
        rng = np.random.RandomState(0)
        q = torch.from_numpy(rng.randn(B, Hq, S, d).astype(np.float32)).to(dev)
        k, v = (torch.from_numpy(rng.randn(B, Hkv, S, d).astype(np.float32))
                .to(dev) for _ in range(2))
        flops = flash_flops(B, Hq, S, d)
        n_bytes = flash_bytes(B, Hq, Hkv, S, d)
        row = _row(
            "flash_attention", f"B{B}H{Hq}/{Hkv}S{S}d{d}", flops,
            n_bytes, flops, dev,
            lambda: flash_attention(q, k, v, causal=True),
            lambda: attention_ref(q, k, v, causal=True),
            lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
        row["bound_used_ms"] = flash_bound_3xtf32(B, Hq, Hkv, S, d)
        rows.append(row)
    return rows


def flash_flops(B, Hq, S, d) -> int:
    """q.k^T and p.v over the causal pairs, 2 d operations each."""
    return 4 * B * Hq * d * S * (S + 1) // 2


def flash_bytes(B, Hq, Hkv, S, d, elt=4) -> int:
    """q, k, v read and out written once."""
    return elt * S * d * B * (2 * Hq + 2 * Hkv)


def flash_bound_3xtf32(B, Hq, Hkv, S, d) -> float:
    """K2's float32 bound at the rate its kernel uses: three TF32
    tensor-core products for each float32 product (3xTF32), or its bytes,
    whichever takes longer."""
    return bound_ms(flash_bytes(B, Hq, Hkv, S, d),
                    3 * flash_flops(B, Hq, S, d), TF32_FLOPS_PER_S)[0]


def paged_inputs(dev: str, B, Hq, Hkv, d, page, n_slots, P, seed=0):
    """The bench's float32 K1 inputs (q, k_pages, v_pages, page_table,
    lengths) from ``seed``: lengths uniform in [page, page * n_slots], page
    ids uniform in [0, P). Returns them with the live keys and pages."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(page, page * n_slots + 1, (B,)).astype(np.int32)
    pt = rng.randint(0, P, (B, n_slots)).astype(np.int32)
    q = torch.from_numpy(rng.randn(B, Hq, d).astype(np.float32)).to(dev)
    kp, vp = (torch.from_numpy(rng.randn(P, Hkv, page, d)
                               .astype(np.float32)).to(dev) for _ in range(2))
    x = (q, kp, vp, torch.from_numpy(pt).to(dev),
         torch.from_numpy(lengths).to(dev))
    return x, int(lengths.sum()), int(((lengths + page - 1) // page).sum())


def paged_sdpa(x, enable_gqa=True):
    """The library yardstick for K1: SDPA over the pages gathered
    beforehand (the gather is not timed). Returns a callable that gives
    SDPA's (B, Hq, 1, d) output."""
    q, kp, vp, pt, ln = x
    B, d = q.shape[0], q.shape[2]
    Hkv, page = kp.shape[1], kp.shape[2]
    S = pt.shape[1] * page
    kg = kp[pt.long()].transpose(1, 2).reshape(B, Hkv, S, d)
    vg = vp[pt.long()].transpose(1, 2).reshape(B, Hkv, S, d)
    mask = (torch.arange(S, device=q.device)[None, :]
            < ln.long()[:, None])[:, None, None, :]
    qs = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qs, kg, vg, attn_mask=mask, enable_gqa=enable_gqa)


def bench_paged(dev: str, shapes=PAGED_SHAPES) -> List[Dict]:
    rows = []
    for (B, Hq, Hkv, d, page, n_slots, P) in shapes:
        x, keys, pages = paged_inputs(dev, B, Hq, Hkv, d, page, n_slots, P)
        flops = 4 * keys * Hq * d                      # q.k and p.v
        n_bytes = (4 * 2 * keys * Hkv * d              # live K and V rows
                   + 4 * 2 * x[0].numel() + 4 * (B + pages))
        rows.append(_row(
            "paged_attention", f"B{B}H{Hq}/{Hkv}d{d}p{page}", flops,
            n_bytes, flops, dev, lambda: paged_attention(*x),
            lambda: paged_attention_ref(*x), paged_sdpa(x),
            repeats=(50, 10)))
    return rows


def mlstm_flops(B, H, S, dh, chunk):
    """(work as the TPU kernel does it, the work the function needs).

    The TPU kernel multiplies the full L x L chunk: 4 B H S L dh for q.k^T
    and P.v, plus 4 B H S dh^2 for q.C and the state update C += (k wL)^T v.
    The reference bench's formula (benchmarks/kernel_bench.py:86) counts
    2 B H S dh^2, leaving out the update's product. The function needs only
    the L (L + 1) / 2 causal pairs of each chunk, which the bound counts.
    """
    state = 4 * B * H * S * dh * dh
    full = 4 * B * H * S * chunk * dh + state
    causal = 4 * B * H * (S // chunk) * (chunk * (chunk + 1) // 2) * dh
    return full, causal + state


def mlstm_bytes(B, H, S, dh, elt=4):
    """q, k, v read and h written once, plus the two float32 gates."""
    return 4 * B * H * S * dh * elt + 2 * B * H * S * 4


def mlstm_inputs(rng, B, H, S, dh, dev, forget=(0.5, 0.99), li_std=0.5):
    """float32 q, k, v ~ N(0, 1); lf = log U(forget); li ~ N(0, li_std^2)."""
    q, k, v = (torch.from_numpy(rng.randn(B, H, S, dh).astype(np.float32))
               .to(dev) for _ in range(3))
    lf = torch.from_numpy(np.log(rng.uniform(*forget, (B, H, S)))
                          .astype(np.float32)).to(dev)
    li = torch.from_numpy((rng.randn(B, H, S) * li_std).astype(np.float32)) \
        .to(dev)
    return q, k, v, lf, li


def bench_mlstm(dev: str, shapes=MLSTM_SHAPES) -> List[Dict]:
    rows = []
    for (B, H, S, dh, chunk) in shapes:
        x = mlstm_inputs(np.random.RandomState(0), B, H, S, dh, dev)
        full, needed = mlstm_flops(B, H, S, dh, chunk)
        fn = lambda: mlstm_scan(*x, chunk=chunk)      # noqa: E731
        row = _row("mlstm_scan", f"B{B}H{H}S{S}dh{dh}c{chunk}", full,
                   mlstm_bytes(B, H, S, dh), needed, dev, fn,
                   lambda: mlstm_scan_ref(*x, chunk=chunk), None)
        row["bound_used_ms"] = mlstm_bound_3xtf32(B, H, S, dh, chunk)
        if dev == "cuda":
            row["device_ms"] = device_ms(fn)
        rows.append(row)
    return rows


def mlstm_bound_3xtf32(B, H, S, dh, chunk) -> float:
    """K3's bound at the rate its kernel uses: three TF32 tensor-core
    products for each float32 product the function needs (3xTF32), or its
    bytes, whichever takes longer."""
    return bound_ms(mlstm_bytes(B, H, S, dh),
                    3 * mlstm_flops(B, H, S, dh, chunk)[1],
                    TF32_FLOPS_PER_S)[0]


def mlstm_pass_bounds_3xtf32(B, H, S, dh, chunk) -> Dict[str, float]:
    """The 3xTF32 bound of K3's two product passes, in ms: the states pass
    the update C += (k wL)^T v (2 B H S dh^2), the outputs pass q.C and the
    causal q.k^T and P.v (2 B H S dh^2 plus the causal pairs); together the
    operations of ``mlstm_bound_3xtf32``."""
    update = 2 * B * H * S * dh * dh
    needed = mlstm_flops(B, H, S, dh, chunk)[1]
    return {"states": 3 * update / TF32_FLOPS_PER_S * 1e3,
            "outputs": 3 * (needed - update) / TF32_FLOPS_PER_S * 1e3}


def _fmt(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("kernel_bench: no CUDA device (--device cpu runs the "
                         "plain versions only)")
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        card = torch.cuda.get_device_name(0)
    else:
        card = "cpu: plain versions only, no time measured"
    print(f"# kernels vs plain versions, float32, {card}; bound = H100 SXM "
          f"data sheet (HBM 3.35 TB/s, float32 67 TFLOP/s)")
    print("kernel,shape,max_err,f32_tol_ratio,gflop_call,mbytes_call,"
          "bound_ms,bound_by,bound_used_ms,ms,device_ms,plain_ms,library_ms")
    rows = (bench_paged(args.device) + bench_flash(args.device)
            + bench_mlstm(args.device))
    for r in rows:
        print(f"{r['kernel']},{r['shape']},{r['max_abs_err']:.2e},"
              f"{r['f32_tol_ratio']:.3f},{r['gflop']:.3f},{r['mbytes']:.2f},"
              f"{r['bound_ms']:.4f},{r['bound_by']},"
              f"{r['bound_used_ms']:.4f},{_fmt(r['ms'])},"
              f"{_fmt(r['device_ms'])},{_fmt(r['plain_ms'])},"
              f"{_fmt(r['library_ms'])}")
    worst = max(r["max_abs_err"] for r in rows)
    print(json.dumps({"kernel_bench": rows}))
    if worst >= MAX_ERR:
        raise SystemExit(f"kernel_bench: FAIL, max |err| {worst:.2e} >= "
                         f"{MAX_ERR:g}")
    print(f"kernel_bench: pass, max |err| {worst:.2e} < {MAX_ERR:g}")
    return rows


if __name__ == "__main__":
    main()
