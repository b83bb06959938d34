"""Variants of K3's cluster outputs pass, timed in turns against the source
as it is: what the pass past dh 512 or chunk 256 spends its time on, and
the designs it was chosen over.

  python3 benchmarks_torch/mlstm_variants.py [--variants a,b,...]
      [--shapes all|wide|narrow|none] [--baseline-src DIR] [--accuracy]

Each variant is ``csrc/mlstm_scan_sm90.cu`` with a few textual edits
(``VARIANTS``), built with the port's nvcc flags beside the source itself
(one nvcc each, all at once; ``baselines._libraries``), and launched
through the wrapper's own arguments (a variant that changes the plan gives
its own, ``PLANS``). With ``--baseline-src DIR`` commit 774e907's source
(``DIR/src/repro_torch/csrc/mlstm_scan_sm90.cu``, the sliced outputs pass
before the clusters; ``baselines.sliced_plan``) is one more build. At each
of chip_smoke.py's K3_WIDE_SHAPES (B=8, H=4, S=2048: dh = 768, 1024 and
1280 at chunk 256, dh = 384 and 64 at chunk 512, f32) and at dh=64, chunk
512 (``NARROW_SHAPES``, B=8 H=4 and B=1 H=2) it prints each build's device
ms of the outputs pass alone and of the whole scan (CUDA-graph replays, one
shared workspace, the builds in one order and then in the reverse one, the
mean of the two) and its largest error against the plain version. With
``--accuracy`` it holds each build against the float64 scan
(chip_smoke._scan_f64) at B=1, H=1, S=128, chunk 64 and dh = 1280 .. 8192
(``ACCURACY_DH``), as a fraction of the float32 bar. A build that does not
compile or launch is reported and left out, and the script then exits
non-zero after the rest has run; so it does where a build that is not a
probe misses the float32 bar (atol 2e-5, rtol 2e-4 of the largest |h|, the
bar chip_smoke.py holds the kernel to at these widths), or, with
``--accuracy``, is past the elementwise bar against float64 (774e907's
build is only reported there).

Designs: ``k3_recompute`` takes clusters of one CTA, so every CTA takes S
over all of dh itself (as the sliced pass before the clusters did);
``k3_cols256`` gives a CTA 256 columns at most at every dh (the source:
past dh 1280); ``k3_v32`` takes P.V's keys 32 a stage at every width (the
source: 128 where a CTA holds 128 columns or fewer, 64 up to 256);
``k3_row_order`` orders the grid by row tile first (heaviest first, as the
sliced pass did) at every chunk, ``k3_chunk_order`` keeps a chunk's row
tiles together at every chunk (the source: the first past chunk 256, the
second up to it); ``k3_nt2_narrow`` runs dh <= 64 on the 128-column
instance, ``k3_q_per_slice`` on the 64-column one with q read and split by
every S and q.C job (the source splits the row tile's q once there);
``k3_no_trim`` computes the key tiles and k steps past a warp's last row.
Probes, wrong on purpose: ``k3_no_exchange`` reads the CTA's own partial S
for every rank (the cluster barriers stay), ``k3_no_qc`` leaves q.C_prev's
products out, ``k3_no_s`` S's, ``k3_no_pv`` P.V's and ``k3_no_products``
all three; ``k3_no_c_loads``, ``k3_no_v_loads``, ``k3_no_k_loads`` and
``k3_no_q_loads`` copy no C_prev, v, k or (S's) q slice in (their products
stay); ``k3_no_key_scalars`` reads no F_j, li_j; ``k3_no_q_barrier`` drops
the barrier after q's split and ``k3_no_p_barrier`` the one before P
overwrites the partial S (races); ``k3_a_once`` loads the A fragments of
q.C_prev and P.V once a stage (what their loads cost); ``k3_no_b_split``
feeds C_prev and v to the products unsplit (hi the raw value, lo 0: at most
what splitting them once would save).

Prints the card's name and power limit. Needs a CUDA device and the CUDA
toolkit.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "variants"
SRC = "mlstm_scan_sm90"

_ORDER = "  if (n_rt > 4) {                      // past chunk 256: heaviest tiles first"
_CTAS = "    const int most = dh > kFreshDh ? 64 * kFreshNt : kMaxDh;  // columns"
_QC = "  for (int x = 0; x < nC1; ++x, ++job) qc_products(begin(job, 1, 0, x), x);"
_NO_QC = "  for (int x = 0; x < nC1; ++x, ++job) begin(job, 1, 0, x);"
_PV = ("      cluster_products<VD>(o, Ph, Pl, kKeys / 8, x * (VD / 8),\n"
       "                           begin(job, 2, ks, x), CS, wm, wn, lane, "
       "u_n, kn);")
_B_SPLIT = ("        uint32_t bh_[2], bl[2];\n"
            "        split(p[0], bh_[0], bl[0]);\n"
            "        split(p[4 * cs], bh_[1], bl[1]);\n")
_B_RAW = ("        const uint32_t bh_[2] = {__float_as_uint(p[0]),\n"
          "                                 __float_as_uint(p[4 * cs])};\n"
          "        const uint32_t bl[2] = {0u, 0u};\n")
VARIANTS = {
    "k3_recompute": [("constexpr int kMaxCluster = 8;",
                      "constexpr int kMaxCluster = 1;")],
    "k3_cols256": [(_CTAS, "    const int most = 256;")],
    "k3_row_order": [(_ORDER, "  if (true) {")],
    "k3_chunk_order": [(_ORDER, "  if (false) {")],
    "k3_no_exchange": [("      const uint32_t at = mapa(src, (uint32_t)r);",
                        "      const uint32_t at = src;")],
    "k3_no_qc": [(_QC, _NO_QC)],
    "k3_no_s": [("        if (16 * wn < nks && 16 * wn <= last) {", "        if (false) {")],
    "k3_no_pv": [(_PV, "      begin(job, 2, ks, x);")],
    "k3_no_c_loads": [("      for (int e = tid; e < kKs3 * CH; e += kThreads3) {",
                       "      for (int e = tid; e < 0; e += kThreads3) {")],
    "k3_v32": [("  return nt <= 2 ? kKeys : nt <= 4 ? 64 : 32;", "  return 32;")],
    "k3_no_products": [(_QC, _NO_QC),
                       ("        if (16 * wn < nks && 16 * wn <= last) {", "        if (false) {"),
                       (_PV, "      begin(job, 2, ks, x);")],
    "k3_no_q_barrier": [("    if (kind == 1 && !QO) __syncthreads();   // q's hi and "
                         "lo are in place\n", "")],
    "k3_a_once": [("(((2 * wm + m) * k8 + s8 + kk) * 32 + lane) * 4",
                   "(((2 * wm + m) * k8 + s8) * 32 + lane) * 4")],
    "k3_no_b_split": [(_B_SPLIT, _B_RAW)],
    "k3_no_trim": [("  const int seen = min(Nv, i0 + 32 * wm + 32);",
                    "  const int seen = 1 << 30;"),
                   ("    const int last = i0 + 32 * wm + 31 - j0s;",
                    "    const int last = kKeys;")],
    "k3_q_per_slice": [("  constexpr bool QO = NT == 1;",
                        "  constexpr bool QO = false;")],
    "k3_nt2_narrow": [("    p.nt = tiles8 == 1 ? 1 : (tiles8 + 1) / 2 * 2;",
                       "    p.nt = (tiles8 + 1) / 2 * 2;")],
    "k3_no_v_loads": [("      for (int e = tid; e < VD * CH; e += kThreads3) {",
                       "      for (int e = tid; e < 0; e += kThreads3) {")],
    "k3_no_k_loads": [("      for (int e = tid; e < ((nks + 7) & ~7) * (kSd / 4); "
                       "e += kThreads3) {",
                       "      for (int e = tid; e < 0; e += kThreads3) {")],
    "k3_no_q_loads": [("      for (int e = tid; e < (QO ? 0 : kRows * (kSd / 4)); "
                       "e += kThreads3) {",
                       "      for (int e = tid; e < 0; e += kThreads3) {")],
    "k3_no_p_barrier": [("      __syncthreads();                 // no warp reads its "
                         "partial now\n", "")],
    "k3_no_key_scalars": [("    for (int j = tid; j < kKeys; j += kThreads3) {",
                           "    for (int j = tid; j < 0; j += kThreads3) {")],
}
# the narrowest CTA (the 64-column instance, one CTA a cluster), where
# the P.V stages are deepest: B, H, S, dh, chunk
NARROW_SHAPES = ((8, 4, 2048, 64, 512), (1, 2, 1024, 64, 512))
# --accuracy: B, H, S, chunk and the widths held against a float64 scan
ACCURACY_SHAPE = (1, 1, 128, 64)
ACCURACY_DH = (1280, 2048, 2560, 4096, 4100, 8192)
PROBES = ("k3_no_exchange", "k3_no_qc", "k3_no_s", "k3_no_pv", "k3_no_c_loads",
          "k3_no_products", "k3_no_q_barrier", "k3_a_once", "k3_no_b_split",
          "k3_no_v_loads", "k3_no_k_loads", "k3_no_q_loads", "k3_no_p_barrier",
          "k3_no_key_scalars")


def _plan_cols256(S, dh, chunk):
    """``ops.plan`` with CTAs of 256 columns at most (``k3_cols256``)."""
    from repro_torch.kernels.mlstm_scan import ops
    p = ops.plan(S, dh, chunk)
    if not p["sliced"]:
        return p
    ctas = -(-dh // 256)
    cluster = min(ctas, ops.MAX_CLUSTER)
    ctas = -(-ctas // cluster) * cluster
    units = -(-dh // 8)
    nt = -(-(-(-units // ctas)) // 8)
    nt += nt % 2
    return {**p, "nt": nt, "cluster": cluster, "ctas": ctas,
            "smem_outputs": ops.cluster_smem(nt)}


def _plan_v32(S, dh, chunk):
    """``ops.plan`` with P.V's keys 32 a stage (``k3_v32``)."""
    from repro_torch.kernels.mlstm_scan import ops
    p = ops.plan(S, dh, chunk)
    if p["sliced"] and p["nt"] <= 4:
        q = dict(p)
        q["smem_outputs"] = p["smem_outputs"] - 4 * 2 * (
            ops.cluster_stage(p["nt"]) - ops.cluster_stage(p["nt"], 32))
        return q
    return p


def _plan_nt2(S, dh, chunk):
    """``ops.plan`` with the 128-column instance where a CTA holds 64
    columns or fewer (``k3_nt2_narrow``)."""
    from repro_torch.kernels.mlstm_scan import ops
    p = ops.plan(S, dh, chunk)
    if p["sliced"] and p["nt"] == 1:
        return {**p, "nt": 2, "smem_outputs": ops.cluster_smem(2)}
    return p


PLANS = {"k3_cols256": _plan_cols256, "k3_v32": _plan_v32,
         "k3_nt2_narrow": _plan_nt2}


def variant_sources(names) -> dict:
    """{build name: text}: the source as it is (named as the source) and
    each named variant; raises where an edit no longer matches the source
    once."""
    text = (CSRC / f"{SRC}.cu").read_text()
    out = {SRC: text}
    for name in names:
        t = text
        for old, new in VARIANTS[name]:
            if t.count(old) != 1:
                raise ValueError(f"mlstm_variants: {name}'s edit no longer "
                                 f"matches the source once: {old[:60]!r}")
            t = t.replace(old, new)
        out[name] = t
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--shapes", choices=("all", "wide", "narrow", "none"),
                    default="all")
    ap.add_argument("--baseline-src", metavar="DIR", default=None,
                    help="a checkout holding commit 774e907's "
                         "src/repro_torch/csrc/mlstm_scan_sm90.cu, timed "
                         "in turns with the builds (its sliced plan)")
    ap.add_argument("--accuracy", action="store_true",
                    help="also hold each build against a float64 scan at "
                         "ACCURACY_DH")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("mlstm_variants needs a CUDA device")
    from benchmarks_torch import baselines
    from benchmarks_torch.kernel_bench import compare, device_ms, mlstm_inputs
    from chip_smoke import K3_BASELINE, K3_WIDE_SHAPES, _scan_f64
    from repro_torch.kernels.mlstm_scan import ops
    from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    names = [n for n in args.variants.split(",") if n]
    texts = variant_sources(names)
    OUT.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, text in texts.items():
        paths[name] = OUT / f"{SRC}_{name}.cu"
        paths[name].write_text(text)
    plans = dict(PLANS)
    if args.baseline_src:
        paths[K3_BASELINE] = (Path(args.baseline_src) / "src" / "repro_torch"
                              / "csrc" / f"{SRC}.cu")
        plans[K3_BASELINE] = baselines.sliced_plan
    failed = {}
    libs = baselines._libraries(paths, failed)
    for n, log in failed.items():
        print(f"{n}: nvcc failed, left out:\n{log[-4000:]}", flush=True)
    bad = [f"{n} (no build)" for n in failed]
    builds = {}
    for n, lib in libs.items():
        fn = lib.mlstm_scan_sm90_launch
        fn.argtypes, fn.restype = ops.LAUNCH_ARGTYPES, ctypes.c_int
        builds[n] = (fn, plans.get(n, ops.plan))
    rng = __import__("numpy").random.RandomState(0)
    shapes = {"all": (*K3_WIDE_SHAPES, *(s for s in NARROW_SHAPES
                                         if s not in K3_WIDE_SHAPES)),
              "wide": tuple(K3_WIDE_SHAPES), "narrow": NARROW_SHAPES,
              "none": ()}[args.shapes]
    for B, H, S, dh, chunk in shapes:
        x = mlstm_inputs(rng, B, H, S, dh, "cuda")
        want = mlstm_scan_ref(*x, chunk=chunk)
        bar = 2e-5 + 2e-4 * float(want.abs().max())
        ws = ops.workspace(B, H, S, dh, chunk, x[0].device)
        out = torch.empty_like(x[0])
        runs, notes = {}, {}
        for n, build in builds.items():
            def run(p, build=build):
                return lambda: ops._run_sm90(*x, chunk, ws=ws, out=out,
                                             passes=p, build=build)
            try:
                run(7)()
                err = float((out - want).abs().max())
            except RuntimeError as e:
                print(f"dh={dh} chunk={chunk}: {n} left out: {e}", flush=True)
                bad.append(f"{n} at dh={dh} (no launch)")
                continue
            ok = err <= bar
            if not ok and n not in PROBES:
                bad.append(f"{n} at dh={dh} chunk={chunk}")
            notes[n] = (f"max|err| {err:.1e}" + (
                ", wrong on purpose" if n in PROBES else
                "" if ok else ", MISSES the float32 bar"))
            runs[n] = (run(4), run(7))
        ms = {n: [0.0, 0.0] for n in runs}
        for order in (list(runs), list(reversed(list(runs)))):
            for n in order:
                for i in (0, 1):
                    ms[n][i] += device_ms(runs[n][i], 5, 5) / 2
        print(f"K3 f32 B={B} H={H} S={S} dh={dh} chunk={chunk}, device ms "
              f"outputs pass / scan: " + ", ".join(
                  f"{n} {ms[n][0]:.4f} / {ms[n][1]:.4f} ({notes[n]})"
                  for n in runs), flush=True)
        del x, want, ws, out
        torch.cuda.empty_cache()
    if args.accuracy:
        B, H, S, chunk = ACCURACY_SHAPE
        for dh in ACCURACY_DH:
            x = mlstm_inputs(rng, B, H, S, dh, "cuda")
            exact = _scan_f64(*x, chunk)
            row = {"plain f32": compare(mlstm_scan_ref(*x, chunk=chunk),
                                        exact)[1]}
            for n, build in builds.items():
                row[n] = compare(ops._run_sm90(*x, chunk, build=build),
                                 exact)[1]
                if row[n] > 1.0 and n not in PROBES and n != K3_BASELINE:
                    bad.append(f"{n} at dh={dh} against float64")
            print(f"K3 f32 B={B} H={H} S={S} dh={dh} chunk={chunk}, largest "
                  f"error against the float64 scan as a fraction of the f32 "
                  f"bar: " + ", ".join(f"{n} {r:.3f}" for n, r in row.items()),
                  flush=True)
            del x, exact
            torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())
    if bad:
        raise SystemExit("mlstm_variants: failed: " + ", ".join(bad))


if __name__ == "__main__":
    main()
