"""Variants of the cluster routes and of K2's own loads, timed in turns
against the sources as they are: what K2's routes past d = 256 (float32
and 2-byte) and K1's wide route past d = 2048 spend their time on, how
K2's 2-byte own loads read a layout TMA cannot, and the designs they were
chosen over.

  python3 benchmarks_torch/wide_variants.py [--variants a,b,...]
      [--baseline-src DIR]

Each variant is a source of ``csrc/`` with a few textual edits
(``VARIANTS``), built with the port's nvcc flags beside the source itself
(one nvcc each, all at once; ``baselines._libraries``), and launched
through the wrapper's own arguments. Device ms per call come from
CUDA-graph replays, the builds in one order and then in the reverse one,
the mean of the two. A build that does not compile or launch is reported
and left out, and the script then exits non-zero after the rest has run;
so it does where a build that is not a probe misses the float32 bar (atol
2e-5, rtol 2e-4).

* K2, float32, causal, at d = 512 (B=1, H=8, S=2048), d = 1280 (B=1, H=4,
  S=1024) and d = 2304 (B=1, H=2, S=512), the shapes of chip_smoke.py's
  FLASH_SHAPES; each build's slice width, CTAs a cluster and the card's
  most active such clusters (``cudaOccupancyMaxActiveClusters``) printed.
  Designs: ``k2_cols128`` and ``k2_cols256`` take one slice width at every
  d (the source takes 256 only at 1024 < d <= 2048); ``k2_cluster16``
  takes 128 columns at every d in clusters of up to 16 CTAs (past the
  portable 8: ``cudaFuncAttributeNonPortableClusterSizeAllowed``);
  ``k2_one_partial`` keeps the partial S in K's hi tile at every width,
  with two cluster barriers a tile (the source: two partial buffers by
  tile parity and one barrier where they fit). Three timing probes, at d
  = 512 only, give wrong results on purpose: ``k2_no_remote`` reads the
  CTA's own partial S for every rank (the exchange's barriers stay, its
  reads of the peers' shared memory go), ``k2_no_exchange`` drops the
  barriers too, ``k2_no_products`` leaves S's products out.
* K2, bfloat16 and float16 (``csrc/flash_attention_sm90.cu``), at d = 512,
  1280 and 2304 (FLASH_SHAPES, causal), d = 4096 (16 CTAs a cluster, the
  most) and at SigLIP-so400m's d = 72 (B=8,
  H=16, S=729, no mask) contiguous (TMA) and as views of rows of 73, 74
  and 76 elements (the own loads' 2-, 4- and 8-byte units), and d = 100
  (B=4, H=16, S=1024, no mask) as views of rows of 101 and contiguous
  (rows of 200 bytes: the 8-byte unit past whole rows); each build's
  route and CTAs a cluster printed at d > 256. Past d = 256, the designs
  not taken: ``k2b_stream`` streams q and K for every 256-column output
  slice at every d > 256 (the design before the cluster route, with the
  new loads); ``k2b_cluster8`` caps the cluster at the portable 8 CTAs, so
  that d = 2304 (9 slices) streams; ``k2b_one_phase`` has every CTA read
  every CTA's whole partial S at every cluster size (the source: past 2
  CTAs each sums the units it owns, then gathers the sums);
  ``k2b_cluster_scope`` orders the exchange as the PTX memory model asks
  across CTAs, a release at cluster scope on each remote arrive and an
  acquire at cluster scope on each wait (the source: mbarrier's default
  CTA scope); ``k2b_cluster_spread`` does so with the n remote arrives
  spread over n threads (the source: one thread arrives n times); the
  probe ``k2b_cluster_acquire`` takes only the acquire; the probe ``k2b_no_exchange`` leaves the exchange out (wrong on
  purpose). The own loads: ``k2b_single_half`` keeps one half row's words
  in flight a producer thread at d <= 128 too (the source: two there, its
  producers at 56 registers);
  ``k2b_pair_regs40`` keeps the two half rows in flight at 40 producer
  registers, its consumers at 232 (the source: 56 and 224);
  ``k2b_half_rows`` takes no whole rows (the source: where a row's live
  bytes fit 10 words, d <= 73, whole rows at every unit; else half rows,
  in pairs at d <= 128). With ``--baseline-src DIR`` (a checkout's
  ``src/repro_torch/csrc`` under DIR, as chip_smoke.py takes it) that
  checkout's 2-byte source is timed in turns too, as ``baseline``.
* K1, d = 16,384 g = 8 float32 and d = 2056 g = 1 float32 (B=2 and 4,
  page 16, 8 slots, random lengths from seed 0): ``k1_one_block_a_row``
  launches the combine kernel one block a (b, q head) as the other routes
  do (a design variant: it must meet the float32 bar); for each build the
  device time of the wide kernel and of the combine kernel apart
  (``torch.profiler``).

Prints one line per shape, and the card's name and power limit. Needs a
CUDA device and the CUDA toolkit.
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

_READ = ("        const uint32_t src0 = mapa(part, (uint32_t)r);\n"
         "        const uint32_t src1 = mapa(part, (uint32_t)(two ? r + 1 : "
         "r));")
_ARRIVE = ("    cluster_arrive();\n"
           "    pv_issue<D, BK>(o, ph, pl, v_hi, v_lo);  // tile it - 1's\n"
           "    cluster_wait();  // every CTA's partial of this tile is "
           "written")
_READ_DONE = ("    // one partial buffer: this CTA has read its peers' "
              "partials\n    if (!kTwoParts) cluster_arrive();\n")
_TOP = ("    if (!kTwoParts && it > 0) cluster_wait();\n"
        "    if (resident) split_k();")
_END = ("  if (n_tiles > 0) {\n    if (kTwoParts) cluster_arrive();\n"
        "    cluster_wait();\n  }\n\n  store_out")
_LOCAL = ("        const uint32_t src0 = part;\n"
          "        const uint32_t src1 = part;")
_PRODUCTS = ("      qk_products<D, BK, kQRegs>(sc, qf, q_hi_w, q_lo_w, k_hi, "
             "k_lo,\n                                 j != rank);")
_WIDTH = "  return d > reach && d <= 2 * reach ? 2 * kWideCols : kWideCols;"
_TWO_PARTS = ("  static constexpr bool kTwoParts = C::kSmem + 2 * kPart <= "
              "227 * 1024;")
_ATTR = ("      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);\n"
         "  if (err != cudaSuccess) return err;\n")
F32 = "flash_attention_f32_sm90"
SM90 = "flash_attention_sm90"
_ROUTE = ("  return d <= kSlice ? kPlain : d <= kSlice * kMaxCluster ? "
          "kCluster : kStream;")
_WHOLE = ("      C::kPair && a.unit != 16 && min(2 * a.d, C::NC * kChunkBytes) "
          "<= 146;")
# the 2-byte exchange's barriers at cluster scope: the acquiring waits
# (mbar_wait_cluster, in place of mbar_wait in `exchange`), the releasing
# remote arrives, and the n arrives spread over n threads
_REMOTE_ARRIVE = (
    "  asm volatile(\"mbarrier.arrive.shared::cluster.b64 _, [%0];\\n\" "
    "::\"r\"(addr)\n               : \"memory\");\n}\n")
_WAIT_FN = """__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\\n.reg .pred p;\\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\\n"
        "selp.u32 %0, 1, 0, p;\\n}\\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
"""
_ACQUIRE = [
    (_REMOTE_ARRIVE, _REMOTE_ARRIVE + _WAIT_FN),
    ("  if (it > 0) mbar_wait(empty, (it - 1) & 1);\n",
     "  if (it > 0) mbar_wait_cluster(empty, (it - 1) & 1);\n"),
    ("  mbar_wait(full, it & 1);\n", "  mbar_wait_cluster(full, it & 1);\n"),
    ("    mbar_wait(summed, it & 1);\n",
     "    mbar_wait_cluster(summed, it & 1);\n")]
_RELEASE = ("mbarrier.arrive.shared::cluster.b64",
            "mbarrier.arrive.release.cluster.shared::cluster.b64")
_SPREAD = ("    if (t == 0)\n"
           "      for (int r = 0; r < n; ++r) mbar_arrive_cluster(mapa(b, "
           "(uint32_t)r));\n",
           "    if (t < n) mbar_arrive_cluster(mapa(b, (uint32_t)t));\n")
VARIANTS = {
    # 2-byte K2 past d = 256: the designs not taken
    "k2b_stream": (SM90, [(_ROUTE, "  return d <= kSlice ? kPlain : "
                                   "kStream;")]),
    "k2b_cluster8": (SM90, [("constexpr int kMaxCluster = 16;",
                             "constexpr int kMaxCluster = 8;")]),
    "k2b_one_phase": (SM90, [("  if (n <= 2) {\n    for (int r = 0;",
                              "  if (true) {\n    for (int r = 0;")]),
    "k2b_cluster_scope": (SM90, _ACQUIRE + [_RELEASE]),
    "k2b_cluster_spread": (SM90, _ACQUIRE + [_RELEASE, _SPREAD]),
    "k2b_cluster_acquire": (SM90, _ACQUIRE),
    "k2b_no_exchange": (SM90, [("      if constexpr (kClu)\n        exchange",
                                "      if constexpr (false)\n        exchange")]),
    # the own loads: the designs not taken
    "k2b_single_half": (SM90, [
        ("  static constexpr bool kPair = R == kPlain && D <= 128;",
         "  static constexpr bool kPair = false;")]),
    "k2b_half_rows": (SM90, [(_WHOLE, "      false;")]),
    "k2b_pair_regs40": (SM90, [
        ("  static constexpr int kProdRegs = kPair ? 56 : 40;",
         "  static constexpr int kProdRegs = 40;"),
        ("  static constexpr int kConsRegs = kPair ? 224 : 232;",
         "  static constexpr int kConsRegs = 232;")]),
    "k2_cols128": (F32, [(_WIDTH, "  (void)reach;\n  return kWideCols;")]),
    "k2_cols256": (F32, [(_WIDTH,
                          "  (void)reach;\n  return 2 * kWideCols;")]),
    "k2_cluster16": (F32, [
        (_WIDTH, "  (void)reach;\n  return kWideCols;"),
        ("constexpr int kMaxCluster = 8;", "constexpr int kMaxCluster = 16;"),
        (_ATTR, _ATTR + "  err = cudaFuncSetAttribute(\n      kernel, "
                "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
                "  if (err != cudaSuccess) return err;\n")]),
    "k2_one_partial": (F32, [
        (_TWO_PARTS, "  static constexpr bool kTwoParts = false;")]),
    "k2_no_remote": (F32, [(_READ, _LOCAL)]),
    "k2_no_exchange": (F32, [
        (_READ, _LOCAL),
        (_ARRIVE, "    __syncthreads();\n"
                  "    pv_issue<D, BK>(o, ph, pl, v_hi, v_lo);"),
        (_READ_DONE, ""), (_TOP, "    if (resident) split_k();"),
        (_END, "\n  store_out")]),
    "k2_no_products": (F32, [
        (_PRODUCTS, "#pragma unroll\n"
                    "      for (int e = 0; e < BK / 2; ++e) sc[e] = 0.f;")]),
    "k1_one_block_a_row": ("paged_attention_sm90", [
        ("(unsigned)(chunks < 65535 ? chunks : 65535)", "1u")]),
}
PROBES = ("k2_no_remote", "k2_no_exchange", "k2_no_products",
          "k2b_no_exchange")
# K2's shapes: (B, H, S, d), causal; the probes run at the first only
K2_SHAPES = ((1, 8, 2048, 512), (1, 4, 1024, 1280), (1, 2, 512, 2304))
# the 2-byte route's: (name, B, H, S, d, causal, row padding), and the
# variants each one times (the source and the baseline at every shape)
SM90_SHAPES = (
    ("d=512 B=1 H=8 S=2048 causal", 1, 8, 2048, 512, True, 0),
    ("d=1280 B=1 H=4 S=1024 causal", 1, 4, 1024, 1280, True, 0),
    ("d=2304 B=1 H=2 S=512 causal", 1, 2, 512, 2304, True, 0),
    ("d=4096 B=1 H=2 S=512 causal", 1, 2, 512, 4096, True, 0),
    ("siglip d=72 B=8 H=16 S=729 (TMA)", 8, 16, 729, 72, False, 0),
    ("siglip d=72 rows of 73 (unit 2)", 8, 16, 729, 72, False, 1),
    ("siglip d=72 rows of 74 (unit 4)", 8, 16, 729, 72, False, 2),
    ("siglip d=72 rows of 76 (unit 8)", 8, 16, 729, 72, False, 4),
    ("d=100 B=4 H=16 S=1024 rows of 101 (unit 2)", 4, 16, 1024, 100, False,
     1),
    ("d=100 B=4 H=16 S=1024 (unit 8)", 4, 16, 1024, 100, False, 0))
SM90_AT = {"k2b_stream": lambda d, pad: d > 256,
           "k2b_cluster8": lambda d, pad: d > 2048,
           "k2b_one_phase": lambda d, pad: d > 512,
           "k2b_cluster_scope": lambda d, pad: d > 256,
           "k2b_cluster_spread": lambda d, pad: d > 256,
           "k2b_cluster_acquire": lambda d, pad: d > 256,
           "k2b_no_exchange": lambda d, pad: d > 256,
           "k2b_single_half": lambda d, pad: pad > 0 and d > 73,
           "k2b_pair_regs40": lambda d, pad: pad > 0 and d > 73,
           "k2b_half_rows": lambda d, pad: pad > 0 and d <= 73}


def variant_sources(names) -> dict:
    """{build name: (source name, text)}: each source as it is (named as
    the source) and each named variant; raises where an edit no longer
    matches its source."""
    out = {}
    for name in names:
        src, edits = VARIANTS[name]
        text = (CSRC / f"{src}.cu").read_text()
        out.setdefault(src, (src, text))
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"wide_variants: {name}'s edit no longer "
                                 f"matches the source once: {old[:60]!r}")
            text = text.replace(old, new)
        out[name] = (src, text)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--baseline-src", default=None, metavar="DIR",
                    help="time this checkout's 2-byte K2 source in turns")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("wide_variants needs a CUDA device")
    from benchmarks_torch import baselines
    from benchmarks_torch.kernel_bench import device_ms
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    texts = variant_sources(args.variants.split(","))
    OUT.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, (src, text) in texts.items():
        paths[name] = OUT / f"{src}_{name}.cu"
        paths[name].write_text(text)
    if args.baseline_src:
        texts["baseline"] = (SM90, None)
        paths["baseline"] = (Path(args.baseline_src) / "src" / "repro_torch"
                             / "csrc" / f"{SM90}.cu")
    failed = {}
    libs = baselines._libraries(paths, failed)
    for n, log in failed.items():
        print(f"{n}: nvcc failed, left out:\n{log[-4000:]}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = [f"{n} (no build)" for n in failed]

    def in_turns(runs):
        ms = {n: [] for n in runs}
        for n in [*runs, *reversed(list(runs))]:
            ms[n].append(device_ms(runs[n], 10, 5))
        return {n: sum(v) / 2 for n, v in ms.items()}

    def clusters(lib, d):
        vals = [ctypes.c_int() for _ in range(3)]
        err = lib.flash_attention_f32_sm90_clusters(
            ctypes.c_int(d), ctypes.c_int(torch.cuda.current_device()),
            *(ctypes.byref(v) for v in vals))
        if err:
            return f"occupancy query failed with CUDA error {err}"
        cols, n, active = (v.value for v in vals)
        return f"{cols} columns, {n} CTAs a cluster, at most {active} active"

    def sm90_plan(lib, d):
        vals = [ctypes.c_int() for _ in range(3)]
        err = lib.flash_attention_sm90_clusters(
            ctypes.c_int(d), ctypes.c_int(torch.cuda.current_device()),
            *(ctypes.byref(v) for v in vals))
        if err:
            return f"occupancy query failed with CUDA error {err}"
        route, n, active = (v.value for v in vals)
        return (f"route {('plain', 'cluster', 'stream')[route]}, {n} CTAs a "
                f"cluster, at most {active} active")

    # K2, float32, causal
    k2 = {n: (lib, baselines._flash_attention_sm90(F32)(lib))
          for n, lib in libs.items() if texts[n][0] == F32}
    for B, H, S, d in K2_SHAPES if k2 else ():
        x = [torch.randn(B, H, S, d, generator=gen, device="cuda")
             for _ in range(3)]
        want = attention_ref(*x, causal=True)
        runs, notes = {}, {}
        for n, (lib, f) in k2.items():
            if n in PROBES and d != K2_SHAPES[0][3]:
                continue
            try:
                err = (f(*x, causal=True) - want).abs()
            except RuntimeError as e:
                print(f"K2 f32 d={d}: {n} left out: {e}", flush=True)
                bad.append(f"{n} at d={d} (no launch)")
                continue
            ok = bool((err <= 2e-5 + 2e-4 * want.abs()).all())
            if not ok and n not in PROBES:
                bad.append(f"{n} at d={d}")
            notes[n] = (f"{clusters(lib, d)}, max|err| {float(err.max()):.1e}"
                        + (", wrong on purpose" if n in PROBES else
                           "" if ok else ", MISSES the float32 bar"))
            runs[n] = lambda f=f: f(*x, causal=True)
        ms = in_turns(runs)
        print(f"K2 f32 d={d} B={B} H={H} S={S} causal: " + ", ".join(
            f"{n} {ms[n]:.4f} ms ({notes[n]})" for n in runs), flush=True)
        del x, want

    # K2, bfloat16 and float16: the cluster route and the own loads
    k2b = {n: (lib, baselines._flash_attention_sm90(SM90)(lib))
           for n, lib in libs.items() if texts[n][0] == SM90}
    for name, B, H, S, d, causal, pad in SM90_SHAPES if k2b else ():
        for dtype, tol in ((torch.bfloat16, (2e-3, 2e-2)),
                           (torch.float16, (1e-3, 2e-3))):
            rows = torch.randn(3, B, S, H, d + pad, generator=gen,
                               device="cuda").to(dtype)[..., :d]
            x = [t.transpose(1, 2) for t in rows]
            if not pad:
                x = [t.contiguous() for t in x]
            want = attention_ref(*x, causal=causal)
            runs, notes = {}, {}
            for n, (lib, f) in k2b.items():
                if n in SM90_AT and not SM90_AT[n](d, pad):
                    continue
                try:
                    err = (f(*x, causal=causal) - want).float().abs()
                except RuntimeError as e:
                    print(f"K2 {name}: {n} left out: {e}", flush=True)
                    bad.append(f"{n} at {name} (no launch)")
                    continue
                ok = bool((err <= tol[0] + tol[1] * want.float().abs()).all())
                if not ok and n != "baseline" and n not in PROBES:
                    bad.append(f"{n} at {name} {dtype}")
                plan = ""
                if d > 256 and n != "baseline":
                    plan = f"{sm90_plan(lib, d)}, "
                notes[n] = (f"{plan}max|err| {float(err.max()):.1e}"
                            + ("" if ok else ", MISSES the bar"))
                runs[n] = lambda f=f: f(*x, causal=causal)
            ms = in_turns(runs)
            print(f"K2 {str(dtype)[6:]} {name}: " + ", ".join(
                f"{n} {ms[n]:.4f} ms ({notes[n]})" for n in runs), flush=True)
            del x, rows, want

    # K1's wide route: the wide kernel and the combine kernel apart
    def paged(B, Hq, Hkv, d, n_slots):
        def rnd(*s):
            return torch.randn(*s, generator=gen, device="cuda")
        P = 2 * B * n_slots
        lens = torch.randint(1, 16 * n_slots + 1, (B,), generator=gen,
                             device="cuda").int()
        pt = torch.randperm(P, generator=gen, device="cuda")[
            :B * n_slots].reshape(B, n_slots).int().contiguous()
        return rnd(B, Hq, d), rnd(P, Hkv, 16, d), rnd(P, Hkv, 16, d), pt, lens

    k1 = {}
    for n, lib in libs.items():
        if texts[n][0] == "paged_attention_sm90":
            fn = lib.paged_attention_sm90_launch
            fn.argtypes, fn.restype = pa.LAUNCH_ARGTYPES, ctypes.c_int
            k1[n] = fn
    for name, shape in (("d=16384 g=8 f32 B=2", (2, 8, 1, 16384, 8)),
                        ("d=2056 g=1 f32 B=4", (4, 4, 4, 2056, 8))):
        if not k1:
            break
        x = paged(*shape)
        want = paged_attention_ref(*x)
        runs = {n: (lambda fn=fn: pa._run_sm90(*x, 0.0, launcher=fn))
                for n, fn in k1.items()}
        for n, run in runs.items():
            err = (run() - want).abs()
            if not bool((err <= 2e-5 + 2e-4 * want.abs()).all()):
                raise AssertionError(f"wide_variants: {n} at {name} misses "
                                     f"the float32 bar")
        ms = in_turns(runs)
        parts = {}
        for n, run in runs.items():
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    run()
                torch.cuda.synchronize()
            split = {"wide": 0.0, "combine": 0.0}
            for e in prof.key_averages():
                for k in split:
                    if k in e.key:
                        split[k] += e.device_time_total / 20 / 1000
            parts[n] = split
        print(f"K1 wide route {name}: " + ", ".join(
            f"{n} {ms[n]:.4f} ms (wide kernel {parts[n]['wide']:.4f}, "
            f"combine {parts[n]['combine']:.4f})" for n in runs), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())
    if bad:
        raise SystemExit("wide_variants: failed: " + ", ".join(bad))


if __name__ == "__main__":
    main()
