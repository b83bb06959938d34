"""Variants of K1's mma route, timed in turns against the source as it is.

  python3 benchmarks_torch/paged_variants.py [--variants NAME,...]

Each variant is ``csrc/paged_attention_sm90.cu`` with a few textual edits
(``VARIANTS``), built with the port's nvcc flags beside the source itself
(one nvcc each, all at once; ``baselines._libraries``). At the GQA and MQA
widths of ``chip_smoke.PAGED_GROUP_SHAPES`` with g >= 8 (B=32, page 16, 36
slots, random lengths from seed 0, bf16 and f32) every build runs the mma
route through the wrapper's launch (``ops._run_sm90`` with
``ops.mma_tile_rows``): its max |error| against ``ref.py``, then device ms
per call from CUDA-graph replays, the builds in one order and then in the
reverse one, the mean of the two. Two variants are timing probes that give
wrong results on purpose: ``no_products`` skips every unit's products and
softmax (what the pipeline costs alone) and ``no_conflicts`` reads K and V
at a padded row stride (what the shared-memory bank conflicts cost). The
others change the design and must stay within the type's bar.

Prints one line per shape and type, and the card's name and power limit.
Needs a CUDA device and the CUDA toolkit.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "csrc" / "paged_attention_sm90.cu"
OUT = ROOT / "build" / "variants"

_UNIT = "for (int j = rb < rows ? j0 : nu; j < nu; j += n_kg) {"
_BOUNDS = ("__launch_bounds__(kThreads, (mma_min_blocks<T, D, MW>()))\n"
           "paged_attention_sm90_mma_kernel")
_QVEC = ("if (reinterpret_cast<uintptr_t>(p.q) % 16 == 0 && "
         "d * ELT % 16 == 0) {")
VARIANTS = {
    # the register route's ring: 4 stages, about 32 KiB
    "ring_32k": [("constexpr int kMmaMaxStages = 8;",
                  "constexpr int kMmaMaxStages = 4;"),
                 ("constexpr int kMmaRingBytes = 65536;",
                  "constexpr int kMmaRingBytes = 32768;")],
    # q loaded one element at a time
    "scalar_q": [(_QVEC, "if (false) {")],
    # one block a SM as the only launch bound (registers uncapped)
    "one_block": [(_BOUNDS, _BOUNDS.replace(
        "(mma_min_blocks<T, D, MW>())", "1"))],
    # timing probes, wrong results
    "no_products": [(_UNIT, _UNIT.replace("rb < rows ? j0 : nu", "nu"))],
    "no_conflicts": [("kt + key * rs", "kt + key * (rs + 16)"),
                     ("vt + (k0 + e) * rs", "vt + (k0 + e) * (rs + 16)"),
                     ("ld_u16(vc + k * rs)", "ld_u16(vc + k * (rs + 16))"),
                     ("ld_u16(vc + (k + 1) * rs)",
                      "ld_u16(vc + (k + 1) * (rs + 16))")],
}
PROBES = ("no_products", "no_conflicts")
SHAPES = {"qwen3-235b-a22b 64/4 d128": (64, 4, 128),
          "mistral-large-2 96/8 d128": (96, 8, 128),
          "starcoder MQA 48/1 d128": (48, 1, 128),
          "falcon-7b MQA 71/1 d64": (71, 1, 64),
          "qwen1.5-110b 64/8 d128": (64, 8, 128)}
B, PAGE, SLOTS, POOL = 32, 16, 36, 2048


def variant_sources(names) -> dict:
    """The source as it is ("source") and each named variant's text; raises
    where an edit no longer matches the source."""
    src = SRC.read_text()
    out = {"source": src}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise ValueError(f"paged_variants: {name}'s edit no longer "
                                 f"matches the source: {old[:60]!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("paged_variants needs a CUDA device")
    from benchmarks_torch import baselines
    from benchmarks_torch.kernel_bench import device_ms
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    texts = variant_sources(args.variants.split(","))
    OUT.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, text in texts.items():
        paths[name] = OUT / f"paged_attention_sm90_{name}.cu"
        paths[name].write_text(text)
    launch = {}
    for name, lib in baselines._libraries(paths).items():
        fn = lib.paged_attention_sm90_launch
        fn.argtypes, fn.restype = ops.LAUNCH_ARGTYPES, ctypes.c_int
        launch[name] = fn
    gen = torch.Generator(device="cuda").manual_seed(0)
    tol = {torch.float32: (2e-5, 2e-4), torch.bfloat16: (2e-3, 2e-2)}
    for shape, (Hq, Hkv, d) in SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            def rnd(*s):
                return torch.randn(*s, generator=gen, device="cuda").to(dtype)
            lens = torch.randint(1, PAGE * SLOTS + 1, (B,), generator=gen,
                                 device="cuda").int()
            pt = torch.randperm(POOL, generator=gen, device="cuda")[
                :B * SLOTS].reshape(B, SLOTS).int().contiguous()
            x = (rnd(B, Hq, d), rnd(POOL, Hkv, PAGE, d),
                 rnd(POOL, Hkv, PAGE, d), pt, lens)
            rows = ops.mma_tile_rows(Hq // Hkv)
            want = paged_attention_ref(*x).float()
            runs = {n: (lambda fn=fn: ops._run_sm90(*x, 0.0, launcher=fn,
                                                    rows=rows))
                    for n, fn in launch.items()}
            errs = {}
            for n, run in runs.items():
                err = (run().float() - want).abs()
                ok = bool((err <= tol[dtype][0]
                           + tol[dtype][1] * want.abs()).all())
                if not ok and n not in PROBES:
                    raise AssertionError(f"paged_variants: {n} at {shape} "
                                         f"{dtype} misses the bar")
                errs[n] = float(err.nan_to_num(float("inf")).max())
            ms = {n: [] for n in runs}
            for n in [*runs, *reversed(list(runs))]:
                ms[n].append(device_ms(runs[n], 10, 5))
            print(f"{shape} {str(dtype)[6:]}: " + ", ".join(
                f"{n} {sum(v) / 2:.4f} ms (max|err| {errs[n]:.1e})"
                for n, v in ms.items()), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())


if __name__ == "__main__":
    main()
