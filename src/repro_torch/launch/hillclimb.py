"""Perf hillclimb: hypothesis -> change -> re-trace -> record.

Port of ``repro/launch/hillclimb.py``. Each iteration re-traces a cell with
one RunConfig knob flipped (``dryrun.run_cell``, the port's per-chip
counts) and records the calibrated roofline-term deltas against the cell's
baseline into ``experiments/perf_torch/cell_<id>.json``. The plans keep the
reference's cells, tags and overrides; each hypothesis says which term the
knob should move and which way. The numbers are the port's own, in the
records.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb [--cell A|B|C|D|E|all]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.configs.base import SHAPES, RunConfig
from repro_torch.launch import dryrun

PERF_DIR = Path(__file__).resolve().parents[3] / "experiments" / "perf_torch"

# (cell_id, arch, shape, [(tag, hypothesis, run_overrides)...])
PLANS = [
    ("A", "gemma2-2b", "train_4k", [
        ("reshard_attn",
         "8 q-heads < 16-way TP leave attention replicated over `model`: "
         "every model rank computes all heads. Respreading the batch over "
         "(data, model) for the attention op makes it pure data parallel: "
         "predict the compute and memory terms fall by about the replicated "
         "attention share, at the cost of two activation reshards per "
         "layer (the collective term rises).",
         {"attn_batch_reshard": True}),
        ("remat_dots",
         "remat='full' recomputes the whole forward in the backward. Policy "
         "'dots' saves the matmul outputs: predict the compute term falls "
         "and the memory term rises by the saved activations.",
         {"remat": "dots"}),
        ("reshard_attn+dots",
         "Compose both if they move independent terms.",
         {"attn_batch_reshard": True, "remat": "dots"}),
        ("pad_heads",
         "The alternative to the reshard: pad q-heads 8->16 so attention "
         "shards over `model` with no extra collective, at twice the "
         "attention FLOPs (padded heads attend to zeros). Predict the "
         "memory term near the reshard variant's and the collective term "
         "back near the baseline's.",
         {"attn_pad_heads": True}),
        ("pad_heads+dots",
         "Compose head padding with the remat policy (judge the remat part "
         "on the raw terms).",
         {"attn_pad_heads": True, "remat": "dots"}),
    ]),
    ("B", "command-r-plus-104b", "decode_32k", [
        ("cache_anchor",
         "8 kv heads < 16-way TP put the cache's sequence over `model`; a "
         "cache update whose layout does not match it can regather the "
         "whole cache every layer. Anchoring the updated cache to its own "
         "layout reshards the one-token operand instead: predict the "
         "collective term falls (it cannot rise).",
         {"decode_cache_anchor": True}),
        ("grouped_kv",
         "Decode expands KV 8->96 heads before the attention products, so "
         "the dominant traffic (the 32k-token cache) is read 12 times per "
         "step. The grouped-query form reads it once: predict the memory "
         "term falls toward the cache size over the HBM rate.",
         {"decode_grouped": True}),
        ("anchor+grouped",
         "Compose: once the collectives are gone the grouped read should "
         "move the dominant term.",
         {"decode_cache_anchor": True, "decode_grouped": True}),
        ("grouped+slim",
         "For a single query the kv_len mask subsumes causality: dropping "
         "the causal compare over (B, 32k) per layer should cut the memory "
         "term a little more.",
         {"decode_grouped": True, "decode_slim_mask": True,
          "decode_cache_anchor": True}),
    ]),
    ("C", "qwen1.5-110b", "train_4k", [
        ("zero1",
         "The optimizer state (two f32 moments of every param) dominates "
         "per-chip memory traffic; ZeRO-1 shards the moments over `data` "
         "(16x): predict the memory term falls by about the moment-update "
         "share, the collective bytes roughly unchanged (a reduce-scatter "
         "and an all-gather replace part of the all-reduce).",
         {"zero1": True}),
        ("remat_dots",
         "remat='full' recomputes each block in the backward; 'dots' saves "
         "the matmul outputs: predict the compute term falls. Judged on the "
         "raw terms, as the reference judges it.",
         {"remat": "dots"}),
        ("bf16_master",
         "bf16 master params and moments halve the param and moment "
         "traffic: predict the memory term falls by about the optimizer's "
         "share of it.",
         {"param_dtype_bf16": True}),
    ]),
    # D: the reference's worst roofline fraction (whisper train)
    ("D", "whisper-large-v3", "train_4k", [
        ("pad_heads",
         "whisper's 20 heads (MHA) do not divide TP16, so its self- and "
         "cross-attention replicate over `model`. Padding 20->32 heads "
         "shards attention 16 ways at 1.6x the attention FLOPs: predict the "
         "memory and compute terms fall.",
         {"attn_pad_heads": True}),
        ("pad_heads+dots",
         "Compose head padding with the lighter remat policy (judged on the "
         "raw terms).",
         {"attn_pad_heads": True, "remat": "dots"}),
    ]),
    # E: the other decode cell whose kv heads do not divide TP: the knobs
    # found in cell B should carry over
    ("E", "llava-next-mistral-7b", "decode_32k", [
        ("grouped_kv",
         "llava (mistral backbone, kv=8 < TP16) has cell B's layout; its "
         "knobs should carry over: predict the memory term falls toward the "
         "cache read and the collective term does not rise.",
         {"decode_grouped": True, "decode_slim_mask": True}),
    ]),
]


def _raw_terms(rec):
    return rec["roofline"]


def _deltas(base, after):
    return {k: (after[k] / base[k] - 1.0) * 100.0
            for k in ("compute_s", "memory_s", "collective_s")
            if base.get(k, 0) > 0}


def verdict(dom_delta: float) -> str:
    """The reference's rule on the dominant term's change (%)."""
    return "confirmed" if dom_delta < -5.0 else (
        "partial" if dom_delta < 0 else "refuted")


def run_plan(cell_id: str):
    plan = next(p for p in PLANS if p[0] == cell_id)
    _, arch, shape_name, steps = plan
    shape = SHAPES[shape_name]
    base_rec = dryrun.run_cell(arch, shape_name, "single_pod")
    base = base_rec["calibrated"]["roofline"]
    base_raw = _raw_terms(base_rec)
    log = {"cell": cell_id, "arch": arch, "shape": shape_name,
           "baseline": base, "baseline_raw": base_raw, "iterations": []}
    print(f"[{cell_id}] baseline {arch} x {shape_name}: "
          f"c/m/x = {base['compute_s']:.3e}/{base['memory_s']:.3e}/"
          f"{base['collective_s']:.3e} bound={base['bottleneck']}")
    for tag, hypothesis, overrides in steps:
        run = RunConfig(seq_len=shape.seq_len,
                        global_batch=shape.global_batch, **overrides)
        rec = dryrun.run_cell(arch, shape_name, "single_pod", run=run,
                              tag=tag, force=False)
        if "error" in rec:
            log["iterations"].append({"tag": tag, "hypothesis": hypothesis,
                                      "error": rec["error"]})
            print(f"[{cell_id}/{tag}] FAILED: {rec['error']}")
            continue
        after = rec["calibrated"]["roofline"]
        after_raw = _raw_terms(rec)
        deltas = _deltas(base, after)
        deltas_raw = _deltas(base_raw, after_raw)
        dom = base["bottleneck"] + "_s"
        # remat-style changes are judged on the raw terms, as the reference
        # does (its calibration variants CSE the recompute away)
        use_raw = "remat" in str(overrides)
        dd = deltas_raw if use_raw else deltas
        dom_delta = dd.get(dom, 0.0)
        v = verdict(dom_delta)
        log["iterations"].append({
            "tag": tag, "hypothesis": hypothesis, "overrides": overrides,
            "after": after, "after_raw": after_raw, "delta_pct": deltas,
            "delta_raw_pct": deltas_raw, "judged_on":
                "raw" if use_raw else "calibrated",
            "dominant_term_delta_pct": dom_delta, "verdict": v,
        })
        print(f"[{cell_id}/{tag}] c/m/x = {after['compute_s']:.3e}/"
              f"{after['memory_s']:.3e}/{after['collective_s']:.3e} "
              f"dominant({base['bottleneck']}) {dom_delta:+.1f}% -> {v}")
    PERF_DIR.mkdir(parents=True, exist_ok=True)
    (PERF_DIR / f"cell_{cell_id}.json").write_text(json.dumps(log, indent=1))
    return log


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="all",
                    choices=["A", "B", "C", "D", "E", "all"])
    args = ap.parse_args(argv)
    cells = ["A", "B", "C", "D", "E"] if args.cell == "all" else [args.cell]
    for c in cells:
        run_plan(c)


if __name__ == "__main__":
    main()
