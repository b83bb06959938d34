"""Multi-pod dry-run: trace every (arch x shape x mesh) cell's step on a
fake world of 256 or 512 ranks and count rank 0's per-chip work.

Port of ``repro/launch/dryrun.py``. The reference AOT-lowers and compiles
each cell on 256 and 512 forced host devices and reads XLA's
``cost_analysis``/``memory_analysis`` and the collectives of the
partitioned HLO. The port runs the cell's step eagerly, in one process
that is rank 0 of a ``fake`` process group (the collectives move nothing),
on meta tensors laid out as DTensors by the sharding rules, under
``roofline.CostCounter``: FLOPs, bytes and collective bytes of the local
ops, per chip. The train step is forward + backward + the AdamW update;
prefill and decode are the forward. There is no compile: ``lower_s`` is
the time to build the step and lay out its inputs, ``compile_s`` the time
of the counted trace. ``memory_analysis`` holds the local bytes of the
arguments and outputs and the peak bytes of the temporaries the counter
saw alive at once. Records go to ``experiments/dryrun_torch/``.

Eager counting sees every layer, so ``_calibrate``'s L=1/L=3
extrapolation (the reference's answer to XLA counting a scanned layer
once) equals the direct full-depth count; it is kept, and the tests hold
the two equal.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both] [--force]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.configs.base import SHAPES, RunConfig, shape_cells
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.distributed import sharding as shlib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.registry import get_model, input_specs
from repro_torch.optim import adamw
from repro_torch.roofline import analysis as roofline
from repro_torch.train import steps as steps_lib

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def fake_world(n: int) -> None:
    """Make this process rank 0 of a ``fake`` process group of ``n``
    ranks (replacing a default group of another size)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    # DTensor warns on every multi-axis reshard; the counter sees them all
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _local_bytes(tree) -> int:
    total = 0
    for t in tree_lib.leaves(tree):
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if hasattr(t, "to_local") else t
            total += loc.numel() * loc.element_size()
    return total


def _step_and_args(cfg, run, shape, mesh):
    """The cell's step and its inputs, laid out as its in-layouts."""
    bundle = get_model(cfg)
    specs = input_specs(cfg, shape)
    baxes = shlib.batch_axes(mesh, shape.global_batch) or None
    p_pl = shlib.param_shardings(bundle.axes(), cfg, mesh)
    if shape.kind == "train":
        step = steps_lib.build_train_step(cfg, run, shape, mesh)
        params = bundle.abstract_params(
            torch.bfloat16 if run.param_dtype_bf16 else torch.float32)
        opt = adamw.init(params)
        err = (tree_lib.tree_map(lambda p: torch.zeros_like(
            p, dtype=torch.float32), params)
            if run.grad_compression == "topk"
            else torch.zeros((), device="meta"))
        lay = steps_lib.in_placements(cfg, run, mesh, shape)
        args = [shlib.place(t, pl, mesh) for t, pl in
                zip((params, opt, err, specs["batch"]), lay)] + [0]
    elif shape.kind == "prefill":
        step = steps_lib.build_prefill_step(cfg, run, shape, mesh)
        args = [shlib.place(bundle.abstract_params(torch.bfloat16), p_pl,
                            mesh),
                shlib.place_one(specs["tokens"],
                                shlib.placements((baxes, None), mesh), mesh)]
        if "extra" in specs:
            args.append({k: shlib.place_one(
                v, shlib.placements((baxes, None, None), mesh), mesh)
                for k, v in specs["extra"].items()})
    else:
        step = steps_lib.build_decode_step(cfg, run, shape, mesh)
        tok = shlib.placements((baxes,), mesh)
        args = [shlib.place(bundle.abstract_params(torch.bfloat16), p_pl,
                            mesh),
                shlib.place(specs["cache"],
                            shlib.cache_shardings(cfg, mesh, shape), mesh),
                shlib.place_one(specs["token"], tok, mesh),
                shlib.place_one(specs["pos"], tok, mesh)]
    return step, args


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               run: RunConfig | None = None,
               n_layers_override: int | None = None, *,
               cfg=None, shape=None, mesh=None):
    """Trace and count one cell; returns the record dict.

    n_layers_override: calibration mode — a small variant (L=1 and L=3,
    extrapolated to full depth by ``_calibrate``). ``cfg``, ``shape`` and
    ``mesh`` replace the named arch's config, the named shape and the
    production mesh (tests use small ones)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    run = run or RunConfig(seq_len=shape.seq_len,
                           global_batch=shape.global_batch)
    if n_layers_override is not None:
        kw = {"n_layers": n_layers_override}
        if cfg.is_encoder_decoder:
            kw["n_encoder_layers"] = n_layers_override
        cfg = dataclasses.replace(cfg, **kw)
        run = run.replace(scan_layers=False)
    if mesh is None:
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    step, args = _step_and_args(cfg, run, shape, mesh)
    t_lower = time.time() - t0
    counter = roofline.CostCounter()
    with counter:
        out = step(*args)
    t_trace = time.time() - t0 - t_lower
    cost = counter.record()
    mem_rec = {"argument_size_in_bytes": _local_bytes(args),
               "output_size_in_bytes": _local_bytes(out),
               "temp_size_in_bytes": cost["peak_temp_bytes"],
               "generated_code_size_in_bytes": None}
    coll = cost["collective_bytes"]
    flops, bytes_acc = cost["flops"], cost["bytes accessed"]
    terms = roofline.roofline_terms(flops, bytes_acc,
                                    float(sum(coll.values())))
    n_chips = mesh.size()
    mf = roofline.model_flops(
        cfg.n_active_params(),
        shape.tokens if shape.kind in ("train", "prefill") else
        shape.global_batch,
        "train" if shape.kind == "train" else "serve")
    return {
        "arch": arch, "shape": shape.name,
        "mesh": "multi_pod" if multi_pod else "single_pod",
        "n_chips": n_chips,
        "kind": shape.kind,
        "lower_s": round(t_lower, 2), "compile_s": round(t_trace, 2),
        "timing_note": "no compile: lower_s builds the step and lays out "
                       "its inputs, compile_s is the counted eager trace",
        "cost_analysis": {"flops": flops, "bytes accessed": bytes_acc,
                          "n_ops": cost["n_ops"]},
        "memory_analysis": mem_rec,
        "collective_bytes": coll,
        "n_collective_ops": cost["n_collective_ops"],
        "roofline": terms,
        "model_flops_total": mf,
        "model_flops_per_chip": mf / n_chips,
        "useful_flops_ratio": (mf / n_chips) / flops if flops else None,
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
    }


def cell_path(arch: str, shape_name: str, mesh_name: str) -> Path:
    return OUT_DIR / f"{arch}__{shape_name}__{mesh_name}.json"


def _calibrate(arch: str, shape_name: str, multi_pod: bool,
               run: RunConfig | None, full_L: int, **over):
    """Per-layer cost extrapolation from L=1 / L=3 variants."""
    c1 = lower_cell(arch, shape_name, multi_pod, run=run,
                    n_layers_override=1, **over)
    c3 = lower_cell(arch, shape_name, multi_pod, run=run,
                    n_layers_override=3, **over)

    def field(rec, k):
        return float(rec["cost_analysis"].get(k, 0.0))

    out = {}
    for k in ("flops", "bytes accessed"):
        per_layer = (field(c3, k) - field(c1, k)) / 2.0
        out[k] = field(c1, k) + (full_L - 1) * per_layer
    coll = {}
    kinds = set(c1["collective_bytes"]) | set(c3["collective_bytes"])
    for kind in kinds:
        b1 = c1["collective_bytes"].get(kind, 0)
        b3 = c3["collective_bytes"].get(kind, 0)
        coll[kind] = b1 + (full_L - 1) * (b3 - b1) / 2.0
    out["collective_bytes"] = coll
    out["n_collective_ops"] = int(
        c1["n_collective_ops"] + (full_L - 1) *
        (c3["n_collective_ops"] - c1["n_collective_ops"]) / 2.0)
    out["roofline"] = roofline.roofline_terms(
        out["flops"], out["bytes accessed"], sum(coll.values()))
    return out


def run_cell(arch: str, shape_name: str, mesh_name: str, force: bool = False,
             run: RunConfig | None = None, tag: str = "",
             calibrate: bool = True):
    path = cell_path(arch, shape_name, mesh_name + (f"__{tag}" if tag else ""))
    if path.exists() and not force:
        rec = json.loads(path.read_text())
        if "error" in rec or "calibrated" in rec or not calibrate:
            print(f"[skip] {path.name} (cached)")
            return rec
    t0 = time.time()
    try:
        rec = lower_cell(arch, shape_name, mesh_name == "multi_pod", run=run)
        rec["tag"] = tag
        cfg = get_config(arch)
        if calibrate and cfg.family != "ssm":
            rec["calibrated"] = _calibrate(
                arch, shape_name, mesh_name == "multi_pod", run,
                cfg.n_layers)
        else:
            # xlstm runs its layers as a python loop in both packages: the
            # raw numbers are the full-depth ones
            rec["calibrated"] = {
                "flops": rec["cost_analysis"].get("flops", 0.0),
                "bytes accessed": rec["cost_analysis"].get(
                    "bytes accessed", 0.0),
                "collective_bytes": rec["collective_bytes"],
                "n_collective_ops": rec["n_collective_ops"],
                "roofline": rec["roofline"],
            }
        cal = rec["calibrated"]
        cal["useful_flops_ratio"] = (
            rec["model_flops_per_chip"] / cal["flops"]
            if cal.get("flops") else None)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(rec, indent=1))
        r = rec["roofline"]
        print(f"[ok] {arch} x {shape_name} x {mesh_name}"
              f" trace={rec['compile_s']:.0f}s"
              f" bound={r['bottleneck']}"
              f" terms(c/m/x)={r['compute_s']:.2e}/{r['memory_s']:.2e}/"
              f"{r['collective_s']:.2e}s", flush=True)
        return rec
    except Exception as e:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(rec, indent=1))
        print(f"[FAIL] {arch} x {shape_name} x {mesh_name}: "
              f"{type(e).__name__}: {e} ({time.time()-t0:.0f}s)", flush=True)
        return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single_pod", "multi_pod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    meshes = ["single_pod", "multi_pod"] if args.mesh == "both" else [args.mesh]
    if args.all or args.arch is None:
        cells = [(arch, s, m) for arch in ARCH_IDS
                 for s in shape_cells(arch) for m in meshes]
    else:
        shapes = [args.shape] if args.shape else list(shape_cells(args.arch))
        cells = [(args.arch, s, m) for s in shapes for m in meshes]

    ok = fail = 0
    for arch, shape_name, m in cells:
        rec = run_cell(arch, shape_name, m, force=args.force)
        if "error" in rec:
            fail += 1
        else:
            ok += 1
    print(f"\ndry-run complete: {ok} ok, {fail} failed, "
          f"{len(cells)} cells")
    raise SystemExit(1 if fail else 0)


if __name__ == "__main__":
    main()
