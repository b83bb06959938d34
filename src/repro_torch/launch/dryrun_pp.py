"""Pipeline-parallel dry-run: GPipe over the `pod` axis at 512 ranks.

Port of ``repro/launch/dryrun_pp.py``: the third parallelism dimension
composes. Stages on pods (the slowest links carry the least traffic), the
embedding and head sharded over ``model`` and the batch over ``data``, a
microbatched fill-drain schedule, the full backward through the hand-offs.
As in the reference, the pipeline region holds its stage whole on every
rank of a pod (its ``shard_map`` gives the params and x no other axis).
Runs on the fake 512-rank world on meta tensors and counts rank 0's work
(``roofline.CostCounter``); ``n_collective_permute`` counts its hand-offs
(the forward's and the backward's point-to-point sends).

  PYTHONPATH=src python -m repro_torch.launch.dryrun_pp [--arch gemma2-2b]
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import tree as tree_lib
from repro_torch.configs.base import SHAPES, RunConfig
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.pipeline import gpipe_apply, split_layers_to_stages
from repro_torch.launch.dryrun import OUT_DIR, fake_world
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm as lm_lib
from repro_torch.models.common import rms_norm, softmax_xent
from repro_torch.models.registry import get_model
from repro_torch.roofline import analysis as roofline
from repro_torch.train.steps import value_and_grad


def run(arch: str = "gemma2-2b", n_micro: int = 4, n_stages: int = 2):
    """Trace and count one GPipe train step (loss and gradients); returns
    the record (also written to ``experiments/dryrun_torch/``)."""
    cfg = get_config(arch)
    shape = SHAPES["train_4k"]
    run_cfg = RunConfig(seq_len=shape.seq_len,
                        global_batch=shape.global_batch)
    fake_world(512)
    mesh = make_production_mesh(multi_pod=True)
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers not divisible by "
                         f"{n_stages} stages")
    bundle = get_model(cfg)
    windows = lm_lib.layer_windows(cfg).reshape(n_stages, -1)
    rep = shlib.replicated(mesh)

    def stage_fn(p_stack, h):
        sidx = mesh.get_local_rank("pod")
        for i in range(cfg.n_layers // n_stages):
            h, _, _ = lm_lib.apply_block(lm_lib._layer(p_stack, i), cfg,
                                         run_cfg, h,
                                         window=int(windows[sidx, i]))
        return h

    def pp_loss(params, batch):
        x = lm_lib._embed(params, cfg, run_cfg, batch)
        staged = split_layers_to_stages(params["blocks"], n_stages)
        staged = tree_lib.tree_map(lambda a: shlib.place_one(
            a, shlib.placements(("pod",) + (None,) * (a.dim() - 1), mesh),
            mesh), staged)
        xl = shlib.to_local(shlib.place_one(x, rep, mesh))
        y = gpipe_apply(stage_fn, staged, xl, n_micro, mesh, axis="pod")
        y = shlib.from_local(y, mesh, rep)
        y = rms_norm(y, params["lm"]["final_norm"], cfg.norm_eps)
        return softmax_xent(lm_lib._unembed(params, cfg, y), batch["labels"])

    B, S = shape.global_batch, shape.seq_len
    b_pl = shlib.placements(("data", None), mesh)
    t0 = time.time()
    params = shlib.place(bundle.abstract_params(torch.float32),
                         shlib.param_shardings(bundle.axes(), cfg, mesh),
                         mesh)
    batch = {k: shlib.place_one(torch.empty((B, S), dtype=torch.int32,
                                            device="meta"), b_pl, mesh)
             for k in ("tokens", "labels")}
    counter = roofline.CostCounter()
    with counter, implicit_replication():
        value_and_grad(pp_loss, params, batch)
    cost = counter.record()
    rec = {
        "arch": arch, "mode": "pipeline_pod2_x_tp16_x_dp16",
        "n_chips": 512, "n_stages": n_stages, "n_micro": n_micro,
        "compile_s": round(time.time() - t0, 1),
        "timing_note": "no compile: compile_s is the counted eager trace",
        "flops": cost["flops"],
        "bytes accessed": cost["bytes accessed"],
        "collective_bytes": cost["collective_bytes"],
        "n_collective_permute": counter.n_by_kind.get("collective-permute",
                                                      0),
        "roofline": roofline.roofline_terms(
            cost["flops"], cost["bytes accessed"],
            float(sum(cost["collective_bytes"].values()))),
    }
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / f"PP__{arch}__train_4k__multi_pod.json").write_text(
        json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--n-micro", type=int, default=4)
    args = ap.parse_args(argv)
    rec = run(args.arch, args.n_micro)
    print(f"[ok] PP dry-run {args.arch}: 2 stages x 16 TP x 16 DP = 512 "
          f"ranks, trace {rec['compile_s']}s, "
          f"{rec['n_collective_permute']} collective-permutes")


if __name__ == "__main__":
    main()
