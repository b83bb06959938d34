"""The port's dry-run, roofline and hillclimb launchers.

In a subprocess (the ``fake`` process group of 8 ranks, a (2, 4) mesh, meta
tensors): per-chip FLOPs of a reduced dense config's prefill and decode
equal the analytic count written here (every product on rank 0's local
shards: batch over ``data``, heads, MLP and vocab over ``model``);
``_calibrate``'s L=1/L=3 extrapolation equals the direct count of the train
step (eager counting sees every layer); the record has the reference's
keys; the GPipe dry-run counts 2 * (n_micro + n_stages - 1) - 1 hand-offs
(the forward's, and the backward's but the last forward's, which nothing
uses). In process: ``roofline_terms`` (after scaling by the ratio of the
two packages' constants), ``model_flops``, hillclimb's ``_deltas`` and its
verdict rule against the reference's on the same inputs.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.roofline import analysis as jroof
from repro_torch.launch import hillclimb
from repro_torch.roofline import analysis as roof

REPO = Path(__file__).resolve().parents[1]

# the reference's record (repro/launch/dryrun.py::lower_cell)
REF_KEYS = {"arch", "shape", "mesh", "n_chips", "kind", "lower_s",
            "compile_s", "cost_analysis", "memory_analysis",
            "collective_bytes", "n_collective_ops", "roofline",
            "model_flops_total", "model_flops_per_chip",
            "useful_flops_ratio", "n_params", "n_active_params"}
REF_MEM_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes"}
CFG = dict(n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
           d_ff=128, vocab_size=256)
B, S, DATA, MODEL = 8, 32, 2, 4

SCRIPT = textwrap.dedent('''
    import json, sys
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.base import RunConfig, ShapeConfig, reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun, dryrun_pp

    CFG, B, S = %(cfg)r, %(B)d, %(S)d
    torch.set_num_threads(1)     # meta tensors: no arithmetic to share
    cfg = reduced(get_config("qwen1.5-4b"), **CFG)
    run = RunConfig(seq_len=S, global_batch=B, remat="none",
                    compute_dtype="float32")
    dryrun.fake_world(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    out = {}
    for kind in ("train", "prefill", "decode"):
        out[kind] = dryrun.lower_cell(
            "qwen1.5-4b", None, False, run=run, cfg=cfg,
            shape=ShapeConfig(kind, kind, S, B), mesh=mesh)
    out["calibrated"] = dryrun._calibrate(
        "qwen1.5-4b", None, False, run, CFG["n_layers"], cfg=cfg,
        shape=ShapeConfig("train", "train", S, B), mesh=mesh)
    gem = reduced(get_config("gemma2-2b"),
                  **dict(CFG, n_kv_heads=2, n_layers=4))
    dryrun_pp.get_config = lambda arch: gem
    dryrun_pp.SHAPES = {"train_4k": ShapeConfig("train_4k", "train", S, 32)}
    dryrun_pp.OUT_DIR = dryrun.OUT_DIR = __import__("pathlib").Path(
        sys.argv[2])
    out["pp"] = dryrun_pp.run("gemma2-2b", n_micro=4)
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
''') % dict(cfg=CFG, B=B, S=S)


@pytest.fixture(scope="module")
def recs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    (tmp / "run.py").write_text(SCRIPT)
    r = subprocess.run([sys.executable, str(tmp / "run.py"),
                        str(tmp / "out.json"), str(tmp)],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads((tmp / "out.json").read_text())


def _per_layer(T, d, hl, ff, attn):
    """Local FLOPs of one block: q, k, v, o, the two attention products,
    the three MLP products."""
    return 4 * 2 * T * d * hl + attn + 3 * 2 * T * d * ff


def test_prefill_flops_equal_the_analytic_count(recs):
    d, hd = CFG["d_model"], CFG["head_dim"]
    bl, hl = B // DATA, CFG["n_heads"] // MODEL
    ff, vl = CFG["d_ff"] // MODEL, CFG["vocab_size"] // MODEL
    T = bl * S
    attn = 2 * (2 * bl * hl * S * S * hd)
    want = CFG["n_layers"] * _per_layer(T, d, hl * hd, ff, attn) \
        + 2 * bl * d * vl                  # logits of the last position
    assert recs["prefill"]["cost_analysis"]["flops"] == want


def test_decode_flops_equal_the_analytic_count(recs):
    d, hd = CFG["d_model"], CFG["head_dim"]
    bl, hl = B // DATA, CFG["n_heads"] // MODEL
    ff, vl = CFG["d_ff"] // MODEL, CFG["vocab_size"] // MODEL
    attn = 2 * (2 * bl * hl * 1 * S * hd)  # one query over the S-long cache
    want = CFG["n_layers"] * _per_layer(bl, d, hl * hd, ff, attn) \
        + 2 * bl * d * vl
    assert recs["decode"]["cost_analysis"]["flops"] == want


def test_calibration_equals_the_direct_count(recs):
    raw, cal = recs["train"], recs["calibrated"]
    assert cal["flops"] == raw["cost_analysis"]["flops"]
    assert cal["bytes accessed"] == raw["cost_analysis"]["bytes accessed"]
    assert cal["collective_bytes"] == {k: float(v) for k, v in
                                       raw["collective_bytes"].items()}
    assert cal["n_collective_ops"] == raw["n_collective_ops"]
    assert cal["roofline"] == raw["roofline"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_record_has_the_reference_keys(recs, kind):
    rec = recs[kind]
    assert REF_KEYS <= set(rec)
    assert REF_MEM_KEYS == set(rec["memory_analysis"])
    assert rec["n_chips"] == 8 and rec["kind"] == kind
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0 and \
        mem["temp_size_in_bytes"] > 0
    if kind == "train":                      # the gradients' reductions
        assert rec["collective_bytes"].get("all-reduce", 0) > 0


def test_pipeline_dry_run_counts_the_hand_offs(recs):
    pp = recs["pp"]
    T = pp["n_micro"] + pp["n_stages"] - 1
    assert pp["n_collective_permute"] == 2 * T - 1
    assert pp["collective_bytes"]["collective-permute"] > 0
    assert pp["n_chips"] == 512 and pp["flops"] > 0


@pytest.mark.parametrize("flops,nbytes,coll", [
    (1e15, 1e9, 1e8), (1e12, 1e12, 1e8), (1e12, 1e9, 1e11), (0.0, 1e9, 0.0)])
def test_roofline_terms_match_reference(flops, nbytes, coll):
    got = roof.roofline_terms(flops, nbytes, coll)
    want = jroof.roofline_terms(flops * jroof.PEAK_FLOPS / roof.PEAK_FLOPS,
                                nbytes * jroof.HBM_BW / roof.HBM_BW,
                                coll * jroof.ICI_BW / roof.LINK_BW)
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(got[k], str):
            assert got[k] == want[k]
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12)


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_model_flops_match_reference(kind):
    assert roof.model_flops(123_456_789, 4096 * 256, kind) == \
        jroof.model_flops(123_456_789, 4096 * 256, kind)


@pytest.fixture
def jhill():
    """The reference's hillclimb module (its import sets XLA_FLAGS for
    512 host devices: put back after)."""
    old = os.environ.get("XLA_FLAGS")
    from repro.launch import hillclimb as jh
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return jh


def test_plans_keep_the_reference_cells(jhill):
    assert [(c, a, s, [(t, o) for t, _, o in steps])
            for c, a, s, steps in hillclimb.PLANS] == \
        [(c, a, s, [(t, o) for t, _, o in steps])
         for c, a, s, steps in jhill.PLANS]
    for *_, steps in hillclimb.PLANS:     # no TPU figure in a hypothesis
        for _, hyp, _ in steps:
            assert not any(u in hyp for u in ("GB/step", "s/step", "14.2s",
                                              "2.75s"))


def test_deltas_and_verdicts_match_reference(jhill, monkeypatch, tmp_path):
    """Both packages' ``run_plan`` over the same stand-in dry-run records:
    the same deltas, dominant-term change and verdict per iteration."""
    def fake_cell(arch, shape, mesh, force=False, run=None, tag="",
                  calibrate=True):
        seed = sum(map(ord, tag))
        r = np.random.RandomState(seed).uniform(0.5, 1.5, 6) if tag else \
            np.ones(6)
        terms = lambda x: roof.roofline_terms(x[0] * 1e15, x[1] * 1e12,
                                              x[2] * 1e10)
        return {"roofline": terms(r[:3]),
                "calibrated": {"roofline": terms(r[3:])}}

    monkeypatch.setattr(hillclimb.dryrun, "run_cell", fake_cell)
    monkeypatch.setattr(jhill.dryrun, "run_cell", fake_cell)
    monkeypatch.setattr(hillclimb, "PERF_DIR", tmp_path / "port")
    monkeypatch.setattr(jhill, "PERF_DIR", tmp_path / "ref")
    for cell in ("A", "B", "C", "D", "E"):
        got = hillclimb.run_plan(cell)["iterations"]
        want = jhill.run_plan(cell)["iterations"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for k in ("delta_pct", "delta_raw_pct", "judged_on",
                      "dominant_term_delta_pct", "verdict", "overrides"):
                assert g[k] == w[k], (cell, g["tag"], k)
    base = {"compute_s": 2.0, "memory_s": 4.0, "collective_s": 0.0}
    after = {"compute_s": 1.0, "memory_s": 5.0, "collective_s": 3.0}
    assert hillclimb._deltas(base, after) == jhill._deltas(base, after)
    for x in (-20.0, -5.0, -4.9, 0.0, 3.0):
        assert hillclimb.verdict(x) == (
            "confirmed" if x < -5.0 else "partial" if x < 0 else "refuted")
