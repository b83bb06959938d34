"""The port's sharded paths on gloo ranks (one process per rank, a
``FileStore`` under ``tmp_path``, all in subprocesses) against the JAX
reference's one-device functions on the same inputs:

* the expert-parallel MoE on (data 2, model 4) against ``moe_apply(mesh=
  None)``, at tests/test_distribution.py's bar (atol=2e-4, rtol=2e-3); its
  aux against the mean of the reference's aux over the two data shards
  (the per-data-shard semantics of the reference's EP path), at the f32 bar;
* three sharded train steps of reduced qwen on (2, 4) with ZeRO-1 off and
  on (2, 2) with it on, and of reduced moonshot (expert parallel) on
  (2, 4), against the reference's
  one-device step: losses at the f32 bar (atol=2e-5, rtol=2e-4), params at
  the same rtol and atol 2e-5 + 0.1 lr per update (tests/test_torch_train.py
  says why). For moonshot the batch's two data halves are equal and the
  capacity factor leaves no token dropped, so the sharded step (aux and
  capacity per data shard, as the reference's EP path) computes the same
  function as the one-device step;
* Mamba's selective scan in its local region on (2, 2) (batch over
  ``data``, the inner dim over ``model``): outputs and the gradients of
  every input against the plain scan (itself held against the reference
  in tests/test_torch_ssm.py), at the f32 bar;
* ``attn_pad_heads`` and ``attn_batch_reshard`` on
  tests/test_distribution.py's gemma2 config (3 heads, model 4): the loss
  equals the one-device reference loss within that test's 1e-4;
* decode with ``decode_cache_anchor`` equals decode without it, and both
  (and the sharded prefill) the reference's one-device logits at
  tests/test_torch_lm.py's bar (atol=2e-4, rtol=2e-3);
* elastic restore: the Trainer saves under 4 ranks and resumes under 2 for
  two more steps; a checkpoint the reference's Trainer wrote resumes in the
  sharded port, whose next two losses equal the reference's own (f32 bar).
"""
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.checkpoint import checkpointer as jckpt
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import reduced as jreduced
from repro.configs.registry import get_config as jget_config
from repro.launch.mesh import make_local_mesh
from repro.models import moe as jmoe
from repro.models.registry import get_model as jget_model
from repro.optim import adamw as jadamw
from repro.train import steps as jsteps
from repro.train import trainer as jtrainer

REPO = Path(__file__).resolve().parents[1]
TOL = dict(atol=2e-5, rtol=2e-4)
EP_TOL = dict(atol=2e-4, rtol=2e-3)       # tests/test_distribution.py
LM_TOL = dict(atol=2e-4, rtol=2e-3)       # tests/test_torch_lm.py
LR = 1e-3
B, S = 8, 16
STEP_KW = dict(compute_dtype="float32", lr=LR, warmup_steps=1,
               total_steps=10, remat="none")
KNOB_CFG = dict(n_layers=2, d_model=48, n_heads=3, n_kv_heads=1,
                head_dim=16, d_ff=96, vocab_size=128)
MOE_CFG = dict(n_layers=2, capacity_factor=4.0)

SCRIPT = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import tree as tree_lib
    from repro_torch.configs.base import RunConfig, ShapeConfig, reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding as shlib
    from repro_torch.distributed import world
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe
    from repro_torch.models.registry import get_model
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    from repro_torch.train.trainer import Trainer

    STEP_KW = %(step_kw)r
    KNOB_CFG, MOE_CFG, B, S = %(knob)r, %(moe)r, %(B)d, %(S)d

    def tree_from(d, prefix, cfg):
        t = get_model(cfg).abstract_params()
        return tree_lib.unflatten(t, [torch.from_numpy(d[prefix + k])
                                      for k, _ in tree_lib.flatten_with_path(t)])

    def mesh_of(data, model):
        return init_device_mesh("cpu", (data, model),
                                mesh_dim_names=("data", "model"))

    def train(d, res, name, cfg, run, mesh, batches):
        """``len(batches)`` sharded steps from the reference's weights."""
        shape = ShapeConfig("t", "train", S, B)
        fn = steps.build_train_step(cfg, run, shape, mesh)
        params = tree_from(d, "p/" + name + "/", cfg)
        opt, err = adamw.init(params), torch.zeros(())
        losses = []
        for i, b in enumerate(batches):
            params, opt, err, m = fn(params, opt, err, b, i)
            losses.append(float(m["loss"]))
        res["loss/" + name] = np.array(losses)
        for k, v in tree_lib.flatten_with_path(shlib.full(params)):
            res["out/" + name + "/" + k] = v.numpy()

    def batches_of(d, name):
        return [{"tokens": torch.from_numpy(d[f"b/{name}/{i}/tokens"]),
                 "labels": torch.from_numpy(d[f"b/{name}/{i}/labels"])}
                for i in range(3)]

    def world8(rank, d, res):
        mesh = mesh_of(2, 4)
        # expert-parallel MoE
        cfg = reduced(get_config("moonshot-v1-16b-a3b"), n_experts=8)
        p = {k: torch.from_numpy(d["moe/" + k]) for k in moe.moe_defs(cfg)}
        with implicit_replication():
            y, aux = moe.moe_apply(torch.from_numpy(d["moe_x"]), p, cfg,
                                   RunConfig(compute_dtype="float32"), mesh)
        res["moe_y"], res["moe_aux"] = y.full_tensor().numpy(), \\
            aux.full_tensor().numpy()
        qwen = reduced(get_config("qwen1.5-4b"), n_layers=2)
        train(d, res, "qwen_z0_24", qwen, RunConfig(**STEP_KW), mesh,
              batches_of(d, "qwen"))
        train(d, res, "moonshot_24",
              reduced(get_config("moonshot-v1-16b-a3b"), **MOE_CFG),
              RunConfig(**STEP_KW), mesh, batches_of(d, "moonshot"))
        # the mesh knobs on gemma2 with 3 heads
        gem = reduced(get_config("gemma2-2b"), **KNOB_CFG)
        params = shlib.place(tree_from(d, "p/gemma/", gem),
                             shlib.param_shardings(get_model(gem).axes(),
                                                   gem, mesh), mesh)
        toks = torch.from_numpy(d["gemma_toks"])
        bpl = shlib.placements(("data", None), mesh)
        batch = {k: shlib.place_one(toks, bpl, mesh)
                 for k in ("tokens", "labels")}
        base = RunConfig(compute_dtype="float32", remat="none")
        for knob in ("none", "attn_pad_heads", "attn_batch_reshard"):
            run = base if knob == "none" else base.replace(**{knob: True})
            with implicit_replication():
                loss = get_model(gem).train_loss(params, run, batch,
                                                 mesh=mesh,
                                                 batch_axes=("data",))
            res["knob/" + knob] = loss.full_tensor().numpy()
        # sharded prefill, then decode with and without the cache anchor
        shape = ShapeConfig("p", "prefill", 16, B)
        lg, cache, lens = steps.build_prefill_step(gem, base, shape, mesh)(
            params, toks[:, :15])
        res["prefill"] = lg.full_tensor().numpy()
        for anchor in (False, True):
            run = base.replace(decode_cache_anchor=anchor)
            lg2, _ = steps.build_decode_step(gem, run, shape, mesh)(
                params, cache, toks[:, 15], lens)
            res[f"decode/{int(anchor)}"] = lg2.full_tensor().numpy()

    def scan_check(res):
        """Mamba's scan in its local region against the plain scan."""
        from repro_torch.distributed import regions
        from repro_torch.models.ssm import selective_scan
        mesh = mesh_of(2, 2)
        g = torch.Generator().manual_seed(0)
        B_, S_, di, N = 4, 12, 8, 4
        shapes = {"u": (B_, S_, di), "dt": (B_, S_, di), "A": (di, N),
                  "Bc": (B_, S_, N), "Cc": (B_, S_, N), "h0": (B_, di, N)}
        x = {k: torch.randn(s, generator=g) * (0.1 if k == "dt" else 1.0)
             for k, s in shapes.items()}
        x["A"] = -x["A"].abs()
        spec = {"u": ("data", None, "model"), "dt": ("data", None, "model"),
                "A": ("model", None), "Bc": ("data", None, None),
                "Cc": ("data", None, None), "h0": ("data", "model", None)}
        outs = {}
        for mode in ("plain", "region"):
            leaves = {k: v.clone().requires_grad_() for k, v in x.items()}
            if mode == "plain":
                y, h = selective_scan(*leaves.values())
            else:
                args = [shlib.place_one(leaves[k],
                                        shlib.placements(spec[k], mesh), mesh)
                        for k in shapes]
                y, h = regions.selective_scan(selective_scan, *args)
                y, h = y.full_tensor(), h.full_tensor()
            (y.square().sum() + h.square().sum()).backward()
            outs[mode] = [y.detach(), h.detach()] + [
                leaves[k].grad for k in shapes]
        for mode, ts in outs.items():
            res["scan/" + mode] = np.concatenate([t.numpy().ravel()
                                                  for t in ts])
        res["scan/max_err"] = np.array(max(
            float((a - b).abs().max() / (1 + b.abs().max()))
            for a, b in zip(outs["region"], outs["plain"])))

    def world4(rank, d, res):
        scan_check(res)
        qwen = reduced(get_config("qwen1.5-4b"), n_layers=2)
        train(d, res, "qwen_z1_22", qwen, RunConfig(zero1=True, **STEP_KW),
              mesh_of(2, 2), batches_of(d, "qwen"))
        tr = Trainer(qwen, RunConfig(**STEP_KW), make_local_mesh(data=4),
                     ShapeConfig("t", "train", S, B), ckpt_dir=d["dir"],
                     ckpt_every=2, device="cpu")
        st = tr.train(2)
        res["elastic_saved_step"] = np.array(st.step)

    def world2(rank, d, res):
        qwen = reduced(get_config("qwen1.5-4b"), n_layers=2)
        mesh = make_local_mesh(data=2)
        for key in ("dir", "jdir"):
            tr = Trainer(qwen, RunConfig(**STEP_KW), mesh,
                         ShapeConfig("t", "train", S, B), ckpt_dir=d[key],
                         ckpt_every=10, device="cpu")
            st = tr.maybe_restore()
            res[key + "/restored"] = np.array(st.step)
            lead = tree_lib.leaves(st.params)[0]
            res[key + "/placements"] = np.array(str(lead.placements))
            st = tr.train(2, state=st)
            res[key + "/step"] = np.array(st.step)
            res[key + "/losses"] = np.array(
                [m["loss"] for m in tr.metrics_log])

    def entry(rank, n, task, inp, out):
        torch.set_num_threads(1)     # n ranks share the cores with pytest's
        d = dict(np.load(inp))
        d["dir"], d["jdir"] = str(d["dir"]), str(d["jdir"])
        res = {}
        globals()[task](rank, d, res)
        if rank == 0:
            np.savez(out, **res)

    if __name__ == "__main__":
        task, n, inp, out, store = sys.argv[1:]
        world.spawn(entry, int(n), store, args=(task, inp, out))
''') % dict(step_kw=STEP_KW, knob=KNOB_CFG, moe=MOE_CFG, B=B, S=S)


def _run(tmp, task, n, inputs):
    script = tmp / "run_dist.py"
    script.write_text(SCRIPT)
    inp, out = tmp / f"{task}_in.npz", tmp / f"{task}_out.npz"
    np.savez(inp, **inputs)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    r = subprocess.run([sys.executable, str(script), task, str(n), str(inp),
                        str(out), str(tmp / f"{task}.store")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(out))


def _jparams(jcfg):
    jp = jget_model(jcfg).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(7),
                                               a.shape), jp)


def _batches(vocab, seed, halves_equal=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(3):
        t = rng.randint(0, vocab, (B, S + 1)).astype(np.int32)
        if halves_equal:
            t[B // 2:] = t[:B // 2]
        out.append({"tokens": t[:, :-1].copy(), "labels": t[:, 1:].copy()})
    return out


def _ref_train(jcfg, jp, batches):
    """The reference's one-device step over ``batches``: (losses, the
    final params by path)."""
    fn, _ = jsteps.build_train_step(jcfg, JRunConfig(**STEP_KW),
                                    make_local_mesh(),
                                    JShapeConfig("t", "train", S, B))
    fn = jax.jit(fn)
    opt, err, losses = jadamw.init(jp), jnp.zeros(()), []
    for i, b in enumerate(batches):
        jp, opt, err, m = fn(jp, opt, err,
                             {k: jnp.asarray(v) for k, v in b.items()},
                             jnp.int32(i))
        losses.append(float(m["loss"]))
    return np.array(losses), jckpt._flatten(jp)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    inputs, ref = {}, {}
    # expert-parallel MoE (tests/test_distribution.py's inputs)
    mcfg = jreduced(jget_config("moonshot-v1-16b-a3b"), n_experts=8)
    rng = np.random.RandomState(0)
    p = {k: (rng.randn(*d.shape) * 0.05).astype(np.float32)
         for k, d in jmoe.moe_defs(mcfg).items()}
    x = rng.randn(4, 8, mcfg.d_model).astype(np.float32)
    inputs["moe_x"] = x
    inputs.update({"moe/" + k: v for k, v in p.items()})
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    run = JRunConfig(compute_dtype="float32")
    ref["moe_y"], aux = jmoe.moe_apply(jnp.asarray(x), jp, mcfg, run)
    ref["moe_aux_shards"] = np.mean(
        [float(jmoe.moe_apply(jnp.asarray(x[i:i + 2]), jp, mcfg, run)[1])
         for i in (0, 2)])
    # train cases
    for name, jcfg, halves in (
            ("qwen", jreduced(jget_config("qwen1.5-4b"), n_layers=2), False),
            ("moonshot", jreduced(jget_config("moonshot-v1-16b-a3b"),
                                  **MOE_CFG), True)):
        jp = _jparams(jcfg)
        batches = _batches(jcfg.vocab_size, 1, halves)
        for i, b in enumerate(batches):
            for k, v in b.items():
                inputs[f"b/{name}/{i}/{k}"] = v
        flat = jckpt._flatten(jp)
        keys = (["qwen_z0_24", "qwen_z1_22"] if name == "qwen"
                else [name + "_24"])
        for key in keys:
            inputs.update({f"p/{key}/{k}": v for k, v in flat.items()})
        ref[name] = _ref_train(jcfg, jp, batches)
    # knobs and decode (tests/test_distribution.py's gemma2)
    gcfg = jreduced(jget_config("gemma2-2b"), **KNOB_CFG)
    gb = jget_model(gcfg)
    gp = gb.init(jax.random.PRNGKey(0))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, 16), 0,
                                         128), np.int32)
    inputs["gemma_toks"] = toks
    inputs.update({"p/gemma/" + k: v for k, v in jckpt._flatten(gp).items()})
    base = JRunConfig(compute_dtype="float32", remat="none")
    ref["knob"] = float(gb.train_loss(gp, base, {"tokens": toks,
                                                 "labels": toks}))
    cache = gb.init_cache(B, 16)        # bf16, as build_prefill_step's
    ref["prefill"], c2, lens = gb.prefill(gp, base, cache, toks[:, :15])
    ref["decode"], _ = gb.decode_step(gp, base, c2, toks[:, 15], lens)
    # the reference Trainer's checkpoint at step 2, and its next two losses
    # (the checkpoint is lossless, so running on equals resuming from it)
    qcfg = jreduced(jget_config("qwen1.5-4b"), n_layers=2)
    jdir = tmp / "jckpt"
    jtr = jtrainer.Trainer(qcfg, JRunConfig(**STEP_KW), make_local_mesh(),
                           JShapeConfig("t", "train", S, B),
                           ckpt_dir=str(jdir), ckpt_every=2)
    jtr.train(4)
    shutil.rmtree(jdir / "step_00000004")
    ref["jdir_losses"] = np.array([m["loss"] for m in jtr.metrics_log[2:]])
    inputs["dir"], inputs["jdir"] = str(tmp / "ckpt"), str(jdir)
    # the port's runs: (2, 4) on 8 ranks, (2, 2) and the save on 4, the
    # restores on 2
    out = _run(tmp, "world8", 8, inputs)
    out.update(_run(tmp, "world4", 4, inputs))
    out.update(_run(tmp, "world2", 2, inputs))
    return ref, out


def test_moe_expert_parallel_matches_the_local_reference(runs):
    ref, out = runs
    np.testing.assert_allclose(out["moe_y"], np.asarray(ref["moe_y"]),
                               **EP_TOL)
    np.testing.assert_allclose(float(out["moe_aux"]), ref["moe_aux_shards"],
                               **TOL)


@pytest.mark.parametrize("case", ["qwen_z0_24", "qwen_z1_22", "moonshot_24"])
def test_sharded_train_step_matches_one_device_reference(runs, case):
    ref, out = runs
    losses, params = ref[case.split("_")[0]]
    np.testing.assert_allclose(out["loss/" + case], losses, **TOL)
    atol = TOL["atol"] + 0.1 * LR * len(losses)
    for k, v in params.items():
        np.testing.assert_allclose(out[f"out/{case}/{k}"], v,
                                   rtol=TOL["rtol"], atol=atol,
                                   err_msg=f"{case} {k}")


@pytest.mark.parametrize("knob", ["none", "attn_pad_heads",
                                  "attn_batch_reshard"])
def test_mesh_knobs_preserve_the_loss(runs, knob):
    ref, out = runs
    assert abs(float(out["knob/" + knob]) - ref["knob"]) < 1e-4


def test_decode_cache_anchor_changes_nothing(runs):
    ref, out = runs
    np.testing.assert_array_equal(out["decode/1"], out["decode/0"])
    np.testing.assert_allclose(out["prefill"], np.asarray(ref["prefill"]),
                               **LM_TOL)
    np.testing.assert_allclose(out["decode/0"], np.asarray(ref["decode"]),
                               **LM_TOL)


def test_mamba_scan_region_matches_the_plain_scan(runs):
    _, out = runs
    np.testing.assert_allclose(out["scan/region"], out["scan/plain"], **TOL)
    assert float(out["scan/max_err"]) < TOL["rtol"]


def test_elastic_restore_across_meshes(runs):
    ref, out = runs
    assert int(out["elastic_saved_step"]) == 2
    for key in ("dir", "jdir"):
        assert int(out[key + "/restored"]) == 2
        assert int(out[key + "/step"]) == 4
        assert "Shard" in str(out[key + "/placements"]) or \
            "Replicate" in str(out[key + "/placements"])
    np.testing.assert_allclose(out["jdir/losses"], ref["jdir_losses"], **TOL)
    assert np.isfinite(out["dir/losses"]).all()
