"""Port's training path against the JAX package's, from the same weights:
``train/steps.build_train_step`` (three steps; microbatching, top-k with
error feedback, remat none/full/dots), the kernels' refusal of a gradient,
the ``Trainer`` (checkpoint/resume, stragglers, host failure, emergency
save), the launcher and the example.

Tolerances. Loss, grad norm, lr and both moments: the f32 bar of
tests/test_kernels.py (atol=2e-5, rtol=2e-4). Parameters: the same rtol and
atol = 2e-5 + 0.1 * lr per update taken. AdamW normalises each element's
step (lr * m_hat / (sqrt(v_hat) + eps)), so an element whose gradient is
near the float32 rounding of its own sum (the sLSTM biases, rarely
seen embedding rows) moves by a share of lr that the two frameworks' last bits
decide; the moments, which carry the gradients themselves, meet the f32
bar. With top-k compression an element whose |g + err| sits at the k-th
largest magnitude, within the gradients' rounding, is sent by one framework
and kept by the other: its parameter moves by up to lr and its moments and
error feedback by its whole gradient, so there at most 0.1% of a leaf's
elements (and at least two) may lie outside the bar. Such an element
changes the next step's gradients (by up to 3e-3 through the reduced
xLSTM's sLSTM recurrence), which flips thousands of near-threshold elements
a step later, so each top-k step starts from the reference's state.
``_topk_compress`` itself is held exact on equal inputs. Reduced Hymba's
step meets such a gradient whole: an embedding element's gradient cancels
to ~1e-8 (at step 2 its first moment is -5.0e-8 in the reference and
+5.1e-9 in the port, both within the f32 bar), and AdamW turns the sign
into a step of +-lr; there, as in chip_smoke.py's train phase, at most
0.1% of a leaf's elements (and at least two) may lie outside the bar,
each within 2 lr per update, while the moments meet the f32 bar. Prefill and
decode logits: tests/test_torch_lm.py's bar (atol=2e-4, rtol=2e-3). The
port's three remat modes are held to each other bit for bit.
"""
import shutil
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.checkpoint import checkpointer as jckpt
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import reduced as jreduced
from repro.configs.registry import get_config as jget_config
from repro.kernels.flash_attention.kernel import flash_attention as jflash
from repro.launch.mesh import make_local_mesh
from repro.models import lm as jlm
from repro.models.registry import get_model as jget_model
from repro.optim import adamw as jadamw
from repro.train import steps as jsteps
from repro.train import trainer as jtrainer
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.base import RunConfig, ShapeConfig, reduced
from repro_torch.configs.registry import get_config
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.mlstm_scan.ops import mlstm_scan
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models import lm
from repro_torch.models.common import params_from_numpy, softmax_xent
from repro_torch.models.registry import get_model
from repro_torch.optim import adamw
from repro_torch.train import steps
from repro_torch.train.trainer import (HostDelayInjector, StragglerPolicy,
                                       Trainer, TrainState)

TOL = dict(atol=2e-5, rtol=2e-4)
LM_TOL = dict(atol=2e-4, rtol=2e-3)     # tests/test_torch_lm.py
LR = 1e-3
B, S = 4, 64
ARCH_LAYERS = {"qwen1.5-4b": 2, "xlstm-125m": 5,   # xLSTM: sLSTM at 0 and 4
               "moonshot-v1-16b-a3b": 2, "hymba-1.5b": 2}
STEP_KW = dict(compute_dtype="float32", lr=LR, warmup_steps=1,
               total_steps=10, remat="none")
CASES = [("qwen1.5-4b", {}),
         ("qwen1.5-4b", {"microbatch": 2}),
         ("qwen1.5-4b", {"grad_compression": "topk", "topk_ratio": 0.2}),
         ("qwen1.5-4b", {"remat": "full"}),
         ("qwen1.5-4b", {"remat": "dots"}),
         ("xlstm-125m", {}),
         ("xlstm-125m", {"microbatch": 2}),
         ("xlstm-125m", {"grad_compression": "topk", "topk_ratio": 0.2}),
         ("xlstm-125m", {"remat": "full"}),
         ("moonshot-v1-16b-a3b", {}),     # the loss adds 0.01 * aux
         ("hymba-1.5b", {})]
AT_ROUNDING = {"hymba-1.5b"}      # a gradient that cancels to ~1e-8


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """pytest-xdist runs several workers on the machine's cores, and
    torch's default of one thread per core in each oversubscribes them:
    the threads' barriers then cost more than the reduced models' small
    ops they split. Two threads a worker in this module; the default comes
    back after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(arch):
    n = ARCH_LAYERS[arch]
    return (jreduced(jget_config(arch), n_layers=n),
            reduced(get_config(arch), n_layers=n))


def _jax_params(jcfg):
    jp = jget_model(jcfg).init(jax.random.PRNGKey(0))
    # non-zero biases and norm scales, so every parameter takes part
    return jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(7),
                                               a.shape), jp)


def _to_port(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _batches(cfg, n, seed=1, B=B, S=S):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        toks = rng.randint(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        yield ({"tokens": jnp.asarray(toks[:, :-1]),
                "labels": jnp.asarray(toks[:, 1:])},
               {"tokens": torch.from_numpy(toks[:, :-1].copy()),
                "labels": torch.from_numpy(toks[:, 1:].copy())})


@pytest.fixture(scope="module")
def port_steps():
    """``get(arch, kw)``: the port's three ``build_train_step`` steps
    (``STEP_KW`` and ``kw``) from the reference's initial weights
    (``_jax_params``), as (metrics, params, AdamW state) after each step,
    cloned. The run is a function of (arch, kw) alone, so it is computed
    once per module and shared by the tests that drive it: the reference
    match of each case and the remat modes' bit-identity."""
    runs = {}

    def get(arch, kw):
        key = (arch, tuple(sorted(kw.items())))
        if key not in runs:
            runs[key] = _port_run(arch, kw)
        return runs[key]
    return get


def _port_run(arch, kw):
    jcfg, cfg = _configs(arch)
    run = RunConfig(**{**STEP_KW, **kw})
    fn = steps.build_train_step(cfg, run, ShapeConfig("t", "train", S, B))
    p = _to_port(_jax_params(jcfg))
    opt, err, out = adamw.init(p), torch.zeros(()), []
    for step, (_, tb) in enumerate(_batches(cfg, 3)):
        p, opt, err, m = fn(p, opt, err, tb, step)
        assert set(m) == {"loss", "grad_norm", "lr"}
        out.append(({k: float(v) for k, v in m.items()},
                    tree_lib.tree_map(torch.clone, p),
                    tree_lib.tree_map(torch.clone, opt)))
    return out


def _close(name, ours, ref, atol=TOL["atol"], strays=False, cap=None):
    """Every leaf within (atol, TOL's rtol); with ``strays``, at most 0.1%
    of a leaf's elements (and at least two) may lie outside, each within
    ``cap`` of the reference where one is given."""
    ref = jax.tree_util.tree_map(np.asarray, ref)
    for (k, a), b in zip(tree_lib.flatten_with_path(ref),
                         tree_lib.leaves(ours)):
        b = b.numpy()
        if not strays:
            np.testing.assert_allclose(b, a, rtol=TOL["rtol"], atol=atol,
                                       err_msg=f"{name} {k}")
            continue
        off = np.abs(b - a) > atol + TOL["rtol"] * np.abs(a)
        assert off.sum() <= max(2, a.size // 1000), \
            f"{name} {k}: {off.sum()} of {a.size} elements off"
        if cap is not None:
            assert np.abs(b - a).max() <= cap, f"{name} {k}: beyond {cap}"


@pytest.mark.parametrize("arch,kw", CASES,
                         ids=[f"{a}-{'-'.join(map(str, k.values())) or 'plain'}"
                              for a, k in CASES])
def test_train_step_matches_reference(arch, kw, port_steps):
    jcfg, cfg = _configs(arch)
    kw = {**STEP_KW, **kw}
    jrun, run = JRunConfig(**kw), RunConfig(**kw)
    jfn, _ = jsteps.build_train_step(jcfg, jrun, make_local_mesh(),
                                     JShapeConfig("t", "train", S, B))
    jfn = jax.jit(jfn)
    jp = _jax_params(jcfg)
    jopt = jadamw.init(jp)
    topk = run.grad_compression == "topk"
    jerr = (jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, jnp.float32),
                                   jp) if topk else jnp.zeros(()))
    if topk:        # the port's steps restart from the reference's state
        fn = steps.build_train_step(cfg, run,
                                    ShapeConfig("t", "train", S, B))
        p = _to_port(jp)
        opt, err = adamw.init(p), tree_lib.tree_map(torch.zeros_like, p)
    else:           # the port's run alone, shared with the remat test
        port = port_steps(arch, {k: v for k, v in kw.items()
                                 if k not in STEP_KW or STEP_KW[k] != v})
    updates = 0
    for step, (jb, tb) in enumerate(_batches(cfg, 3)):
        if topk and step:       # each top-k step from the reference's state
            p, err = _to_port(jp), _to_port(jerr)
            opt = adamw.AdamWState(torch.tensor(step, dtype=torch.int32),
                                   _to_port(jopt.mu), _to_port(jopt.nu))
        jp, jopt, jerr, jm = jfn(jp, jopt, jerr, jb, jnp.int32(step))
        if topk:
            p, opt, err, m = fn(p, opt, err, tb, step)
        else:
            m, p, opt = port[step]
        assert set(m) == {"loss", "grad_norm", "lr"}
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **TOL,
                                       err_msg=f"step {step} {k}")
        updates = 1 if topk else updates + (float(jm["lr"]) > 0)
        _close(f"step {step} params", p, jp, TOL["atol"] + 0.1 * LR * updates,
               strays=topk or arch in AT_ROUNDING,
               cap=None if topk else 2 * LR * updates)
        _close(f"step {step} mu", opt.mu, jopt.mu, strays=topk)
        _close(f"step {step} nu", opt.nu, jopt.nu, strays=topk)
        assert int(opt.step) == int(jopt.step) == step + 1
        if topk:
            _close(f"step {step} err", err, jerr, strays=True)


@pytest.mark.parametrize("ratio", [0.01, 0.2, 1.0])
def test_topk_compress_matches_reference(ratio):
    rng = np.random.RandomState(4)
    for shape in ((16, 8), (3, 5, 7), (9,)):
        g = rng.randn(*shape).astype(np.float32)
        e = 0.1 * rng.randn(*shape).astype(np.float32)
        jg, je = jsteps._topk_compress(jnp.asarray(g), jnp.asarray(e), ratio)
        tg, te = steps._topk_compress(torch.from_numpy(g),
                                      torch.from_numpy(e), ratio)
        assert np.array_equal(tg.numpy(), np.asarray(jg))
        assert np.array_equal(te.numpy(), np.asarray(je))
        if len(shape) >= 2:
            k = max(1, int(g.size * ratio))
            assert int((tg != 0).sum()) == k


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "xlstm-125m"])
def test_remat_modes_are_bit_identical(arch, port_steps):
    """Three steps in each remat mode, from the reference's initial weights
    (the runs the reference match drives, ``port_steps``): the metrics of
    every step and the final parameters and AdamW state bit for bit."""
    out = {}
    for mode in ("none", "full", "dots"):
        run = port_steps(arch, {} if mode == "none" else {"remat": mode})
        out[mode] = ([list(m.values()) for m, _, _ in run],
                     tree_lib.leaves(run[-1][1:]))
    for mode in ("full", "dots"):
        assert out[mode][0] == out["none"][0], mode
        assert all(torch.equal(a, b)
                   for a, b in zip(out[mode][1], out["none"][1])), mode


def test_remat_gives_the_same_gradients_per_leaf():
    _remat_gradients_agree("qwen1.5-4b")


def test_remat_gives_the_same_gradients_per_leaf_from_xlstm_s_own_init():
    """xLSTM's own init (its sLSTM and mLSTM blocks) through the three
    remat modes; the three-step runs above start from the reference's
    weights."""
    _remat_gradients_agree("xlstm-125m")


def _remat_gradients_agree(arch):
    _, cfg = _configs(arch)
    p = get_model(cfg).init(torch.Generator().manual_seed(0))
    _, tb = next(_batches(cfg, 1))
    grads = {}
    for mode in ("none", "full", "dots"):
        run = RunConfig(**{**STEP_KW, "remat": mode})
        loss, g = steps.value_and_grad(
            lambda pp, bb: get_model(cfg).train_loss(pp, run, bb), p, tb)
        grads[mode] = (loss, g)
        assert all(x.grad is None and not x.requires_grad
                   for x in tree_lib.leaves(p))
    for mode in ("full", "dots"):
        assert torch.equal(grads[mode][0], grads["none"][0])
        assert all(torch.equal(a, b)
                   for a, b in zip(grads[mode][1], grads["none"][1]))


# ---------------------------------------------------------------------------
# the kernels refuse a gradient, as the reference's do
# ---------------------------------------------------------------------------

def test_reference_cannot_differentiate_its_flash_kernel():
    rng = np.random.RandomState(0)
    q, k, v = (jnp.asarray(rng.randn(1, 2, 64, 32).astype(np.float32))
               for _ in range(3))
    with pytest.raises(Exception):
        jax.grad(lambda q: jflash(q, k, v, causal=True, block_q=64,
                                  block_k=64, interpret=True).sum())(q)


def test_train_step_with_use_pallas_raises_in_both_packages():
    jcfg, cfg = _configs("qwen1.5-4b")
    kw = {**STEP_KW, "use_pallas": True}
    jfn, _ = jsteps.build_train_step(jcfg, JRunConfig(**kw),
                                     make_local_mesh(),
                                     JShapeConfig("t", "train", S, 2))
    jp = _jax_params(jcfg)
    jb, tb = next(_batches(cfg, 1, B=2))
    with pytest.raises(Exception):
        jax.jit(jfn)(jp, jadamw.init(jp), jnp.zeros(()), jb, jnp.int32(0))
    fn = steps.build_train_step(cfg, RunConfig(**kw),
                                ShapeConfig("t", "train", S, 2))
    p = _to_port(jp)
    before = [x.clone() for x in tree_lib.leaves(p)]
    with pytest.raises(RuntimeError, match="no backward"):
        fn(p, adamw.init(p), torch.zeros(()), tb, 0)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_lib.leaves(p)))


def test_use_pallas_forward_without_gradient_is_unchanged():
    """Under no_grad, and with grad mode on for weights that need no
    gradient, the use_pallas forward still runs the kernel's plain version
    and equals the plain attention path."""
    _, cfg = _configs("qwen1.5-4b")
    p = get_model(cfg).init(torch.Generator().manual_seed(0))
    _, tb = next(_batches(cfg, 1, B=2))
    with torch.no_grad():
        want = lm.train_loss(p, cfg, RunConfig(**STEP_KW), tb)
        got = lm.train_loss(p, cfg, RunConfig(**STEP_KW, use_pallas=True), tb)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    grad_on = lm.train_loss(p, cfg, RunConfig(**STEP_KW, use_pallas=True), tb)
    assert not grad_on.requires_grad
    np.testing.assert_allclose(float(grad_on), float(got), rtol=0, atol=0)


def _kernel_inputs():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    flash = (r(1, 2, 64, 16), r(1, 2, 64, 16), r(1, 2, 64, 16))
    scan = (r(1, 2, 32, 8), r(1, 2, 32, 8), r(1, 2, 32, 8),
            -torch.rand(1, 2, 32, generator=g), r(1, 2, 32))
    paged = (r(2, 4, 16), r(4, 2, 8, 16), r(4, 2, 8, 16),
             torch.tensor([[0, 1], [2, 3]], dtype=torch.int32),
             torch.tensor([9, 16], dtype=torch.int32))
    return {"flash_attention": (flash_attention, flash, {"causal": True}),
            "mlstm_scan": (mlstm_scan, scan, {"chunk": 16}),
            "paged_attention": (paged_attention, paged, {})}


@pytest.mark.parametrize("name", ["flash_attention", "mlstm_scan",
                                  "paged_attention"])
def test_kernel_wrappers_refuse_a_gradient(name):
    fn, args, kw = _kernel_inputs()[name]
    want = fn(*args, **kw)                      # no input needs a gradient
    with torch.no_grad():
        assert torch.equal(fn(*(a.clone().requires_grad_(a.is_floating_point())
                                for a in args), **kw), want)
    with torch.inference_mode():
        assert torch.equal(fn(*args, **kw), want)
    for i, a in enumerate(args):
        if not a.is_floating_point():
            continue
        live = list(args)
        live[i] = a.clone().requires_grad_()
        with pytest.raises(RuntimeError, match=f"{name}: the kernel has no "
                                               f"backward"):
            fn(*live, **kw)


# ---------------------------------------------------------------------------
# trainer: loss goes down, resume, stragglers, compression
# (the mirrors of tests/test_substrate.py's trainer tests, on the CPU)
# ---------------------------------------------------------------------------

def _trainer(tmp, **kw):
    cfg = reduced(get_config("qwen1.5-4b"), n_layers=2)
    run = kw.pop("run", RunConfig(compute_dtype="float32", remat="none",
                                  lr=2e-3, warmup_steps=2, total_steps=50))
    shape = ShapeConfig("tiny", "train", 64, 8)
    return Trainer(cfg, run, shape, ckpt_dir=tmp, ckpt_every=4,
                   device="cpu", **kw)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Nine steps of one Trainer that checkpoints every 2 steps (what it
    saves does not touch the state it trains), shared by the two tests
    below: (its checkpoint directory, the Trainer, the final state)."""
    d = tmp_path_factory.mktemp("trainer")
    tr = _trainer(str(d))
    tr.ckpt_every = 2
    st = tr.train(9)
    return str(d), tr, st


def test_trainer_loss_decreases_and_resumes(trained, tmp_path):
    src, tr, st = trained
    d = str(tmp_path / "ckpt")         # the resumed run saves into a copy
    shutil.copytree(src, d)
    losses = [m["loss"] for m in tr.metrics_log]
    assert losses[-1] < losses[0]
    assert [m["step"] for m in tr.metrics_log] == list(range(1, 10))
    tr2 = _trainer(d)
    st2 = tr2.maybe_restore()
    assert st2 is not None and st2.step == 8
    assert tr2.events == ["restored step 8"]
    # the resumed run repeats the continuous run's ninth step exactly
    st2 = tr2.train(1, state=st2)
    assert st2.step == 9
    assert tr2.metrics_log[0]["loss"] == tr.metrics_log[-1]["loss"]
    assert all(torch.equal(a, b) for a, b in
               zip(tree_lib.leaves(st2.params), tree_lib.leaves(st.params)))
    st2 = tr2.train(1, state=st2)
    assert st2.step == 10


def test_trainer_checkpoints_every_n_steps_and_prunes(trained):
    d, _, _ = trained
    assert sorted(p.name for p in Path(d).glob("step_*")) == [
        "step_00000004", "step_00000006", "step_00000008"]


def test_trainer_straggler_exclusion():
    with tempfile.TemporaryDirectory() as d:
        tr = _trainer(d, n_hosts=4,
                      straggler=StragglerPolicy(action="exclude", patience=2),
                      injector=HostDelayInjector(delays={1: 50.0}))
        tr.train(5)
        assert tr.healthy_hosts == [0, 2, 3]
        assert any("excluded host 1" in e for e in tr.events)


def test_trainer_host_failure_detected():
    with tempfile.TemporaryDirectory() as d:
        tr = _trainer(d, n_hosts=3,
                      straggler=StragglerPolicy(action="exclude", patience=3),
                      injector=HostDelayInjector(fail_at={2: 3}))
        tr.train(5)
        assert 2 not in tr.healthy_hosts


def test_grad_compression_topk_trains():
    run = RunConfig(compute_dtype="float32", remat="none", lr=2e-3,
                    warmup_steps=2, total_steps=50,
                    grad_compression="topk", topk_ratio=0.2)
    with tempfile.TemporaryDirectory() as d:
        tr = _trainer(d, run=run)
        tr.train(8)
        losses = [m["loss"] for m in tr.metrics_log]
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0], "top-k + error feedback must learn"


def test_trainer_emergency_save_on_exception():
    run = RunConfig(compute_dtype="float32", remat="none", use_pallas=True)
    with tempfile.TemporaryDirectory() as d:
        tr = _trainer(d, run=run)
        with pytest.raises(RuntimeError, match="no backward"):
            tr.train(2)
        assert tr.events == ["emergency checkpoint at 0"]
        manifest = (Path(d) / "step_00000000" / "manifest.json").read_text()
        assert '"emergency": true' in manifest


class _Boom:
    """A gradient leaf that fails when the update reads it."""

    def float(self):
        raise RuntimeError("injected failure inside the update")


def test_trainer_never_resumes_from_a_half_taken_step(monkeypatch):
    """A failure inside ``adamw.update`` after its first leaf, at step 6:
    the first leaf is updated in place, the rest are not. No checkpoint may
    hold that mix; the next Trainer resumes from step 4, the last whole
    step, bit-identical to a run that stopped there."""
    real, calls = adamw.update, []

    def failing(grads, state, params, **kw):
        calls.append(1)
        if len(calls) == 6:
            grads = [grads[0], _Boom(), *grads[2:]]
        return real(grads, state, params, **kw)

    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as d_ref:
        want = _trainer(d_ref).train(4)
        tr = _trainer(d)
        monkeypatch.setattr(adamw, "update", failing)
        with pytest.raises(RuntimeError, match="injected failure"):
            tr.train(8)
        monkeypatch.setattr(adamw, "update", real)
        assert ckpt.latest_step(d) == 4
        assert tr.events == ["no emergency checkpoint at 5: the step had "
                             "begun to update the state"]
        st = _trainer(d).maybe_restore()
        assert st.step == 4 and int(st.opt.step) == 4
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_lib.leaves((st.params, st.opt)),
                       tree_lib.leaves((want.params, want.opt))))


def test_trainer_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("qwen1.5-4b"), n_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, RunConfig(), ShapeConfig("t", "train", 64, 2))
    assert Trainer(cfg, RunConfig(), ShapeConfig("t", "train", 64, 2),
                   device="cpu").device.type == "cpu"


def test_trainer_matches_the_reference_trainer():
    """Both trainers from the JAX init, four steps of the pipeline's data:
    equal per-step loss, grad norm and lr; both checkpoints at step 4 hold
    the same keys and the parameters within the step test's tolerance."""
    jcfg, cfg = _configs("qwen1.5-4b")
    kw = dict(compute_dtype="float32", remat="none", lr=LR, warmup_steps=1,
              total_steps=10)
    shape = dict(name="t", kind="train", seq_len=S, global_batch=B)
    with tempfile.TemporaryDirectory() as jd, \
            tempfile.TemporaryDirectory() as d:
        jtr = jtrainer.Trainer(jcfg, JRunConfig(**kw), make_local_mesh(),
                               JShapeConfig(**shape), ckpt_dir=jd,
                               ckpt_every=4)
        jst = jtr.init_state()
        jtr.train(4, state=jst)
        tr = Trainer(cfg, RunConfig(**kw), ShapeConfig(**shape), ckpt_dir=d,
                     ckpt_every=4, device="cpu")
        p = _to_port(jtr.init_state().params)
        tr.train(4, state=TrainState(p, adamw.init(p), torch.zeros(()), 0))
        for jm, m in zip(jtr.metrics_log, tr.metrics_log):
            assert m["step"] == jm["step"]
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(m[k], jm[k], **TOL)
        jflat = np.load(Path(jd) / "step_00000004" / "shard_0.npz")
        flat = np.load(Path(d) / "step_00000004" / "shard_0.npz")
        assert sorted(jflat.files) == sorted(flat.files)
        for k in jflat.files:
            np.testing.assert_allclose(flat[k], jflat[k], rtol=TOL["rtol"],
                                       atol=TOL["atol"] + 0.1 * LR * 3,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# prefill / decode wrappers, the launcher and the example
# ---------------------------------------------------------------------------

def test_prefill_and_decode_steps_match_reference():
    jcfg, cfg = _configs("qwen1.5-4b")
    kw = dict(compute_dtype="float32")
    shape = dict(name="p", kind="prefill", seq_len=32, global_batch=2)
    jpre, _ = jsteps.build_prefill_step(jcfg, JRunConfig(**kw),
                                        make_local_mesh(),
                                        JShapeConfig(**shape))
    jdec, _ = jsteps.build_decode_step(jcfg, JRunConfig(**kw),
                                       make_local_mesh(),
                                       JShapeConfig(**shape))
    pre = steps.build_prefill_step(cfg, RunConfig(**kw), ShapeConfig(**shape))
    dec = steps.build_decode_step(cfg, RunConfig(**kw), ShapeConfig(**shape))
    jp = _jax_params(jcfg)
    p = _to_port(jp)
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 16))
    jl, jc, jlen = jpre(jp, jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        l, c, lens = pre(p, torch.from_numpy(toks).int())
        np.testing.assert_allclose(l.numpy(), np.asarray(jl), **LM_TOL)
        assert lens.tolist() == np.asarray(jlen).tolist() == [16, 16]
        tok = l.argmax(-1)
        jl2, _ = jdec(jp, jc, jnp.asarray(tok.numpy(), jnp.int32), jlen)
        l2, _ = dec(p, c, tok, lens)
    np.testing.assert_allclose(l2.numpy(), np.asarray(jl2), **LM_TOL)


def test_launcher_trains_on_the_cpu(capsys):
    from repro_torch.launch import train as launch_train
    with tempfile.TemporaryDirectory() as d:
        tr, st = launch_train.main(["--smoke", "--device", "cpu", "--steps", "4",
                                "--seq", "32", "--batch", "2", "--ckpt", d,
                                "--ckpt-every", "2", "--arch", "qwen1.5-4b"])
        assert ckpt.latest_step(d) == 4 and jckpt.latest_step(d) == 4
    out = capsys.readouterr().out
    assert "[train] qwen1.5-4b-smoke" in out and "done at step 4" in out
    assert len(tr.metrics_log) == 4 and st.step == 4
    assert np.isfinite([m["loss"] for m in tr.metrics_log]).all()


def test_moe_loss_adds_the_aux_term_as_the_reference():
    jcfg, cfg = _configs("moonshot-v1-16b-a3b")
    jp = _jax_params(jcfg)
    p = _to_port(jp)
    jb, tb = next(_batches(cfg, 1))
    jrun, run = JRunConfig(**STEP_KW), RunConfig(**STEP_KW)
    jlogits, jaux = jlm.forward_train(jp, jcfg, jrun, jb)
    with torch.no_grad():
        logits, aux = lm.forward_train(p, cfg, run, tb)
        loss = lm.train_loss(p, cfg, run, tb)
    assert float(aux) > 0.1
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    xent = softmax_xent(logits, tb["labels"])
    np.testing.assert_allclose(float(loss - xent), 0.01 * float(aux),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(
        float(loss), float(jlm.train_loss(jp, jcfg, jrun, jb)), **TOL)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "llama4-scout-17b-a16e", "hymba-1.5b"])
def test_launcher_trains_the_new_families_on_the_cpu(arch, capsys):
    from repro_torch.launch import train as launch_train
    tr, st = launch_train.main(["--smoke", "--device", "cpu", "--steps", "2",
                                "--seq", "32", "--batch", "2", "--arch",
                                arch])
    assert st.step == 2 and len(tr.metrics_log) == 2
    assert np.isfinite([m["loss"] for m in tr.metrics_log]).all()
    assert f"[train] {arch}-smoke" in capsys.readouterr().out


def test_launcher_refuses_whisper_as_the_reference(monkeypatch):
    """Both launchers train on ``synthetic_batch``, which has no audio, and
    both refuse for the missing ``audio_embeds``: the port's forward with
    ``KeyError: 'audio_embeds'``."""
    from repro.launch import train as jlaunch_train
    from repro_torch.launch import train as launch_train
    argv = ["--arch", "whisper-large-v3", "--smoke", "--steps", "2", "--seq",
            "32", "--batch", "2"]
    monkeypatch.setattr("sys.argv", ["train.py", *argv])
    # this JAX refuses the batch at the jitted step's input shardings (the
    # specs hold audio_embeds, the batch does not), before the forward
    with pytest.raises((KeyError, ValueError), match="audio_embeds"):
        jlaunch_train.main()
    with pytest.raises(KeyError, match="audio_embeds"):
        launch_train.main([*argv, "--device", "cpu"])


def test_example_trains_on_the_cpu(capsys):
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with tempfile.TemporaryDirectory() as d:
        mod.main(["--smoke", "--device", "cpu", "--steps", "3", "--batch",
                  "2", "--ckpt", d])
    out = capsys.readouterr().out
    assert "arch=xlstm-125m-smoke" in out and "at step 3" in out
