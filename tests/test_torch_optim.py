"""Port's AdamW, clipping and schedule (``repro_torch/optim/adamw.py``)
against ``repro.optim.adamw`` on random trees that mix matrices and 1-D
leaves (weight decay only on ndim >= 2). Tolerance: the f32 bar of
tests/test_kernels.py, atol=2e-5, rtol=2e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="dev dep; pip install -r "
                    "requirements-dev.txt")
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from repro.optim import adamw as jadamw
from repro_torch import tree as tree_lib
from repro_torch.models.common import params_from_numpy
from repro_torch.optim import adamw

TOL = dict(atol=2e-5, rtol=2e-4)


def _tree(rng, scale=1.0):
    return {"blocks": [{"w": scale * rng.randn(6, 4).astype(np.float32),
                        "b": scale * rng.randn(4).astype(np.float32)}
                       for _ in range(2)],
            "embed": scale * rng.randn(3, 5, 2).astype(np.float32),
            "norm": scale * rng.randn(5).astype(np.float32)}


def _close(ours, ref, tol=TOL):
    ref = jax.tree_util.tree_map(np.asarray, ref)
    for (k, a), b in zip(tree_lib.flatten_with_path(ref),
                         tree_lib.leaves(ours)):
        np.testing.assert_allclose(b.detach().numpy(), a, err_msg=k, **tol)


def test_tree_order_and_paths_are_jax_s():
    rng = np.random.RandomState(0)
    t = _tree(rng)
    opt = jadamw.init(jax.tree_util.tree_map(jnp.asarray, t))
    tree = {"params": t, "opt": opt, "err": np.zeros(())}
    jpaths = [("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path), np.asarray(leaf))
              for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]
    ours = tree_lib.flatten_with_path(tree)
    assert [k for k, _ in ours] == [k for k, _ in jpaths]
    assert all(np.array_equal(np.asarray(a), b)
               for (_, a), (_, b) in zip(ours, jpaths))
    rebuilt = tree_lib.unflatten(tree, tree_lib.leaves(tree))
    assert tree_lib.flatten_with_path(rebuilt) == ours


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_update_matches_reference_over_steps(weight_decay):
    rng = np.random.RandomState(1)
    p0 = _tree(rng)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    p = params_from_numpy(p0, "cpu")
    jopt, opt = jadamw.init(jp), adamw.init(p)
    for step in range(5):
        g = _tree(rng, scale=10.0 ** -step)   # down to 1e-4: near eps
        lr = jadamw.cosine_schedule(jnp.int32(step), base_lr=1e-2, warmup=2,
                                    total=5)
        tlr = adamw.cosine_schedule(step, base_lr=1e-2, warmup=2, total=5)
        assert float(tlr) == pytest.approx(float(lr), rel=1e-6)
        jp, jopt = jadamw.update(jax.tree_util.tree_map(jnp.asarray, g),
                                 jopt, jp, lr=lr, weight_decay=weight_decay)
        p, opt = adamw.update(params_from_numpy(g, "cpu"), opt, p, lr=tlr,
                              weight_decay=weight_decay)
        assert int(opt.step) == int(jopt.step) == step + 1
        _close(p, jp)
        _close(opt.mu, jopt.mu)
        _close(opt.nu, jopt.nu)


def test_update_is_in_place_and_reads_grads_only():
    rng = np.random.RandomState(2)
    p = params_from_numpy(_tree(rng), "cpu")
    g = params_from_numpy(_tree(rng), "cpu")
    g0 = [x.clone() for x in tree_lib.leaves(g)]
    opt = adamw.init(p)
    before = [x.data_ptr() for x in tree_lib.leaves(p)]
    p2, opt2 = adamw.update(g, opt, p, lr=torch.tensor(1e-3))
    assert [x.data_ptr() for x in tree_lib.leaves(p2)] == before
    assert all(torch.equal(a, b) for a, b in zip(g0, tree_lib.leaves(g)))
    assert opt2.mu is opt.mu and opt.step.dtype == torch.int32


@pytest.mark.parametrize("start", ["zeros", "random"])
def test_bf16_leaves_get_the_reference_s_float32_moments(start):
    """bf16 params and gradients, three updates: the reference returns
    float32 moments after the first (``m.astype(v.dtype)``, ``v`` float32;
    its ``b1 * m`` rounded in bf16 by the weak-typed scalar), and so must
    the port. Moments at the f32 bar, params within one bf16 ulp."""
    rng = np.random.RandomState(5)
    bf16 = lambda t: jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16), t)
    jp = bf16(_tree(rng))
    p = params_from_numpy(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jp), "cpu", torch.bfloat16)
    jopt, opt = jadamw.init(jp), adamw.init(p)
    if start == "random":      # moments restored in bf16, nu positive
        mu, nu = bf16(_tree(rng, 0.1)), bf16(jax.tree_util.tree_map(
            np.abs, _tree(rng, 0.01)))
        jopt = jadamw.AdamWState(jopt.step, mu, nu)
        opt = adamw.AdamWState(opt.step, *(params_from_numpy(
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t),
            "cpu", torch.bfloat16) for t in (mu, nu)))
    for step in range(3):
        jg = bf16(_tree(rng, 0.1))
        g = params_from_numpy(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), jg), "cpu", torch.bfloat16)
        jp, jopt = jadamw.update(jg, jopt, jp, lr=jnp.float32(1e-2))
        p, opt = adamw.update(g, opt, p, lr=torch.tensor(1e-2))
        for name, ours, ref in (("mu", opt.mu, jopt.mu),
                                ("nu", opt.nu, jopt.nu),
                                ("params", p, jp)):
            assert [str(x.dtype).removeprefix("torch.")
                    for x in tree_lib.leaves(ours)] == \
                [str(x.dtype) for x in jax.tree_util.tree_leaves(ref)], \
                f"step {step} {name} dtypes"
        assert all(x.dtype == torch.float32
                   for x in tree_lib.leaves((opt.mu, opt.nu)))
        f32 = lambda t: jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), t)
        _close(opt.mu, jopt.mu)
        _close(opt.nu, jopt.nu)
        _close(tree_lib.tree_map(lambda x: x.float(), p), f32(jp),
               tol=dict(atol=0, rtol=2 ** -7))


def test_global_norm_and_clip_match_reference():
    rng = np.random.RandomState(3)
    g = _tree(rng, scale=3.0)
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    tg = params_from_numpy(g, "cpu")
    assert float(adamw.global_norm(tg)) == pytest.approx(
        float(jadamw.global_norm(jg)), rel=2e-6)
    for max_norm in (0.5, 1e3):
        clipped, norm = adamw.clip_by_global_norm(tg, max_norm)
        jclipped, jnorm = jadamw.clip_by_global_norm(jg, max_norm)
        assert float(norm) == pytest.approx(float(jnorm), rel=2e-6)
        _close(clipped, jclipped)


@pytest.mark.parametrize("step", [0, 1, 9, 10, 11, 50, 99, 100, 150])
def test_cosine_schedule_matches_reference(step):
    kw = dict(base_lr=3e-4, warmup=10, total=100)
    ref = jadamw.cosine_schedule(jnp.int32(step), **kw)
    ours = adamw.cosine_schedule(step, **kw)
    assert ours.dtype == torch.float32 and ours.dim() == 0
    np.testing.assert_allclose(float(ours), float(ref), **TOL)
    same = adamw.cosine_schedule(torch.tensor(step, dtype=torch.int32), **kw)
    assert float(same) == float(ours)


def test_adamw_optimizes_quadratic():
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    opt = adamw.init(params)
    for _ in range(200):
        g = {"w": 2 * params["w"]}
        params, opt = adamw.update(g, opt, params, lr=torch.tensor(5e-2),
                                   weight_decay=0.0)
    assert float((params["w"] ** 2).sum()) < 1e-2


@settings(deadline=None, max_examples=20)
@given(st.floats(0.1, 10.0), st.integers(0, 1000))
def test_clip_by_global_norm_property(max_norm, seed):
    """The reference's property (tests/test_substrate.py): the clipped
    norm is inside the ball, and clipping inside it is a no-op."""
    rng = np.random.RandomState(seed)
    g = {"a": torch.from_numpy(rng.randn(7, 3).astype(np.float32)),
         "b": torch.from_numpy(rng.randn(5).astype(np.float32))}
    clipped, norm = adamw.clip_by_global_norm(g, max_norm)
    assert float(adamw.global_norm(clipped)) <= max_norm * 1.001
    if float(norm) <= max_norm:
        np.testing.assert_allclose(clipped["a"], g["a"], rtol=1e-6)
