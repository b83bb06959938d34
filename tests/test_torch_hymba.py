"""Port's Hymba (``repro_torch/models/hymba.py``) against
``repro.models.hymba`` from the same weights: ``train_loss`` and the
logits, prefill and decode logits and every cache (attention K/V, the SSM
state, the conv state), 0 flash-attention launches under ``use_pallas``
(the reference's traced per-layer window keeps its kernel off), and the
registry's init tree against the reference's (paths, shapes, dtypes), so
checkpoints cross. Reduced config with 3 layers, a 16-token window and a
global layer every 2, so local and global layers both run. Tolerance: the
f32 bar of tests/test_kernels.py (atol=2e-5, rtol=2e-4); for logits its
atol is taken times the largest |logit| (``_logits_close``): the Mamba and
attention outputs reach |25| before the fuse norms, and both packages'
float32 logits lie 2-4e-5 from the port's float64 run at |logit| <= 5.6,
above the plain atol (the dense families' logits agree to 5e-6)."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import RunConfig as JRunConfig, reduced as jreduced
from repro.configs.registry import get_config as jget_config
from repro.kernels.flash_attention import kernel as jkernel
from repro.models import hymba as jhymba
from repro.models.registry import get_model as jget_model
from repro_torch import tree as tree_lib
from repro_torch.configs.base import RunConfig, reduced
from repro_torch.configs.registry import get_config
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import hymba
from repro_torch.models.common import ParamDef, params_from_numpy
from repro_torch.models.registry import get_model

TOL = dict(atol=2e-5, rtol=2e-4)


def _logits_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=TOL["rtol"],
        atol=TOL["atol"] * max(1.0, float(np.abs(want).max())))
OVER = dict(n_layers=3, local_window=16, global_every=2)


def _setup():
    jcfg = jreduced(jget_config("hymba-1.5b"), **OVER)
    cfg = reduced(get_config("hymba-1.5b"), **OVER)
    jparams = jhymba.init(jax.random.PRNGKey(0), jcfg)
    jparams = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(7),
                                               a.shape), jparams)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    return jcfg, cfg, jparams, params


def _batch(cfg, B, S, seed=1):
    t = np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S + 1))
    t = t.astype(np.int32)
    return ({"tokens": jnp.asarray(t[:, :-1]),
             "labels": jnp.asarray(t[:, 1:])},
            {"tokens": torch.from_numpy(t[:, :-1].copy()),
             "labels": torch.from_numpy(t[:, 1:].copy())})


def test_windows_mix_local_and_global_layers():
    from repro_torch.models.lm import layer_windows
    assert layer_windows(reduced(get_config("hymba-1.5b"), **OVER)).tolist() \
        == [0, 16, 0]


def test_forward_and_loss_match_reference_without_the_kernel(monkeypatch):
    """Under use_pallas neither package calls its flash kernel: on the CPU
    the port's wrapper would run ``ops.attention_ref``, spied on here."""
    jcfg, cfg, jparams, params = _setup()
    jb, tb = _batch(cfg, 2, 64)
    jcalls, calls = [], []
    jreal, real = jkernel.flash_attention, ops.attention_ref
    monkeypatch.setattr(jkernel, "flash_attention",
                        lambda *a, **kw: jcalls.append(1) or jreal(*a, **kw))
    monkeypatch.setattr(ops, "attention_ref",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    jrun = JRunConfig(compute_dtype="float32", use_pallas=True)
    run = RunConfig(compute_dtype="float32", use_pallas=True)
    jlogits, _ = jhymba.forward_train(jparams, jcfg, jrun, jb)
    jloss = jhymba.train_loss(jparams, jcfg, jrun, jb)
    with torch.no_grad():
        logits, aux = hymba.forward_train(params, cfg, run, tb)
        loss = get_model(cfg).train_loss(params, run, tb)
    assert jcalls == calls == []
    assert float(aux) == 0.0
    _logits_close(logits.numpy(), jlogits)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)


def test_prefill_and_decode_match_reference():
    jcfg, cfg, jparams, params = _setup()
    B, S, Smax = 2, 20, 24
    jrun, run = JRunConfig(compute_dtype="float32"), \
        RunConfig(compute_dtype="float32")
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (B, S + 3))
    jcache = jhymba.init_cache(jcfg, B, Smax, jnp.float32)
    cache = get_model(cfg).init_cache(B, Smax, torch.float32, "cpu")
    jl, jcache, jlen = jhymba.prefill(jparams, jcfg, jrun, jcache,
                                      jnp.asarray(toks[:, :S], jnp.int32))
    with torch.no_grad():
        tl, cache, lens = hymba.prefill(params, cfg, run, cache,
                                        torch.from_numpy(toks[:, :S]))
    _logits_close(tl.numpy(), jl)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlen))
    pos = np.full((B,), S, np.int32)
    for t in range(3):
        jl, jcache = jhymba.decode_step(jparams, jcfg, jrun, jcache,
                                        jnp.asarray(toks[:, S + t], jnp.int32),
                                        jnp.asarray(pos + t))
        with torch.no_grad():
            tl, cache = hymba.decode_step(params, cfg, run, cache,
                                          torch.from_numpy(toks[:, S + t]),
                                          torch.from_numpy(pos + t))
        _logits_close(tl.numpy(), jl)
    assert set(cache) == set(jcache) == {"k", "v", "ssm", "conv"}
    for k in cache:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   err_msg=k, **TOL)


def test_prefill_then_decode_equals_forward():
    _, cfg, _, params = _setup()
    bundle = get_model(cfg)
    run = RunConfig(compute_dtype="float32")
    toks = torch.from_numpy(
        np.random.RandomState(4).randint(0, cfg.vocab_size, (2, 24)))
    with torch.no_grad():
        full, _ = hymba.forward_train(params, cfg, run, {"tokens": toks})
        cache = bundle.init_cache(2, 24, torch.float32, "cpu")
        lg, cache, lens = bundle.prefill(params, run, cache, toks[:, :20])
        _logits_close(lg.numpy(), full[:, 19].numpy())
        for t in range(20, 23):
            lg, cache = bundle.decode_step(params, run, cache, toks[:, t],
                                           lens)
            lens = lens + 1
            _logits_close(lg.numpy(), full[:, t].numpy())


@pytest.mark.parametrize("arch", ["hymba-1.5b", "whisper-large-v3",
                                  "moonshot-v1-16b-a3b",
                                  "llama4-scout-17b-a16e"])
def test_init_tree_has_the_reference_s_paths_shapes_and_dtypes(arch):
    """Every new family: the port's init and the reference's flatten to the
    same paths, shapes and dtypes, so checkpoints cross."""
    jcfg = jreduced(jget_config(arch))
    cfg = reduced(get_config(arch))
    jtree = jget_model(jcfg).init(jax.random.PRNGKey(0))
    tree = get_model(cfg).init(torch.Generator().manual_seed(0))
    want = [(k, tuple(a.shape), str(a.dtype)) for k, a in
            tree_lib.flatten_with_path(jax.tree_util.tree_map(np.asarray,
                                                              jtree))]
    got = [(k, tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for k, t in tree_lib.flatten_with_path(tree)]
    assert got == want
    assert [(k, s) for k, s, _ in got] == _def_shapes(
        get_model(cfg).full_defs())


def _def_shapes(defs, prefix=""):
    """[(path, shape)] of a ParamDef tree, in the tree's leaf order."""
    if isinstance(defs, ParamDef):
        return [(prefix, tuple(defs.shape))]
    out = []
    for k in sorted(defs):
        out += _def_shapes(defs[k], f"{prefix}/{k}" if prefix else k)
    return out
