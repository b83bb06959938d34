"""Port's xLSTM (mLSTM chunk scan, sLSTM, full-sequence forward and loss,
prefill, decode) vs the JAX package's, from the same weights, and the
registry's ssm bundle."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import RunConfig as JRunConfig, reduced as jreduced
from repro.configs.registry import get_config as jget_config
from repro.models import xlstm as jx
from repro_torch.configs.base import RunConfig, reduced
from repro_torch.configs.registry import get_config
from repro_torch.models import xlstm
from repro_torch.models.common import params_from_numpy
from repro_torch.models.registry import get_model

TOL = dict(atol=2e-4, rtol=2e-3)     # tests/test_torch_lm.py bar
JRUN = JRunConfig(compute_dtype="float32", remat="none")
RUN = RunConfig(compute_dtype="float32")


def _setup(n_layers):
    jcfg = jreduced(jget_config("xlstm-125m"), n_layers=n_layers)
    cfg = reduced(get_config("xlstm-125m"), n_layers=n_layers)
    jparams = jx.init(jax.random.PRNGKey(0), jcfg)
    # non-zero biases and norm scales, so every parameter takes part
    jparams = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(7),
                                               a.shape), jparams)
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _tokens(cfg, B, S, seed=1):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("n_layers", [2, 5])
def test_forward_and_loss_match_jax(n_layers):
    jcfg, cfg, jparams, params = _setup(n_layers)
    toks, labels = _tokens(cfg, 2, 40)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    jlogits, _ = jx.forward_train(jparams, jcfg, JRUN, jb)
    with torch.no_grad():
        logits, aux = xlstm.forward_train(params, cfg, RUN, tb)
        loss = get_model(cfg).train_loss(params, RUN, tb)
    _close(logits, jlogits)
    np.testing.assert_allclose(float(loss),
                               float(jx.train_loss(jparams, jcfg, JRUN, jb)),
                               **TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("n_layers", [2, 5])
def test_prefill_and_decode_match_jax_and_the_forward(n_layers):
    jcfg, cfg, jparams, params = _setup(n_layers)
    B, S = 2, 16
    toks, _ = _tokens(cfg, B, S, seed=3)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    jfull, _ = jx.forward_train(jparams, jcfg, JRUN, {"tokens": jt})
    jpre, jcache, jlens = jx.prefill(jparams, jcfg, JRUN, None, jt[:, :S - 1])
    jdec, jcache2 = jx.decode_step(jparams, jcfg, JRUN, jcache, jt[:, S - 1],
                                   jlens)
    bundle = get_model(cfg)
    with torch.no_grad():
        full, _ = xlstm.forward_train(params, cfg, RUN, {"tokens": tt})
        pre, cache, lens = bundle.prefill(params, RUN, None, tt[:, :S - 1])
        dec, cache2 = bundle.decode_step(params, RUN, cache, tt[:, S - 1],
                                         lens)
    assert lens.dtype == torch.int32 and lens.tolist() == [S - 1] * B
    _close(pre, jpre)
    _close(dec, jdec)
    _close(pre, full[:, S - 2].numpy())
    _close(dec, full[:, S - 1].numpy())
    for st, jst in ((cache, jcache), (cache2, jcache2)):
        assert len(st) == len(jst) == n_layers
        for layer, jlayer in zip(st, jst):
            for a, b in zip(layer, jlayer):
                assert a.dtype == getattr(torch, str(b.dtype))
                _close(a, b)


def test_mlstm_chunk_scan_from_a_state_with_a_ragged_tail():
    rng = np.random.RandomState(11)
    B, H, S, dh, chunk = 2, 3, 37, 8, 16        # 37 % 16: the padded tail
    q, k, v = (_rand(rng, B, H, S, dh) for _ in range(3))
    lf = np.log(rng.uniform(0.5, 0.99, (B, H, S))).astype(np.float32)
    li = (_rand(rng, B, H, S) * 0.5).astype(np.float32)
    st = (_rand(rng, B, H, dh, dh), _rand(rng, B, H, dh),
          rng.uniform(-3, 1, (B, H)).astype(np.float32))
    jh, jst = jx.mlstm_chunk_scan(*map(jnp.asarray, (q, k, v, lf, li)),
                                  tuple(map(jnp.asarray, st)), chunk=chunk)
    h, tst = xlstm.mlstm_chunk_scan(*map(torch.from_numpy, (q, k, v, lf, li)),
                                    tuple(map(torch.from_numpy, st)),
                                    chunk=chunk)
    assert tuple(h.shape) == (B, H, S, dh)
    _close(h, jh)
    for a, b in zip(tst, jst):
        _close(a, b)


def test_mlstm_decode_cell_matches_jax():
    rng = np.random.RandomState(12)
    B, H, dh = 3, 2, 16
    q, k, v = (_rand(rng, B, H, dh) for _ in range(3))
    lf = np.log(rng.uniform(0.5, 0.99, (B, H))).astype(np.float32)
    li = _rand(rng, B, H)
    st = (_rand(rng, B, H, dh, dh), _rand(rng, B, H, dh), _rand(rng, B, H))
    jh, jst = jx.mlstm_decode_cell(*map(jnp.asarray, (q, k, v, lf, li)),
                                   tuple(map(jnp.asarray, st)))
    h, tst = xlstm.mlstm_decode_cell(*map(torch.from_numpy, (q, k, v, lf, li)),
                                     tuple(map(torch.from_numpy, st)))
    _close(h, jh)
    for a, b in zip(tst, jst):
        _close(a, b)


def test_slstm_cell_matches_jax():
    jcfg, cfg, jparams, params = _setup(2)
    rng = np.random.RandomState(13)
    B, H = 2, cfg.mlstm_heads
    dh = cfg.d_model // H
    xt = _rand(rng, B, H, 4, dh)
    st = (_rand(rng, B, H, dh), np.abs(_rand(rng, B, H, dh)),
          _rand(rng, B, H, dh), _rand(rng, B, H, dh))
    (jst, jh) = jx.slstm_cell(jparams["blocks"][0], jcfg, jnp.asarray(xt),
                              tuple(map(jnp.asarray, st)))
    (tst, h) = xlstm.slstm_cell(params["blocks"][0], cfg,
                                torch.from_numpy(xt),
                                tuple(map(torch.from_numpy, st)))
    _close(h, jh)
    for a, b in zip(tst, jst):
        _close(a, b)


@pytest.mark.parametrize("width", [4, 1])
def test_causal_conv_with_state_matches_jax(width):
    rng = np.random.RandomState(14)
    x, w = _rand(rng, 2, 5, 6), _rand(rng, width, 6)
    st = _rand(rng, 2, width - 1, 6)
    for state in (None, st):
        jargs = (jnp.asarray(x), jnp.asarray(w),
                 None if state is None else jnp.asarray(state))
        targs = (torch.from_numpy(x), torch.from_numpy(w),
                 None if state is None else torch.from_numpy(state))
        (jy, jnew), (y, new) = jx._causal_conv(*jargs), \
            xlstm._causal_conv(*targs)
        _close(y, jy)
        _close(new, jnew)


def test_registry_ssm_bundle():
    cfg = get_config("xlstm-125m")
    bundle = get_model(cfg)
    defs = bundle.full_defs()
    kinds = ["s" if "wr" in b else "m" for b in defs["blocks"]]
    assert kinds == ["s", "m", "m", "m"] * 3      # sLSTM at 0, 4, 8
    assert "lm_head" not in defs                  # tied embeddings
    n = sum(int(np.prod(d.shape)) for d in
            jax.tree_util.tree_leaves(
                defs, is_leaf=lambda x: isinstance(x, xlstm.ParamDef)))
    jdefs = jx.full_defs(jget_config("xlstm-125m"))
    assert n == sum(int(np.prod(d.shape)) for d in jax.tree_util.tree_leaves(
        jdefs, is_leaf=lambda x: isinstance(x, jx.ParamDef)))
    assert defs["blocks"][1]["wq"].shape == (1536, 4, 384)
    assert defs["blocks"][0]["wr"].shape == (4, 192, 4, 192)
    small = reduced(cfg, n_layers=5)
    params = get_model(small).init(torch.Generator().manual_seed(0))
    assert isinstance(params["blocks"], list) and len(params["blocks"]) == 5
    cache = get_model(small).init_cache(2, 8, device="cpu")
    assert tuple(cache[0][2].shape) == (2, 4, 32)
    assert cache[0][2].dtype == torch.bfloat16
    assert tuple(cache[1][0].shape) == (2, 4, 64, 64)
    assert tuple(cache[1][3].shape) == (2, small.conv_width - 1, 256)


def test_params_from_numpy_walks_lists_and_tuples():
    tree = {"a": [np.ones((2,), np.float32), {"b": np.zeros((1, 3))}],
            "c": (np.arange(3),)}
    out = params_from_numpy(tree, "cpu", torch.float32)
    assert isinstance(out["a"], list) and isinstance(out["c"], tuple)
    assert out["a"][1]["b"].shape == (1, 3)
    assert all(t.dtype == torch.float32 for t in
               (out["a"][0], out["a"][1]["b"], out["c"][0]))
