"""Port's dense LM (full-sequence forward and loss, prefill, decode) vs the
JAX package's, from the same weights, and the model registry."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import RunConfig as JRunConfig, reduced as jreduced
from repro.configs.registry import get_config as jget_config
from repro.models import lm as jlm
from repro_torch.configs.base import RunConfig, reduced
from repro_torch.configs.registry import get_config
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import lm
from repro_torch.models.registry import get_model

TOL = dict(atol=2e-4, rtol=2e-3)     # tests/test_torch_paged_lm.py bar
# qwen: QKV bias, homogeneous (the flash kernel); gemma2: softcaps,
# post-norm, tied embeddings, local/global windows (plain on both sides);
# llava: image embeds prepended to the text
ARCHS = {"qwen1.5-4b": {}, "gemma2-2b": {"local_window": 48},
         "llava-next-mistral-7b": {}}


def _setup(arch, n_layers=2):
    over = dict(n_layers=n_layers, **ARCHS[arch])
    jcfg = jreduced(jget_config(arch), **over)
    cfg = reduced(get_config(arch), **over)
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    # non-zero biases and norm scales, so every parameter takes part
    jparams = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(7),
                                               a.shape), jparams)
    params = lm.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _batch(cfg, B, S, seed=1):
    rng = np.random.RandomState(seed)
    n_img = cfg.n_image_tokens
    toks = rng.randint(0, cfg.vocab_size, (B, S - n_img)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if n_img:
        out["image_embeds"] = rng.randn(B, n_img, cfg.d_model).astype(
            np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


class _Counting:
    """Wraps a flash-attention function and counts its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_and_loss_match_jax_with_use_pallas(arch):
    jcfg, cfg, jparams, params = _setup(arch)
    jb, tb = _batch(cfg, 2, 128)
    jrun = JRunConfig(compute_dtype="float32", remat="none", use_pallas=True)
    run = RunConfig(compute_dtype="float32", use_pallas=True)
    jlogits, _ = jlm.forward_train(jparams, jcfg, jrun, jb)
    spy = _Counting(ops.flash_attention)
    with torch.no_grad():
        logits, aux = lm.forward_train(params, cfg, run, tb, flash=spy)
        loss = get_model(cfg).train_loss(params, run, tb)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(loss),
                               float(jlm.train_loss(jparams, jcfg, jrun, jb)),
                               **TOL)
    assert float(aux) == 0.0
    # the kernel runs in every layer, except for gemma2's mixed windows
    assert spy.calls == (0 if arch == "gemma2-2b" else cfg.n_layers)


def test_float16_forward_and_loss_match_jax_with_use_pallas():
    """float16, which the TPU kernel takes (it computes in float32 and casts
    back): reduced Qwen through K2 in every layer, against the reference's
    forward through its Pallas kernel. The loss is held at TOL; the logits
    at TOL with the rtol taken of the largest |logit|, as chip_smoke.py
    holds its full-width forwards: float16 keeps 11 significant bits, the
    two frameworks round at other places, and even the plain attention
    (use_pallas=False on both sides) puts small logits 19x the elementwise
    bar apart while staying under half of this one."""
    jcfg, cfg, jparams, params = _setup("qwen1.5-4b")
    jb, tb = _batch(cfg, 2, 128)
    jrun = JRunConfig(compute_dtype="float16", remat="none", use_pallas=True)
    run = RunConfig(compute_dtype="float16", use_pallas=True)
    jlogits, _ = jlm.forward_train(jparams, jcfg, jrun, jb)
    spy = _Counting(ops.flash_attention)
    with torch.no_grad():
        logits, _ = lm.forward_train(params, cfg, run, tb, flash=spy)
        loss = get_model(cfg).train_loss(params, run, tb)
    assert logits.dtype == torch.float16
    want = np.asarray(jlogits, np.float32)
    np.testing.assert_allclose(logits.float().numpy(), want, rtol=0,
                               atol=TOL["atol"]
                               + TOL["rtol"] * np.abs(want).max())
    np.testing.assert_allclose(float(loss),
                               float(jlm.train_loss(jparams, jcfg, jrun, jb)),
                               **TOL)
    assert spy.calls == cfg.n_layers


def test_loss_mask_matches_jax():
    jcfg, cfg, jparams, params = _setup("qwen1.5-4b", n_layers=1)
    jb, tb = _batch(cfg, 2, 64)
    mask = np.random.RandomState(3).rand(2, 64) > 0.5
    jb["loss_mask"], tb["loss_mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    jrun = JRunConfig(compute_dtype="float32")
    with torch.no_grad():
        loss = lm.train_loss(params, cfg, RunConfig(compute_dtype="float32"),
                             tb)
    np.testing.assert_allclose(float(loss),
                               float(jlm.train_loss(jparams, jcfg, jrun, jb)),
                               **TOL)


@pytest.mark.parametrize("S", [64, 96, 128, 192])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_pallas_ok_gives_the_jax_decision(S, use_pallas):
    q = np.zeros((2, S, 4, 32), np.float32)          # B * S <= 4096
    want = jlm._pallas_ok(JRunConfig(use_pallas=use_pallas), jnp.asarray(q),
                          0)
    assert lm._pallas_ok(RunConfig(use_pallas=use_pallas),
                         torch.from_numpy(q)) == want


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "gemma2-2b"])
def test_kernel_use_follows_jax_for_homogeneous_and_mixed_windows(
        arch, monkeypatch):
    """JAX reaches its flash kernel for homogeneous windows and never for
    gemma2's local/global pattern (a traced window); so does the port."""
    from repro.kernels.flash_attention import kernel as jkernel
    jcfg, cfg, jparams, params = _setup(arch, n_layers=2)
    jb, tb = _batch(cfg, 1, 64)
    jspy = _Counting(jkernel.flash_attention)
    monkeypatch.setattr(jkernel, "flash_attention", jspy)
    jlm.forward_train(jparams, jcfg, JRunConfig(compute_dtype="float32",
                                                use_pallas=True), jb)
    spy = _Counting(ops.flash_attention)
    with torch.no_grad():
        lm.forward_train(params, cfg, RunConfig(compute_dtype="float32",
                                                use_pallas=True), tb,
                         flash=spy)
    assert (spy.calls > 0) == (jspy.calls > 0) == (arch == "qwen1.5-4b")


@pytest.mark.parametrize("grouped,slim", [(False, False), (True, True),
                                          (True, False)])
@pytest.mark.parametrize("arch", ["qwen1.5-4b", "gemma2-2b"])
def test_prefill_and_decode_match_jax(arch, grouped, slim):
    jcfg, cfg, jparams, params = _setup(arch)
    B, S, Smax = 2, 12, 16
    jrun = JRunConfig(compute_dtype="float32", decode_grouped=grouped,
                      decode_slim_mask=slim)
    run = RunConfig(compute_dtype="float32", decode_grouped=grouped,
                    decode_slim_mask=slim)
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (B, S + 2))
    jcache = jlm.init_cache(jcfg, B, Smax, jnp.float32)
    cache = get_model(cfg).init_cache(B, Smax, torch.float32, "cpu")
    jl, jcache, jlen = jlm.prefill(jparams, jcfg, jrun, jcache,
                                   jnp.asarray(toks[:, :S], jnp.int32))
    with torch.no_grad():
        tl, cache, tlen = lm.prefill(params, cfg, run, cache,
                                     torch.from_numpy(toks[:, :S]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    pos = np.array([S, S - 3], np.int32)   # unequal positions
    for t in range(2):
        jl, jcache = jlm.decode_step(jparams, jcfg, jrun, jcache,
                                     jnp.asarray(toks[:, S + t], jnp.int32),
                                     jnp.asarray(pos + t))
        with torch.no_grad():
            tl, cache = lm.decode_step(params, cfg, run, cache,
                                       torch.from_numpy(toks[:, S + t]),
                                       torch.from_numpy(pos + t))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for kv in ("k", "v"):
        np.testing.assert_allclose(cache[kv].numpy(), np.asarray(jcache[kv]),
                                   **TOL)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "gemma2-2b"])
def test_prefill_then_decode_equals_forward(arch):
    """tests/test_models.py::test_prefill_decode_matches_forward, on the
    port alone."""
    _, cfg, _, params = _setup(arch)
    bundle = get_model(cfg)
    run = RunConfig(compute_dtype="float32")
    B, S = 2, 16
    toks = torch.from_numpy(
        np.random.RandomState(4).randint(0, cfg.vocab_size, (B, S)))
    with torch.no_grad():
        full, _ = lm.forward_train(params, cfg, run, {"tokens": toks})
        cache = bundle.init_cache(B, S, torch.float32, "cpu")
        lg_pre, cache, lens = bundle.prefill(params, run, cache,
                                             toks[:, :S - 1])
        lg_dec, _ = bundle.decode_step(params, run, cache, toks[:, S - 1],
                                       lens)
    np.testing.assert_allclose(lg_pre.numpy(), full[:, S - 2].numpy(), **TOL)
    np.testing.assert_allclose(lg_dec.numpy(), full[:, S - 1].numpy(), **TOL)


def test_get_model_gives_a_dense_bundle():
    cfg = reduced(get_config("qwen1.5-4b"))
    bundle = get_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0))

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}

    defs = bundle.full_defs()     # ParamDef leaves have a .shape too
    assert shapes(params) == shapes(defs)
    assert defs["blocks"]["attn"]["wq"].axes == (
        "layers", "embed", "heads", "head_dim")
    cache = bundle.init_cache(2, 8, device="cpu")
    assert cache["k"].dtype == torch.bfloat16
    assert tuple(cache["k"].shape) == (cfg.n_layers, 2, 8, cfg.n_kv_heads,
                                       cfg.resolved_head_dim)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "whisper-large-v3"])
def test_get_model_refuses_the_families_not_ported(arch):
    """No family is refused any more: hymba and whisper, the last two the
    registry refused, build bundles whose init follows their defs."""
    bundle = get_model(reduced(get_config(arch)))
    params = bundle.init(torch.Generator().manual_seed(0))
    leaves = lambda t: [leaves(v) if isinstance(v, dict) else tuple(v.shape)
                        for _, v in sorted(t.items())]
    assert leaves(params) == leaves(bundle.full_defs())
    assert bundle.prefill is not None


def test_moe_blocks_are_not_ported():
    """MoE blocks are ported now: the block holds the MoE layer in place
    of the MLP, and the forward returns the layers' summed aux loss."""
    cfg = reduced(get_config("moonshot-v1-16b-a3b"))
    bundle = get_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0))
    assert "moe" in params["blocks"] and "mlp" not in params["blocks"]
    toks = torch.randint(0, cfg.vocab_size, (1, 16),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        _, aux = lm.forward_train(params, cfg, RunConfig(
            compute_dtype="float32"), {"tokens": toks})
    assert float(aux) > 0.0
