"""Port's Whisper (``repro_torch/models/whisper.py``) against
``repro.models.whisper`` from the same weights and audio embeddings: the
encoder, ``train_loss`` and the logits, prefill and decode logits with
both caches (the self-attention's, written at ``pos``; the
cross-attention's, written once at prefill and carried unchanged), and
``use_pallas``: at 64 encoder frames both packages compute (the reference
through its Pallas kernel in interpret mode, the port's wrapper through
its plain version on the CPU, one call per attention); at 100 frames and
a decoder of 64 tokens both raise the reference's block assertion, the
port before any kernel call. Reduced config (2 + 2 layers, d 128).
Tolerance: the f32 bar of tests/test_kernels.py (atol=2e-5, rtol=2e-4),
for logits with its atol taken times the largest |logit|, as in
tests/test_torch_hymba.py."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import RunConfig as JRunConfig, reduced as jreduced
from repro.configs.registry import get_config as jget_config
from repro.models import whisper as jwhisper
from repro.models.common import sinusoidal_positions as jsinusoidal
from repro_torch.configs.base import RunConfig, reduced
from repro_torch.configs.registry import get_config
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import whisper
from repro_torch.models.common import params_from_numpy, sinusoidal_positions
from repro_torch.models.registry import get_model

TOL = dict(atol=2e-5, rtol=2e-4)


def _logits_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=TOL["rtol"],
        atol=TOL["atol"] * max(1.0, float(np.abs(want).max())))


def _setup(encoder_seq=64):
    jcfg = jreduced(jget_config("whisper-large-v3"), encoder_seq=encoder_seq)
    cfg = reduced(get_config("whisper-large-v3"), encoder_seq=encoder_seq)
    jparams = jwhisper.init(jax.random.PRNGKey(0), jcfg)
    jparams = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(7),
                                               a.shape), jparams)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    return jcfg, cfg, jparams, params


def _batch(cfg, B, S, seed=1):
    rng = np.random.RandomState(seed)
    t = rng.randint(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    audio = rng.randn(B, cfg.encoder_seq, cfg.d_model).astype(np.float32)
    out = {"tokens": t[:, :-1].copy(), "labels": t[:, 1:].copy(),
           "audio_embeds": audio}
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def test_sinusoidal_positions_match_reference():
    for n, d in ((1, 8), (64, 128), (1500, 1280)):
        np.testing.assert_array_equal(sinusoidal_positions(n, d).numpy(),
                                      np.asarray(jsinusoidal(n, d)))


def test_encoder_matches_reference():
    jcfg, cfg, jparams, params = _setup()
    jb, tb = _batch(cfg, 2, 16)
    run = dict(compute_dtype="float32")
    want = jwhisper.encode(jparams, jcfg, JRunConfig(**run),
                           jb["audio_embeds"])
    with torch.no_grad():
        got = whisper.encode(params, cfg, RunConfig(**run),
                             tb["audio_embeds"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_and_loss_match_reference(use_pallas, monkeypatch):
    """At 64 frames and 64 tokens every attention fits the kernel's blocks:
    3 calls per decoder layer and 1 per encoder layer (the port's wrapper
    runs ``ops.attention_ref`` on the CPU, spied on here)."""
    jcfg, cfg, jparams, params = _setup()
    jb, tb = _batch(cfg, 2, 64)
    calls, real = [], ops.attention_ref
    monkeypatch.setattr(ops, "attention_ref",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    kw = dict(compute_dtype="float32", use_pallas=use_pallas)
    jrun, run = JRunConfig(**kw), RunConfig(**kw)
    jlogits, _ = jwhisper.forward_train(jparams, jcfg, jrun, jb)
    with torch.no_grad():
        logits, aux = whisper.forward_train(params, cfg, run, tb)
    assert len(calls) == (2 * cfg.n_layers + cfg.n_encoder_layers
                          if use_pallas else 0)
    with torch.no_grad():
        loss = get_model(cfg).train_loss(params, run, tb)
    assert float(aux) == 0.0
    _logits_close(logits.numpy(), jlogits)
    np.testing.assert_allclose(
        float(loss), float(jwhisper.train_loss(jparams, jcfg, jrun, jb)),
        **TOL)


def test_cross_attention_over_100_frames_refuses_as_the_reference(
        monkeypatch):
    """The reference's kernel asserts that its 64-key blocks divide the
    100 encoder frames; its ``_pallas_ok`` looked at the 64 decoder tokens
    only. The port raises the same error, before its wrapper is called for
    the cross-attention."""
    jcfg, cfg, jparams, params = _setup(encoder_seq=100)
    jb, tb = _batch(cfg, 2, 64)
    kw = dict(compute_dtype="float32", use_pallas=True)
    msg = r"seq \(64,100\) must divide blocks \(64,64\)"
    with pytest.raises(AssertionError, match=msg):
        jwhisper.train_loss(jparams, jcfg, JRunConfig(**kw), jb)
    shapes, real = [], ops.attention_ref
    monkeypatch.setattr(ops, "attention_ref", lambda q, k, v, **a: (
        shapes.append((q.shape[2], k.shape[2])) or real(q, k, v, **a)))
    with torch.no_grad(), pytest.raises(AssertionError, match=msg):
        get_model(cfg).train_loss(params, RunConfig(**kw), tb)
    # the encoder (100 frames) takes the plain path in both; the first
    # decoder layer's self-attention (64 x 64) reached the kernel
    assert shapes == [(64, 64)]
    with torch.no_grad():      # without use_pallas both compute
        loss = get_model(cfg).train_loss(params, RunConfig(
            compute_dtype="float32"), tb)
    np.testing.assert_allclose(
        float(loss), float(jwhisper.train_loss(
            jparams, jcfg, JRunConfig(compute_dtype="float32"), jb)), **TOL)


def test_prefill_and_decode_match_reference():
    jcfg, cfg, jparams, params = _setup()
    B, S, Smax = 2, 10, 16
    jrun, run = JRunConfig(compute_dtype="float32"), \
        RunConfig(compute_dtype="float32")
    jb, tb = _batch(cfg, B, S + 3)
    jcache = jwhisper.init_cache(jcfg, B, Smax, jnp.float32)
    cache = get_model(cfg).init_cache(B, Smax, torch.float32, "cpu")
    jl, jcache, jlen = jwhisper.prefill(
        jparams, jcfg, jrun, jcache, jb["tokens"][:, :S],
        extra={"audio_embeds": jb["audio_embeds"]})
    with torch.no_grad():
        tl, cache, lens = get_model(cfg).prefill(
            params, run, cache, tb["tokens"][:, :S],
            extra={"audio_embeds": tb["audio_embeds"]})
    _logits_close(tl.numpy(), jl)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlen))
    cross = {k: cache[k].clone() for k in ("ck", "cv")}
    pos = np.full((B,), S, np.int32)
    for t in range(3):
        jl, jcache = jwhisper.decode_step(jparams, jcfg, jrun, jcache,
                                          jb["tokens"][:, S + t],
                                          jnp.asarray(pos + t))
        with torch.no_grad():
            tl, cache = get_model(cfg).decode_step(
                params, run, cache, tb["tokens"][:, S + t],
                torch.from_numpy(pos + t))
        _logits_close(tl.numpy(), jl)
    assert set(cache) == set(jcache) == {"k", "v", "ck", "cv"}
    for k in cache:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   err_msg=k, **TOL)
    for k in ("ck", "cv"):          # written once, carried unchanged
        assert torch.equal(cache[k], cross[k])


def test_prefill_then_decode_equals_forward():
    _, cfg, _, params = _setup()
    bundle = get_model(cfg)
    run = RunConfig(compute_dtype="float32")
    _, tb = _batch(cfg, 2, 12)
    with torch.no_grad():
        full, _ = whisper.forward_train(params, cfg, run, tb)
        cache = bundle.init_cache(2, 12, torch.float32, "cpu")
        lg, cache, lens = bundle.prefill(
            params, run, cache, tb["tokens"][:, :9],
            extra={"audio_embeds": tb["audio_embeds"]})
        _logits_close(lg.numpy(), full[:, 8].numpy())
        for t in range(9, 12):
            lg, cache = bundle.decode_step(params, run, cache,
                                           tb["tokens"][:, t], lens)
            lens = lens + 1
            _logits_close(lg.numpy(), full[:, t].numpy())
