"""Port's MoE layer (``repro_torch/models/moe.py``) and the MoE LM against
``repro.models.moe`` / ``repro.models.lm``, from the same weights and
inputs: the routing (the chosen experts equal first, then the gates), the
dispatch tables with capacity drops, ``moe_apply`` and
``moe_apply_einsum`` against the reference and each other, and the
reduced moonshot (top-k 6 of 16 experts, and the reduced top-2 of 4) and
llama4-scout (top-1) models: forward and loss with the aux term, prefill
and decode with their caches. Tolerance: the f32 bar of
tests/test_kernels.py (atol=2e-5, rtol=2e-4). The routing tests state the
smallest gap between the router logits of a token's k-th and (k+1)-th
experts in their inputs: far above float32 rounding, so equal choices are
the contract, not luck."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import RunConfig as JRunConfig, reduced as jreduced
from repro.configs.registry import get_config as jget_config
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models.common import act_fn as jact_fn
from repro_torch.configs.base import RunConfig, reduced
from repro_torch.configs.registry import get_config
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import lm, moe
from repro_torch.models.common import act_fn, params_from_numpy
from repro_torch.models.registry import get_model

TOL = dict(atol=2e-5, rtol=2e-4)
# moonshot at its own top-6 (16 experts), the reduced moonshot (top-2 of
# 4) and llama4-scout (top-1 of 4)
CASES = {"moonshot-top6": ("moonshot-v1-16b-a3b",
                           dict(n_experts=16, top_k=6)),
         "moonshot": ("moonshot-v1-16b-a3b", {}),
         "llama4-scout": ("llama4-scout-17b-a16e", {})}
MIN_MARGIN = 1e-4


def _cfgs(case, **kw):
    arch, over = CASES[case]
    over = {**over, **kw}
    return jreduced(jget_config(arch), **over), reduced(get_config(arch),
                                                        **over)


def _moe_params(jcfg, seed=0):
    jp = {k: d for k, d in jmoe.moe_defs(jcfg).items()}
    rng = np.random.RandomState(seed)
    out = {k: (rng.randn(*d.shape) / np.sqrt(d.shape[-2] if len(d.shape) > 2
                                             else d.shape[0])
               ).astype(np.float32) for k, d in jp.items()}
    return ({k: jnp.asarray(v) for k, v in out.items()},
            params_from_numpy(out, "cpu"))


def _x(cfg, B, S, seed=1):
    x = np.random.RandomState(seed).randn(B, S, cfg.d_model).astype(
        np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _margin(logits: np.ndarray, k: int) -> float:
    """The smallest gap, over tokens, between the k-th largest router logit
    and the (k+1)-th."""
    s = -np.sort(-logits, axis=-1)
    return float((s[:, k - 1] - s[:, k]).min()) if s.shape[1] > k else 1.0


@pytest.mark.parametrize("case", list(CASES))
def test_route_picks_the_reference_s_experts(case):
    jcfg, cfg = _cfgs(case)
    jp, p = _moe_params(jcfg)
    jx, x = _x(cfg, 2, 64)
    jx, x = jx.reshape(-1, cfg.d_model), x.reshape(-1, cfg.d_model)
    assert _margin(np.asarray(jx @ jp["router"]), cfg.top_k) > MIN_MARGIN
    jidx, jgate, jaux = jmoe._route(jx, jp["router"], jcfg)
    idx, gate, aux = moe._route(x, p["router"], cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


@pytest.mark.parametrize("T,k,E,capacity", [(64, 2, 4, 8), (37, 6, 16, 8),
                                            (50, 1, 4, 8), (16, 2, 4, 64)])
def test_dispatch_tables_match_the_reference_with_drops(T, k, E, capacity):
    rng = np.random.RandomState(T * k)
    # skewed choices (distinct per token), so some experts overflow
    pref = rng.rand(T, E) + np.linspace(0, 1.5, E)[None]
    idx = np.argsort(-pref, axis=1)[:, :k].astype(np.int32)
    jtok, jslot = jmoe._dispatch_tables(jnp.asarray(idx), E, capacity)
    tok, slot = moe._dispatch_tables(torch.from_numpy(idx).long(), E,
                                     capacity)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    dropped = int((np.asarray(jslot) >= capacity).sum())
    assert (dropped > 0) == (capacity < T * k // E + 1)


@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_and_einsum_match_the_reference_and_each_other(case):
    jcfg, cfg = _cfgs(case)
    jp, p = _moe_params(jcfg)
    jx, x = _x(cfg, 2, 64)
    jrun = JRunConfig(compute_dtype="float32")
    jy, jaux = jmoe.moe_apply(jx, jp, jcfg, jrun)
    jye, jauxe = jmoe.moe_apply_einsum(jx, jp, jcfg)
    y, aux = moe.moe_apply(x, p, cfg, RunConfig(compute_dtype="float32"))
    ye, auxe = moe.moe_apply_einsum(x, p, cfg)
    for ours, ref in ((y, jy), (ye, jye), (ye, jy), (y, ye)):
        np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), **TOL)
    for a in (aux, auxe, jauxe):
        np.testing.assert_allclose(float(a), float(jaux), **TOL)


def test_moe_apply_drops_over_capacity_as_the_reference():
    """A capacity factor this low drops most (token, k) pairs; the port
    drops the same ones."""
    jcfg, cfg = _cfgs("moonshot-top6", capacity_factor=0.25)
    jp, p = _moe_params(jcfg)
    jx, x = _x(cfg, 2, 64)
    C = moe._capacity(128, cfg)
    idx, _, _ = moe._route(x.reshape(128, -1), p["router"], cfg)
    _, slot = moe._dispatch_tables(idx, cfg.n_experts, C)
    assert int((slot >= C).sum()) > 0
    jy, _ = jmoe.moe_apply(jx, jp, jcfg, JRunConfig(compute_dtype="float32"))
    y, _ = moe.moe_apply(x, p, cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


def test_moe_apply_refuses_a_mesh():
    """A mesh whose ``model`` axis does not divide the experts is refused
    before anything runs (the reference asserts the same); the
    expert-parallel path itself is held in tests/test_torch_dist.py."""
    _, cfg = _cfgs("moonshot")
    _, p = _moe_params(jreduced(jget_config("moonshot-v1-16b-a3b")))

    class Mesh3:
        mesh_dim_names, shape = ("data", "model"), (1, 3)

    assert cfg.n_experts % 3
    with pytest.raises(ValueError, match="not divisible by model=3"):
        moe.moe_apply(torch.zeros(1, 8, cfg.d_model), p, cfg, mesh=Mesh3())


def test_expert_ffn_matches_reference():
    rng = np.random.RandomState(3)
    xg, wg, wu, wd = (rng.randn(*s).astype(np.float32) for s in
                      ((4, 8, 16), (4, 16, 12), (4, 16, 12), (4, 12, 16)))
    want = jmoe._expert_ffn(*map(jnp.asarray, (xg, wg, wu, wd)),
                            jact_fn("silu"))
    got = moe._expert_ffn(*map(torch.from_numpy, (xg, wg, wu, wd)),
                          act_fn("silu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the MoE LM
# ---------------------------------------------------------------------------

def _lm(case, n_layers=2):
    jcfg, cfg = _cfgs(case, n_layers=n_layers)
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    jparams = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(7),
                                               a.shape), jparams)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    return jcfg, cfg, jparams, params


def _tokens(cfg, B, S, seed=2):
    t = np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S + 1))
    t = t.astype(np.int32)
    return ({"tokens": jnp.asarray(t[:, :-1]),
             "labels": jnp.asarray(t[:, 1:])},
            {"tokens": torch.from_numpy(t[:, :-1].copy()),
             "labels": torch.from_numpy(t[:, 1:].copy())})


@pytest.mark.parametrize("case", list(CASES))
def test_moe_lm_forward_and_loss_match_the_reference(case):
    jcfg, cfg, jparams, params = _lm(case)
    jb, tb = _tokens(cfg, 2, 64)
    jrun = JRunConfig(compute_dtype="float32", use_pallas=True)
    run = RunConfig(compute_dtype="float32", use_pallas=True)
    jlogits, jaux = jlm.forward_train(jparams, jcfg, jrun, jb)
    calls = []

    def spy(*a, **kw):
        calls.append(1)
        return ops.flash_attention(*a, **kw)

    with torch.no_grad():
        logits, aux = lm.forward_train(params, cfg, run, tb, flash=spy)
        loss = get_model(cfg).train_loss(params, run, tb)
    assert len(calls) == cfg.n_layers          # K2 in every layer
    assert float(aux) > 0.0
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(
        float(loss), float(jlm.train_loss(jparams, jcfg, jrun, jb)), **TOL)


@pytest.mark.parametrize("case", ["moonshot-top6", "llama4-scout"])
def test_moe_lm_prefill_and_decode_match_the_reference(case):
    jcfg, cfg, jparams, params = _lm(case)
    B, S, Smax = 2, 12, 16
    jrun, run = JRunConfig(compute_dtype="float32"), \
        RunConfig(compute_dtype="float32")
    toks = np.random.RandomState(4).randint(0, cfg.vocab_size, (B, S + 2))
    jcache = jlm.init_cache(jcfg, B, Smax, jnp.float32)
    cache = get_model(cfg).init_cache(B, Smax, torch.float32, "cpu")
    jl, jcache, _ = jlm.prefill(jparams, jcfg, jrun, jcache,
                                jnp.asarray(toks[:, :S], jnp.int32))
    with torch.no_grad():
        tl, cache, lens = lm.prefill(params, cfg, run, cache,
                                     torch.from_numpy(toks[:, :S]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    pos = np.array([S, S - 3], np.int32)
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
