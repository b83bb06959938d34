"""Port's paged decode step vs the JAX package's, from the same weights."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import RunConfig as JRunConfig, reduced as jreduced
from repro.configs.registry import get_config as jget_config
from repro.models import lm as jlm
from repro.serving import paged_lm as jpaged
from repro_torch.configs.base import RunConfig, reduced
from repro_torch.configs.registry import get_config
from repro_torch.models import lm
from repro_torch.serving import paged_lm

TOL = dict(atol=2e-4, rtol=2e-3)     # tests/test_serving.py paged-LM bar
ARCHS = ["qwen1.5-4b", "gemma2-2b"]  # QKV bias + silu; softcap, post-norm,
                                     # tied embeddings + gelu


def _setup(arch, n_layers=2):
    jcfg = jreduced(jget_config(arch), n_layers=n_layers)
    cfg = reduced(get_config(arch), n_layers=n_layers)
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    # non-zero biases and norm scales, so every parameter takes part
    jparams = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(7),
                                               a.shape), jparams)
    params = lm.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _step_both(jcfg, cfg, jparams, params, jpools, pools, tok, pos, pt, page):
    jl, jpools = jpaged.paged_decode_step(
        jparams, jcfg, JRunConfig(compute_dtype="float32"), jpools,
        jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32),
        jnp.asarray(pt, jnp.int32), page_size=page)
    tl, pools = paged_lm.paged_decode_step(
        params, cfg, RunConfig(compute_dtype="float32"), pools,
        torch.tensor(tok, dtype=torch.int32),
        torch.tensor(pos, dtype=torch.int32),
        torch.tensor(pt, dtype=torch.int32), page_size=page)
    return np.asarray(jl), tl.numpy(), jpools, pools


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_matches_jax_across_pages(arch):
    jcfg, cfg, jparams, params = _setup(arch)
    page, n_pages = 4, 16
    pt = np.array([[3, 0, 7, 9], [1, 12, 5, 2], [4, 6, 8, 10]], np.int32)
    start = np.array([0, 2, 5])
    rng = np.random.RandomState(0)
    jpools = jpaged.init_pools(jcfg, n_pages=n_pages, page_size=page)
    pools = paged_lm.init_pools(cfg, n_pages=n_pages, page_size=page,
                                device="cpu")
    for t in range(11):                       # crosses pages at 4 and 8
        tok = rng.randint(0, cfg.vocab_size, 3)
        jl, tl, jpools, pools = _step_both(jcfg, cfg, jparams, params,
                                           jpools, pools, tok, start + t, pt,
                                           page)
        np.testing.assert_allclose(tl, jl, **TOL)
    for kv in ("k", "v"):
        np.testing.assert_allclose(pools[kv].numpy(), np.asarray(jpools[kv]),
                                   **TOL)


def test_duplicate_pool_write_keeps_the_last_writer():
    """Two sequences write the same (page, offset) in one step, as replayed
    shared-prefix prompts do: the later row wins, as in the JAX package."""
    jcfg, cfg, jparams, params = _setup("qwen1.5-4b")
    page, n_pages = 4, 8
    pt = np.array([[2, 5], [2, 6], [3, 7]], np.int32)
    tok, pos = np.array([11, 22, 33]), np.array([1, 1, 1])
    jpools = jpaged.init_pools(jcfg, n_pages=n_pages, page_size=page)
    pools = paged_lm.init_pools(cfg, n_pages=n_pages, page_size=page,
                                device="cpu")
    jl, tl, jpools, pools = _step_both(jcfg, cfg, jparams, params, jpools,
                                       pools, tok, pos, pt, page)
    np.testing.assert_allclose(tl, jl, **TOL)
    for kv in ("k", "v"):
        np.testing.assert_allclose(pools[kv].numpy(), np.asarray(jpools[kv]),
                                   **TOL)
    # the shared slot holds what the second sequence writes alone, not
    # what the first one does
    alone = []
    for b in (0, 1):
        p1 = paged_lm.init_pools(cfg, n_pages=n_pages, page_size=page,
                                 device="cpu")
        paged_lm.paged_decode_step(
            params, cfg, RunConfig(compute_dtype="float32"), p1,
            torch.tensor(tok[b:b + 1], dtype=torch.int32),
            torch.tensor(pos[b:b + 1], dtype=torch.int32),
            torch.tensor(pt[b:b + 1], dtype=torch.int32), page_size=page)
        alone.append(p1)
    for kv in ("k", "v"):
        slot = pools[kv][:, 2, :, 1].numpy()
        np.testing.assert_allclose(slot, alone[1][kv][:, 2, :, 1].numpy(),
                                   atol=1e-5, rtol=1e-5)
        assert not np.allclose(slot, alone[0][kv][:, 2, :, 1].numpy(),
                               atol=1e-2)


def test_plain_attention_hook_gives_same_logits():
    """``attention=`` swaps in the plain version (chip_smoke's check); on
    the CPU the wrapper already takes it, so the logits are identical."""
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    _, cfg, _, params = _setup("gemma2-2b")
    run = RunConfig(compute_dtype="float32")
    args = (torch.tensor([5, 6], dtype=torch.int32),
            torch.tensor([3, 4], dtype=torch.int32),
            torch.tensor([[0, 1], [2, 3]], dtype=torch.int32))
    outs = []
    for fn in (paged_lm.paged_attention, paged_attention_ref):
        pools = paged_lm.init_pools(cfg, n_pages=4, page_size=4, device="cpu")
        outs.append(paged_lm.paged_decode_step(
            params, cfg, run, pools, *args, page_size=4, attention=fn)[0])
    assert torch.equal(outs[0], outs[1])
