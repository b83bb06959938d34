"""Port's serving control plane and example loop vs the JAX package's."""
import importlib.util
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import RunConfig as JRunConfig, reduced as jreduced
from repro.configs.registry import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.serving import engine as jengine, paged_lm as jpaged
from repro.serving.kv_cache import PagedAllocator as JPagedAllocator
from repro.serving.scheduler import SCHEDULERS as JSCHEDULERS
from repro.serving.types import default_clients as jdefault_clients
from repro_torch.launch import serve as tserve
from repro_torch.models import lm
from repro_torch.serving import engine as tengine
from repro_torch.serving.kv_cache import PagedAllocator
from repro_torch.serving.scheduler import SCHEDULERS
from repro_torch.serving.types import default_clients

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _example():
    spec = importlib.util.spec_from_file_location(
        "serve_heterogeneous_torch",
        ROOT / "examples" / "serve_heterogeneous_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_same_schedulers_registered():
    assert SCHEDULERS.names() == JSCHEDULERS.names()


@pytest.mark.parametrize("policy", ["fcfs", "locality", "sms",
                                    "sms_adaptive", "admission"])
def test_fairness_report_equal(policy):
    kw = dict(horizon_ms=400.0)
    port = tengine.fairness_report(policy, default_clients(),
                                   engine_cfg=tengine.EngineConfig(), **kw)
    ref = jengine.fairness_report(policy, jdefault_clients(),
                                  engine_cfg=jengine.EngineConfig(), **kw)
    assert port == ref


def test_run_serving_equal_on_a_client_subset():
    port = tengine.run_serving("sms", default_clients(), 400.0,
                               tengine.EngineConfig(max_slots=8), active={0, 4})
    ref = jengine.run_serving("sms", jdefault_clients(), 400.0,
                              jengine.EngineConfig(max_slots=8), active={0, 4})
    assert port == ref


def test_allocator_sequences_equal():
    rng = np.random.RandomState(3)
    a, b = PagedAllocator(48, 16), JPagedAllocator(48, 16)
    live = []
    for _ in range(300):
        if live and rng.rand() < 0.45:
            pages = live.pop(rng.randint(len(live)))
            a.free_seq(pages)
            b.free_seq(list(pages))
            continue
        total, pfx = int(rng.randint(1, 160)), int(rng.randint(-1, 3))
        plen = int(rng.randint(0, 64))
        got_a = a.alloc_seq(total, pfx if pfx >= 0 else None, prefix_len=plen)
        got_b = b.alloc_seq(total, pfx if pfx >= 0 else None, prefix_len=plen)
        assert got_a == got_b
        if got_a is not None:
            live.append(got_a[0])
            if rng.rand() < 0.3:
                assert a.extend_seq(got_a[0], total, total + 20) == \
                    b.extend_seq(got_b[0], total, total + 20)
        assert (a.free, a.refcount, a.prefix_pages) == \
            (b.free, b.refcount, b.prefix_pages)


def test_serve_cli_prints_the_same(monkeypatch, capsys):
    argv = ["serve", "--scheduler", "sms", "--horizon", "300", "--slots", "8"]
    outs = []
    for mod in (tserve, jserve):
        monkeypatch.setattr(sys, "argv", argv)
        mod.main()
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "[serve] max slowdown" in outs[0]


def test_example_loop_generates_the_same_tokens_as_jax():
    """The example's loop at its reduced size, once with the port's paged
    decode step and once with the JAX package's, from the same weights."""
    ex = _example()
    cfg = ex.example_config()
    jcfg = jreduced(jget_config("qwen1.5-4b"), n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                    vocab_size=256)
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    params = lm.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    jrun = JRunConfig(compute_dtype="float32")
    jpools = jpaged.init_pools(jcfg, n_pages=64, page_size=ex.PAGE)

    def jax_decode(_params, _cfg, _run, pools, tok, pos, pt, *, page_size):
        nonlocal jpools
        logits, jpools = jpaged.paged_decode_step(
            jparams, jcfg, jrun, jpools, jnp.asarray(tok.numpy()),
            jnp.asarray(pos.numpy()), jnp.asarray(pt.numpy()),
            page_size=page_size)
        return torch.from_numpy(np.array(logits)), pools

    def tokens(decode):
        out = {}
        for rec in ex.serve(cfg, params, "cpu", ex.example_requests(),
                            decode=decode):
            out.update({r.rid: toks for r, toks in rec["finished"]})
        return out

    port, ref = tokens(ex.paged_lm.paged_decode_step), tokens(jax_decode)
    assert sorted(port) == list(range(7))
    assert port == ref
