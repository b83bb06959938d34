"""The port's `simulate` driver against the reference's: every metric of a
W = 3 batch equal with `np.array_equal`, the pool checks raising the same
errors, and the registry's enumerations."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import simulator as jsim  # noqa: E402
from repro.core import workloads as jwl  # noqa: E402
from repro.core.params import SimConfig as JConfig  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core import workloads as twl  # noqa: E402
from repro_torch.core.params import SimConfig  # noqa: E402

N_CYCLES, WARMUP = 300, 100
# 3 CPUs + GPU + a frame-deadline HWA with jitter on 2 channels (SMS-DASH
# preempts for it); the paper's 4-channel layout at 16 cores
CASES = {
    "hwa2ch": dict(n_cpu=3, n_hwa=1, n_channels=2, buf_entries=40,
                   fifo_size=5, dcs_size=3),
    "paper4ch": dict(n_cpu=16, n_channels=4, buf_entries=134, fifo_size=6,
                     dcs_size=4),
}


def _batch(kw):
    cfg = JConfig(**kw)
    wls = jwl.make_workloads(cfg.n_cpu, n_per_cat=1, seed=4,
                             n_hwa=cfg.n_hwa)
    pool, active = jwl.pool_batch(cfg, [wls[i] for i in (0, 3, 6)])
    # frames short enough for several deadlines in the measured window
    hwa = pool["src_class"] == 2
    pool["dl_period"] = np.where(hwa, 150, 0).astype(np.int32)
    pool["dl_reqs"] = np.where(hwa, 40, 0).astype(np.int32)
    return pool, active


@pytest.mark.parametrize("policy,case", [
    ("frfcfs", "hwa2ch"), ("sms", "hwa2ch"), ("sms_dash", "hwa2ch"),
    ("frfcfs", "paper4ch"), ("sms", "paper4ch")])
def test_simulate_metrics_equal_reference(policy, case):
    kw = CASES[case]
    pool, active = _batch(kw)
    want = jsim.simulate(JConfig(**kw), policy, pool, active, N_CYCLES,
                         WARMUP)
    got = tsim.simulate(SimConfig(**kw), policy, pool, active, N_CYCLES,
                        WARMUP, device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k
    assert got["completed"].sum() > 0
    if case == "hwa2ch":
        assert got["frames_released"].sum() > 0


def test_perf_vector_matches_reference():
    kw = CASES["hwa2ch"]
    pool, active = _batch(kw)
    rng = np.random.RandomState(0)
    m = {"ipc": rng.rand(*active.shape), "bw": rng.rand(*active.shape)}
    assert np.array_equal(tsim.perf_vector(SimConfig(**kw), m, pool),
                          jsim.perf_vector(JConfig(**kw), m, pool))
    legacy = {k: pool[k] for k in ("is_gpu", "dl_period")}
    assert np.array_equal(tsim.perf_vector(SimConfig(**kw), m, legacy),
                          jsim.perf_vector(JConfig(**kw), m, legacy))


def _bad_pools():
    S = 4
    base = {"mpki": np.ones(S, np.float32),
            "inst_per_miss": np.ones(S, np.float32),
            "rbl": np.full(S, 0.5, np.float32), "blp": np.ones(S, np.int32),
            "is_gpu": np.asarray([False, False, False, True])}
    bad = {
        "shape": {**base, "rbl": np.ones(S + 1, np.float32)},
        "float_dtype": {**base, "mpki": np.asarray(["a"] * S)},
        "int_dtype": {**base, "blp": np.ones(S, np.float32)},
        "bool_dtype": {**base, "is_gpu": np.zeros(S, np.int32)},
        "negative": {**base, "dl_period": np.asarray([0, -5, 0, 0])},
        "class": {**base, "src_class": np.asarray([0, 0, 3, 1], np.int32)},
    }
    return base, bad


@pytest.mark.parametrize("which", ["shape", "float_dtype", "int_dtype",
                                   "bool_dtype", "negative", "class"])
def test_prepare_pool_raises_the_same_errors(which):
    _, bad = _bad_pools()
    with pytest.raises(ValueError) as te:
        tsim.prepare_pool(bad[which], (4,), device="cpu")
    with pytest.raises(ValueError) as je:
        jsim.prepare_pool(bad[which], (4,))
    assert str(te.value) == str(je.value)


def test_prepare_pool_completes_the_schema():
    base, _ = _bad_pools()
    for pool in (base, {**base, "dl_period": np.asarray([0, 400, 0, 0],
                                                        np.int64)}):
        got = tsim.prepare_pool(pool, (4,), device="cpu")
        want = jsim.prepare_pool(pool, (4,))
        assert got.keys() == want.keys()
        for k in want:
            g, w = got[k].numpy(), np.asarray(want[k])
            assert g.dtype == w.dtype and np.array_equal(g, w), k


def test_registry_enumerations():
    # the reference's registration order, which is every sweep's order
    assert tpolicy.baseline_names()[:7] == (
        "frfcfs", "atlas", "parbs", "tcm", "sms", "bliss", "squash_prio")
    assert tpolicy.names()[:8] == (
        "frfcfs", "atlas", "parbs", "tcm", "sms", "sms_dash", "bliss",
        "squash_prio")
    from repro.core import policy as jpolicy
    assert tpolicy.names()[:8] == jpolicy.names()[:8]
    assert tsim.POLICIES == tpolicy.baseline_names()
    assert tsim.ALL_POLICIES == tpolicy.names()
    assert tpolicy.get("sms_dash").variant_of == "sms"
    assert "sms_dash" not in tsim.POLICIES
    with pytest.raises(ValueError, match="duplicate"):
        tpolicy.POLICY_REGISTRY.register("sms")(object())
    with pytest.raises(KeyError, match="unknown memory policy"):
        tpolicy.get("atlas-not-registered")
    kn = tpolicy.resolve_knobs(SimConfig(), tpolicy.get("sms_dash"))
    assert bool(kn.dash) and not bool(
        tpolicy.resolve_knobs(SimConfig(), tpolicy.get("sms")).dash)


def test_workload_batch_is_the_reference_batch():
    cfg = SimConfig(n_cpu=16, n_channels=4)
    pool, active = twl.pool_batch(cfg, twl.make_workloads(16, n_per_cat=2))
    jpool, jactive = jwl.pool_batch(JConfig(n_cpu=16, n_channels=4),
                                    jwl.make_workloads(16, n_per_cat=2))
    assert active.shape == (14, 17) and np.array_equal(active, jactive)
    assert all(np.array_equal(pool[k], jpool[k]) for k in pool)


def test_boundary_gate_and_cached_priority_match_reference():
    """A ranked policy on the centralized substrate, written in both
    packages: every 50 cycles a cycle-only boundary re-ranks the sources by
    completed requests into `pri_src` (stable ranks, ties by index), which
    the default score adds above the FR-FCFS base. Covers `tick_hooks`'s
    gate, `rank_pos` and the cached-priority score against the reference."""
    import jax.numpy as jnp
    from repro.core import policy as jpolicy
    from repro.core import schedulers as jsched
    from repro_torch.core import schedulers as tsched

    class JRanked(jsched.CentralizedPolicy):
        name = "_ranked_parity"
        boundary_keys = ("pri_src",)

        def extra_state(self, cfg):
            return {"pri_src": jnp.zeros((cfg.n_src,), jnp.int32)}

        def boundary_pred(self, cfg, pool, st, buf, t):
            return jnp.mod(t, 50) == 0

        def boundary_tick(self, cfg, pool, st, buf, t):
            rank = jsched.rank_pos(-st["completed"])
            return {**buf, "pri_src": rank << jsched.RANK_SHIFT}

    class TRanked(tsched.CentralizedPolicy):
        name = "_ranked_parity"
        boundary_keys = ("pri_src",)

        def extra_state(self, cfg, W, device):
            return {"pri_src": torch.zeros((W, cfg.n_src), dtype=torch.int32,
                                           device=device)}

        def boundary_pred(self, cfg, pool, st, buf, t):
            return t % 50 == 0

        def boundary_tick(self, cfg, pool, st, buf, t):
            rank = tsched.rank_pos(-st["completed"])
            return {**buf, "pri_src": rank << tsched.RANK_SHIFT}

    kw = CASES["hwa2ch"]
    pool, active = _batch(kw)
    pool1 = {k: v[1] for k, v in pool.items()}
    jpolicy.POLICY_REGISTRY.register(JRanked.name)(JRanked())
    tpolicy.POLICY_REGISTRY.register(TRanked.name)(TRanked())
    try:
        want = jsim.simulate_debug(JConfig(**kw), JRanked.name, pool1,
                                   active[1], n_cycles=420)
        got = tsim.simulate_debug(SimConfig(**kw), TRanked.name, pool1,
                                  active[1], n_cycles=420, device="cpu")
    finally:
        jpolicy.POLICY_REGISTRY._entries.pop(JRanked.name)
        tpolicy.POLICY_REGISTRY._entries.pop(TRanked.name)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    assert got[1]["pri_src"].any()
