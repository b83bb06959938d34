"""The port's invariant sanitizer and fault injectors against the
reference's: the counter layout; every policy clean, ticked and skipping,
solo and stacked, with the golden digests holding under the sanitizer;
`simulate_debug(skip=True)` with the sanitizer on equal to the reference's
(every array, `viol` included); under each fault, the port's counter vector
equal to the reference's under the same fault; `debug_check` raising at
the reference's first violating cycle."""
import hashlib
import json
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import faults as jfaults  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import validate as jvalidate  # noqa: E402
from repro.core.params import SimConfig as JConfig  # noqa: E402
from repro_torch.core import energy, engine, faults, qos  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core import validate  # noqa: E402
from repro_torch.core.params import SimConfig  # noqa: E402

POLICIES = ("frfcfs", "atlas", "parbs", "tcm", "sms", "sms_dash", "bliss",
            "squash_prio")
FAMILY = ("frfcfs", "atlas", "parbs", "tcm", "bliss", "squash_prio")
GKW = dict(n_cpu=3, n_gpu=1, n_channels=2, buf_entries=24, fifo_size=5,
           dcs_size=3, validate_enabled=True)
CFG = SimConfig(**GKW)
GOLDEN = json.loads(
    (Path(__file__).parent / "golden_policy_states.json").read_text())
N_GOLDEN, N_TICK = 1_500, 300


def golden_pool(cfg):
    """The goldens' capture-time pool (seed 42)."""
    rng = np.random.RandomState(42)
    S = cfg.n_src
    mpki = rng.uniform(2, 40, S).astype(np.float32)
    pool = {
        "mpki": mpki,
        "inst_per_miss": np.maximum(1000.0 / mpki, 1.0).astype(np.float32),
        "rbl": rng.uniform(0.1, 0.95, S).astype(np.float32),
        "blp": rng.randint(1, 7, S).astype(np.int32),
        "is_gpu": np.asarray([False] * cfg.n_cpu + [True]),
        "dl_period": np.zeros(S, np.int32),
        "dl_reqs": np.zeros(S, np.int32),
    }
    pool["dl_period"][0] = 400
    pool["dl_reqs"][0] = 35
    return pool


def fault_pool(seed, S, idle=False):
    """The reference's sanitizer pool (tests/test_validate.py)."""
    rs = np.random.RandomState(seed)
    pool = {
        "mpki": (np.full((S,), 0.5, np.float32) if idle
                 else rs.uniform(1.0, 40.0, S).astype(np.float32)),
        "inst_per_miss": rs.uniform(30.0, 300.0, S).astype(np.float32),
        "rbl": rs.uniform(0.1, 0.95, S).astype(np.float32),
        "blp": rs.randint(1, 5, S).astype(np.int32),
        "is_gpu": np.zeros((S,), bool),
        "dl_period": np.zeros((S,), np.int32),
        "dl_reqs": np.zeros((S,), np.int32),
        "dl_jitter": np.zeros((S,), np.int32),
    }
    if not idle:
        pool["is_gpu"][-1] = True
    pool["dl_period"][0] = int(rs.randint(200, 600))
    pool["dl_reqs"][0] = int(rs.randint(5, 40))
    return pool


def digest(tree):
    out = {}
    for key in sorted(tree):
        v = np.ascontiguousarray(tree[key])
        h = hashlib.sha1()
        h.update(str(v.dtype).encode())
        h.update(str(v.shape).encode())
        h.update(v.tobytes())
        out[key] = h.hexdigest()
    return out


def nonzero(dram):
    return {k: v for k, v in validate.summarize(dram["viol"]).items() if v}


def test_counter_layout_and_fault_registry_match_the_reference():
    assert validate.VIOLATIONS == jvalidate.VIOLATIONS
    assert validate.NV == jvalidate.NV == 15
    assert validate.STATE_KEYS == jvalidate.STATE_KEYS
    assert faults.TARGETS == jfaults.TARGETS
    assert faults.SKIP_ONLY == jfaults.SKIP_ONLY
    assert faults.STACKED_ONLY == jfaults.STACKED_ONLY
    assert sorted(faults.FAULTS) == sorted(jfaults.FAULTS)
    v = np.arange(2 * validate.NV).reshape(2, validate.NV)
    assert validate.summarize(v) == jvalidate.summarize(v)
    assert "viol" not in engine.dram_state(SimConfig(), 1, "cpu")


# ---------------------------------------------------------------------------
# clean runs: every policy, ticked and skipping, solo and stacked
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def debug_runs():
    """{(policy, skip): port final state} at the goldens' configuration,
    sanitizer on (the ticked runs shorter: the skipping ones carry the
    goldens), and the reference's skipping runs."""
    pool, on = golden_pool(CFG), np.ones(CFG.n_src, bool)
    port = {(p, s): tsim.simulate_debug(CFG, p, pool, on,
                                        N_GOLDEN if s else N_TICK, skip=s,
                                        device="cpu")
            for p in POLICIES for s in (False, True)}
    ref = {p: jsim.simulate_debug(JConfig(**GKW), p, pool, on, N_GOLDEN,
                                  skip=True) for p in POLICIES}
    return port, ref


@pytest.mark.parametrize("skip", [False, True], ids=["tick", "skip"])
@pytest.mark.parametrize("policy", POLICIES)
def test_every_policy_clean_and_goldens_hold(policy, skip, debug_runs):
    """Clean ticked and skipping; the skipping run (1,500 cycles) reproduces
    the golden digests with the sanitizer on."""
    st_f, sched_f, dram_f = debug_runs[0][(policy, skip)]
    assert dram_f["viol"].shape == (validate.NV,)
    assert not nonzero(dram_f), (policy, skip, nonzero(dram_f))
    if policy not in GOLDEN or not skip:
        return
    g = GOLDEN[policy]
    for part, tree in (("src", st_f), ("dram", dram_f)):
        new = digest(tree)
        allowed = set(energy.STATE_KEYS) | set(qos.STATE_KEYS) \
            | set(validate.STATE_KEYS) if part == "dram" \
            else set(engine.NCLASS_SRC_KEYS)
        assert set(new) ^ set(g[part]) <= allowed
        for k, h in g[part].items():
            assert new[k] == h, f"{policy} {part}[{k}] diverged"
    sched = digest(sched_f)
    for k in set(sched) & set(g["sched"]):
        assert sched[k] == g["sched"][k], f"{policy} sched[{k}] diverged"


@pytest.mark.parametrize("policy", POLICIES)
def test_simulate_debug_skip_equals_reference(policy, debug_runs):
    """Every final array of the skipping run, `viol` included, equals the
    reference's `simulate_debug(skip=True)`."""
    got, want = debug_runs[0][(policy, True)], debug_runs[1][policy]
    for part, g, w in zip(("src", "sched", "dram"), got, want):
        assert g.keys() == w.keys(), (policy, part)
        for k in w:
            assert g[k].dtype == np.asarray(w[k]).dtype, (policy, part, k)
            assert np.array_equal(g[k], np.asarray(w[k])), (policy, part, k)


@pytest.mark.parametrize("skip", [False, True], ids=["tick", "skip"])
def test_stacked_family_clean(skip):
    out = tsim.simulate_debug_stacked(CFG, FAMILY, golden_pool(CFG),
                                      np.ones(CFG.n_src, bool), 900,
                                      skip=skip, device="cpu")
    for pol, (_, _, dram) in out.items():
        assert not nonzero(dram), (pol, skip, nonzero(dram))


def test_grid_and_nondefault_points_clean():
    """The sanitizer's per-slice hooks on the folded steps: value and period
    knobs off their defaults, skipping."""
    pool = fault_pool(11, CFG.n_src)
    batch = {k: v[None] for k, v in pool.items()}
    on = np.ones((1, CFG.n_src), bool)
    grid = tsim.simulate_grid(CFG, "sms", ({}, {"batch_age_cap": 100,
                                               "dash": True}),
                              batch, on, 500, 100, skip=True, device="cpu")
    sgrid = tsim.simulate_stacked_grid(
        CFG, (("parbs", {"parbs_cap": 2}), ("atlas", {"atlas_epoch": 96}),
              ("squash_prio", {"squash_epoch": 64})),
        batch, on, 500, 100, skip=True, device="cpu")
    for m in grid + sgrid:
        assert not m["violations"].any()


# ---------------------------------------------------------------------------
# falsifiability: each fault flips its counters, as the reference's does
# ---------------------------------------------------------------------------

def _fault_run(pkg_sim, pkg_faults, cfg, fault, **kw):
    skip = fault in pkg_faults.SKIP_ONLY
    pool = fault_pool(7, cfg.n_src, idle=skip)
    active = np.ones(cfg.n_src, bool)
    with pkg_faults.inject(fault):
        if fault in pkg_faults.STACKED_ONLY:
            out = pkg_sim.simulate_debug_stacked(cfg, ("frfcfs", "parbs"),
                                                 pool, active, 800,
                                                 skip=False, **kw)
            return np.asarray(out["parbs"][2]["viol"])
        st_f = pkg_sim.simulate_debug(cfg, "frfcfs", pool, active, 800,
                                      skip=skip, **kw)
        return np.asarray(st_f[2]["viol"])


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_flips_target_and_equals_reference(fault):
    got = _fault_run(tsim, faults, CFG, fault, device="cpu")
    want = _fault_run(jsim, jfaults, JConfig(**GKW), fault)
    summary = validate.summarize(got)
    assert sum(summary[k] for k in faults.TARGETS[fault]) > 0, summary
    assert got.dtype == want.dtype
    assert np.array_equal(got, want), (fault, summary,
                                       jvalidate.summarize(want))


def test_fault_injection_restores_cleanly():
    pool = fault_pool(7, CFG.n_src)
    active = np.ones(CFG.n_src, bool)
    with faults.inject("stacked_writeset"):
        pass
    parbs = tpolicy.get("parbs")
    assert "msub" in parbs.stacked_tick_keys
    assert "msub" in parbs.stacked_issue_keys
    with pytest.raises(RuntimeError):
        with faults.inject("dropped_completion"):
            raise RuntimeError("inside")
    st_f = tsim.simulate_debug(CFG, "frfcfs", pool, active, 400,
                               device="cpu")
    assert not nonzero(st_f[2])
    with pytest.raises(KeyError, match="unknown fault"):
        faults.inject("nope")


def test_debug_check_raises_at_the_reference_cycle():
    pool = fault_pool(7, CFG.n_src)
    active = np.ones(CFG.n_src, bool)
    st_f = validate.debug_check(CFG.replace(validate_enabled=False),
                                "frfcfs", pool, active, n_cycles=300,
                                device="cpu")
    assert not st_f[2]["viol"].any()
    with faults.inject("dropped_completion"):
        with pytest.raises(validate.InvariantViolation,
                           match="invariant violation at cycle") as got:
            validate.debug_check(CFG, "frfcfs", pool, active, n_cycles=400,
                                 device="cpu")
    with jfaults.inject("dropped_completion"):
        with pytest.raises(Exception,
                           match="invariant violation at cycle") as want:
            jvalidate.debug_check(JConfig(**GKW), "frfcfs", pool, active,
                                  n_cycles=400)
    cycle = lambda e: int(re.search(r"at cycle (\d+)", str(e.value)).group(1))
    assert cycle(got) == cycle(want)
