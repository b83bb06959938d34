"""The port's folded drivers through the variable-step driver (`skip=True`)
against the reference's: `simulate_stacked` (one clock per workload across
the family, so `sim_steps` is family-common per workload), `simulate_grid`
(one clock per (workload, point)) for a stacked-family policy and for sms,
`simulate_stacked_grid` with period and value overrides, and
`simulate_debug_stacked` against the reference's and the golden digests;
the stacked family skipping against ticking in the port."""
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import simulator as jsim  # noqa: E402
from repro.core.params import SimConfig as JConfig  # noqa: E402
from repro_torch.core import energy, engine, qos, telemetry  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core.params import (CLS_CPU, CLS_GPU, CLS_HWA,  # noqa: E402
                                     SimConfig)

FAMILY = ("frfcfs", "atlas", "parbs", "tcm", "bliss", "squash_prio")
KW3 = dict(n_cpu=3, n_gpu=1, n_hwa=2, n_channels=2, buf_entries=24,
           fifo_size=5, dcs_size=3, atlas_epoch=150, tcm_quantum=120,
           bliss_clear_interval=200, squash_epoch=128)
ON = dict(validate_enabled=True, telemetry_enabled=True, telemetry_window=16,
          telemetry_epoch=64)
WARMUP, N_CYCLES = 100, 400
GKW = dict(n_cpu=3, n_gpu=1, n_channels=2, buf_entries=24, fifo_size=5,
           dcs_size=3)
GOLDEN = json.loads(
    (Path(__file__).parent / "golden_policy_states.json").read_text())
GRID_POINTS = {"atlas": ({}, {"cpu_reserve": 0.25, "atlas_alpha": 0.75}),
               "sms": ({}, {"dash": True, "sjf_prob": 0.5})}
STACKED_GRID = (("atlas", {"atlas_epoch": 100, "atlas_alpha": 0.75}),
                ("frfcfs", {"cpu_reserve": 0.25}),
                ("squash_prio", {"squash_epoch": 64, "squash_lead": 40}),
                ("tcm", {}))


def mix_pool():
    """(W=2, S=6): row 0 a busy 3-class mix, row 1 idle-heavy."""
    mpki = np.array([[25, 40, 18, 1000, 1000, 1000],
                     [0.5, 1.0, 0.8, 1000, 1000, 1000]], np.float32)
    row = lambda v, dt: np.tile(np.array(v, dt), (2, 1))
    pool = {
        "mpki": mpki,
        "inst_per_miss": np.maximum(1000.0 / mpki, 1.0).astype(np.float32),
        "rbl": row([.5, .4, .6, .9, .85, .8], np.float32),
        "blp": row([3, 2, 4, 4, 2, 3], np.int32),
        "is_gpu": row([0, 0, 0, 1, 0, 0], bool),
        "src_class": row([CLS_CPU] * 3 + [CLS_GPU, CLS_HWA, CLS_HWA],
                         np.int32),
        "dl_period": row([0, 0, 0, 0, 400, 300], np.int32),
        "dl_reqs": row([0, 0, 0, 0, 20, 12], np.int32),
        "dl_jitter": row([0, 0, 0, 0, 10, 0], np.int32),
    }
    active = np.array([[1, 1, 1, 1, 1, 1], [1, 1, 0, 0, 1, 1]], bool)
    return pool, active


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


def assert_trees_equal(got, want, ctx):
    assert got.keys() == want.keys(), (ctx, set(got) ^ set(want))
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, (ctx, k, g.dtype, w.dtype)
        assert np.array_equal(g, w), (ctx, k)


@pytest.fixture(scope="module")
def stacked_runs():
    """The family stacked, skipping, sanitizer and recorder on: (port,
    reference, port ticked)."""
    pool, active = mix_pool()
    cfg = SimConfig(**KW3, **ON)
    got = tsim.simulate_stacked(cfg, FAMILY, pool, active, N_CYCLES, WARMUP,
                                skip=True, device="cpu")
    want = jsim.simulate_stacked(JConfig(**KW3, **ON), FAMILY, pool, active,
                                 N_CYCLES, WARMUP, skip=True)
    tick = tsim.simulate_stacked(cfg, FAMILY, pool, active, N_CYCLES, WARMUP,
                                 device="cpu")
    return got, want, tick


@pytest.mark.parametrize("policy", FAMILY)
def test_stacked_skip_equals_reference(policy, stacked_runs):
    got, want, _ = stacked_runs
    assert_trees_equal(got[policy], want[policy], policy)
    assert not got[policy]["violations"].any()


def test_stacked_sim_steps_family_common_per_workload(stacked_runs):
    got = stacked_runs[0]
    steps = np.stack([got[p]["sim_steps"] for p in FAMILY])
    assert (steps == steps[0]).all()            # family-common
    assert steps[0, 0] != steps[0, 1]           # per workload
    assert steps[0, 1] < 0.8 * N_CYCLES


@pytest.mark.parametrize("policy", FAMILY)
def test_stacked_skipping_equals_ticking(policy, stacked_runs):
    skip, tick = stacked_runs[0][policy], stacked_runs[2][policy]
    assert skip.keys() == tick.keys()
    for k in tick:
        if k == "sim_steps":
            continue
        a, b = skip[k], tick[k]
        if k == "telemetry":
            n = telemetry.N_INVARIANT
            a, b = a[..., :n], b[..., :n]
        assert np.array_equal(a, b), (policy, k)


@pytest.mark.parametrize("policy", sorted(GRID_POINTS))
def test_grid_skip_equals_reference(policy):
    """One clock per (workload, point): `sim_steps` per point equals the
    reference's grid run."""
    pool, active = mix_pool()
    pts = GRID_POINTS[policy]
    got = tsim.simulate_grid(SimConfig(**KW3), policy, pts, pool, active,
                             N_CYCLES, WARMUP, skip=True, device="cpu")
    want = jsim.simulate_grid(JConfig(**KW3), policy, pts, pool, active,
                              N_CYCLES, WARMUP, skip=True)
    for i in range(len(pts)):
        assert_trees_equal(got[i], want[i], (policy, i))
    assert not np.array_equal(got[0]["sim_steps"], got[1]["sim_steps"])


def test_stacked_grid_skip_equals_reference():
    pool, active = mix_pool()
    got = tsim.simulate_stacked_grid(SimConfig(**KW3), STACKED_GRID, pool,
                                     active, N_CYCLES, WARMUP, skip=True,
                                     device="cpu")
    want = jsim.simulate_stacked_grid(JConfig(**KW3), STACKED_GRID, pool,
                                      active, N_CYCLES, WARMUP, skip=True)
    for i, sl in enumerate(STACKED_GRID):
        assert_trees_equal(got[i], want[i], sl)


@pytest.fixture(scope="module")
def debug_stacked():
    gcfg = SimConfig(**GKW)
    pool, on = golden_pool(gcfg), np.ones(gcfg.n_src, bool)
    got = tsim.simulate_debug_stacked(gcfg, FAMILY, pool, on, 1_500,
                                      skip=True, device="cpu")
    want = jsim.simulate_debug_stacked(JConfig(**GKW), FAMILY, pool, on,
                                       1_500, skip=True)
    return got, want


@pytest.mark.parametrize("policy", FAMILY)
def test_debug_stacked_skip_equals_reference(policy, debug_stacked):
    got, want = debug_stacked
    for part, g, w in zip(("src", "sched", "dram"), got[policy],
                          want[policy]):
        assert_trees_equal(g, w, (policy, part))


@pytest.mark.parametrize("policy", [p for p in FAMILY if p in GOLDEN])
def test_stacked_golden_digests_through_skip(policy, debug_stacked):
    st_f, sched_f, dram_f = debug_stacked[0][policy]
    g = GOLDEN[policy]
    for part, tree in (("src", st_f), ("dram", dram_f)):
        new = digest(tree)
        allowed = set(energy.STATE_KEYS) | set(qos.STATE_KEYS) \
            if part == "dram" else set(engine.NCLASS_SRC_KEYS)
        assert set(new) ^ set(g[part]) <= allowed
        for k, h in g[part].items():
            assert new[k] == h, f"{policy} {part}[{k}] diverged"
    sched = digest(sched_f)
    shared = set(sched) & set(g["sched"])
    assert {"valid", "src", "bank", "row", "birth", "marked"} <= shared
    for k in shared:
        assert sched[k] == g["sched"][k], f"{policy} sched[{k}] diverged"
