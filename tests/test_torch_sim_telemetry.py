"""The port's flight recorder against the reference's: the ring and its
epoch pointer for all eight policies (ticked here, at the 3-class
configuration: the stacked family, sms and sms_dash; the skipping rings of
every policy are held against the reference's in test_torch_sim_skip.py and
test_torch_sim_skip_folded.py); turning it on changes no other array
(through the skipping driver); the `steps` channel is the skip meter;
`metrics.timeline_breakdown` and the ring helpers equal the reference's on
the same inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import telemetry as jtelemetry  # noqa: E402
from repro.core.params import SimConfig as JConfig  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core import metrics  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core import telemetry  # noqa: E402
from repro_torch.core.params import (CLS_CPU, CLS_GPU, CLS_HWA,  # noqa: E402
                                     SimConfig)

POLICIES = ("frfcfs", "atlas", "parbs", "tcm", "sms", "sms_dash", "bliss",
            "squash_prio")
FAMILY = ("frfcfs", "atlas", "parbs", "tcm", "bliss", "squash_prio")
KW3 = dict(n_cpu=3, n_gpu=1, n_hwa=2, n_channels=2, buf_entries=24,
           fifo_size=5, dcs_size=3, atlas_epoch=150, tcm_quantum=120,
           bliss_clear_interval=200, squash_epoch=128)
# 16 x 64 = 1024 cycles: the ring holds every run below whole; the 8 x 32
# window wraps and exercises the slot recycling
TL = dict(telemetry_enabled=True, telemetry_window=16, telemetry_epoch=64)
TL_WRAP = dict(telemetry_enabled=True, telemetry_window=8, telemetry_epoch=32)
WARMUP, N_CYCLES = 100, 400


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


@pytest.fixture(scope="module")
def ticked_runs():
    """{policy: (port, reference)} ticked metrics with the recorder on (a
    wrapping window): the family stacked, sms and sms_dash alone."""
    pool, active = mix_pool()
    cfg, jcfg = SimConfig(**KW3, **TL_WRAP), JConfig(**KW3, **TL_WRAP)
    got = tsim.simulate_stacked(cfg, FAMILY, pool, active, N_CYCLES, WARMUP,
                                device="cpu")
    want = jsim.simulate_stacked(jcfg, FAMILY, pool, active, N_CYCLES,
                                 WARMUP)
    out = {p: (got[p], want[p]) for p in FAMILY}
    for p in ("sms", "sms_dash"):
        out[p] = (tsim.simulate(cfg, p, pool, active, N_CYCLES, WARMUP,
                                device="cpu"),
                  jsim.simulate(jcfg, p, pool, active, N_CYCLES, WARMUP))
    return out


@pytest.mark.parametrize("policy", POLICIES)
def test_ticked_ring_equals_reference(policy, ticked_runs):
    got, want = ticked_runs[policy]
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, (policy, k)
        assert np.array_equal(got[k], want[k]), (policy, k)
    ring = got["telemetry"]
    assert ring.shape == (2, 8, telemetry.K)
    # ticked: one step per cycle of each epoch the window still holds
    assert (ring[..., telemetry.CH["steps"]] <= 32).all()
    assert ring[..., :telemetry.N_INVARIANT].any()
    assert (got["telemetry_epoch"] == (WARMUP + N_CYCLES - 1) // 32).all()


@pytest.mark.parametrize("policy", POLICIES)
def test_recorder_changes_nothing_else(policy):
    """Through the skipping driver, every final array but the ring's is the
    same with the recorder off and on."""
    pool, active = mix_pool()
    pool1 = {k: v[1] for k, v in pool.items()}
    off = tsim.simulate_debug(SimConfig(**KW3), policy, pool1, active[1],
                              600, skip=True, device="cpu")
    on = tsim.simulate_debug(SimConfig(**KW3, **TL), policy, pool1,
                             active[1], 600, skip=True, device="cpu")
    for part, a, b in zip(("src", "sched", "dram"), off, on):
        extra = set(b) - set(a)
        assert extra == (set(telemetry.STATE_KEYS) if part == "dram"
                         else set()), (policy, part, extra)
        for k in a:
            assert np.array_equal(a[k], b[k]), (policy, part, k)
    assert on[2]["tl_ring"].shape == (16, telemetry.K)
    assert on[2]["tl_epoch"].dtype == np.int32


def test_steps_channel_is_the_skip_meter():
    """With no warm-up and the whole run in the window, each row's `steps`
    channel sums to its `sim_steps`; the driver-invariant channels equal the
    ticked run's."""
    pool, active = mix_pool()
    cfg = SimConfig(**KW3, **TL)
    for pol in ("parbs", "sms"):
        skip = tsim.simulate(cfg, pol, pool, active, 700, 0, skip=True,
                             device="cpu")
        tick = tsim.simulate(cfg, pol, pool, active, 700, 0, device="cpu")
        steps = skip["telemetry"][..., telemetry.CH["steps"]].sum(-1)
        assert np.array_equal(steps, skip["sim_steps"]), pol
        assert (tick["telemetry"][..., telemetry.CH["steps"]].sum(-1)
                == 700).all()
        assert np.array_equal(skip["telemetry"][..., :telemetry.N_INVARIANT],
                              tick["telemetry"][..., :telemetry.N_INVARIANT])
        assert steps[1] < 0.95 * 700


def test_timeline_breakdown_equals_reference(ticked_runs):
    cfg, jcfg = SimConfig(**KW3, **TL_WRAP), JConfig(**KW3, **TL_WRAP)
    m = ticked_runs["sms"][0]
    for total in (None, WARMUP + N_CYCLES):
        got = metrics.timeline_breakdown(cfg, m, total)
        want = jmetrics.timeline_breakdown(jcfg, m, total)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k], equal_nan=True), k
    # the stacked (P, W, ...) layout flattens and restores its leading axes
    stk = {k: np.stack([ticked_runs[p][0][k] for p in FAMILY])
           for k in ("telemetry", "telemetry_epoch")}
    got = metrics.timeline_breakdown(cfg, stk)
    want = jmetrics.timeline_breakdown(jcfg, stk)
    assert got["epoch"].shape == (len(FAMILY), 2, 8)
    for k in want:
        assert np.array_equal(got[k], want[k], equal_nan=True), k


def test_ring_helpers_equal_reference():
    rng = np.random.RandomState(5)
    ring = rng.randint(0, 50, (8, telemetry.K)).astype(np.int32)
    for e in (0, 3, 7, 8, 29):
        assert np.array_equal(telemetry.ring_epochs(8, e),
                              jtelemetry.ring_epochs(8, e))
        for a, b in zip(telemetry.ordered_view(ring, e),
                        jtelemetry.ordered_view(ring, e)):
            assert np.array_equal(a, b), e
    assert telemetry.CHANNELS == jtelemetry.CHANNELS
    assert telemetry.N_INVARIANT == jtelemetry.N_INVARIANT
    assert telemetry.STATE_KEYS == jtelemetry.STATE_KEYS
    assert not set(telemetry.STATE_KEYS) & set(
        engine.dram_state(SimConfig(), 1, "cpu"))
