"""The port's variable-step driver (`skip=True`) against the reference's.

Each witness on mid-run states of the port (a 3-class configuration with
two HWAs, W = 2) against the reference's function on the same state;
`lcg_skip` against repeated `lcg_step` and the reference for k up to 2^31;
the closed-form span replays; `simulate(skip=True)` with the sanitizer and
the flight recorder on, every metric (`sim_steps` per workload,
`violations`, `telemetry`) equal to the reference's `skip=True`; skipping against ticking in the port. The folded drivers are
in `test_torch_sim_skip_folded.py`; `simulate_debug(skip=True)` against the
reference's and the golden digests in `test_torch_sim_validate.py`.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import energy as jenergy  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core import schedulers as jsched  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import sms as jsms  # noqa: E402
from repro.core.params import SimConfig as JConfig  # noqa: E402
from repro_torch.core import energy, engine  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import schedulers as tsched  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core import sms as tsms  # noqa: E402
from repro_torch.core.params import (CLS_CPU, CLS_GPU, CLS_HWA,  # noqa: E402
                                     SimConfig)

# `simulate(skip=True)` with the sanitizer and the recorder on, against
# the reference's: the base substrate (frfcfs), a per-row boundary witness
# (parbs), a mixed host/row one (squash_prio) and the staged protocol (sms,
# sms_dash). atlas, tcm and bliss (host-int witnesses) run through the
# stacked and grid drivers (test_torch_sim_skip_folded.py) and
# `simulate_debug` (test_torch_sim_validate.py)
POLICIES = ("frfcfs", "parbs", "squash_prio", "sms", "sms_dash")
# the 3-class configuration: 3 CPUs, a GPU and two frame HWAs
KW3 = dict(n_cpu=3, n_gpu=1, n_hwa=2, n_channels=2, buf_entries=24,
           fifo_size=5, dcs_size=3)
# short periods, so atlas, tcm, bliss and squash cross boundaries mid-span
PERIODS = dict(atlas_epoch=150, tcm_quantum=120, bliss_clear_interval=200,
               squash_epoch=128)
# window x epoch = 1024 cycles >= every run: the ring holds the whole run
ON = dict(validate_enabled=True, telemetry_enabled=True, telemetry_window=16,
          telemetry_epoch=64)
WARMUP, N_CYCLES = 100, 400


def mix_pool():
    """(W=2, S=6): row 0 a busy 3-class mix, row 1 idle-heavy (sparse CPUs
    and two frame HWAs; the GPU masked off), where spans form."""
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


def assert_trees_equal(got, want, ctx):
    assert got.keys() == want.keys(), (ctx, set(got) ^ set(want))
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, (ctx, k, g.dtype, w.dtype)
        assert np.array_equal(g, w), (ctx, k)


# ---------------------------------------------------------------------------
# witnesses and span replays on mid-run states
# ---------------------------------------------------------------------------

def _to_j(tree):
    return {k: jnp.asarray(v.numpy().astype(np.uint32)
                           if k in engine.U32_KEYS else v.numpy())
            for k, v in tree.items()}


CHECKPOINTS = (128, 401, 577)


@functools.lru_cache(maxsize=None)
def _mid_runs(policy):
    """The port's states after cycles [0, T) of the mix batch for each T of
    CHECKPOINTS (one run), with the bound configs and pools of both
    packages: (bcfg, jcfg, pool, jpool, active, jactive, [(t, carry,
    jcarry)]) where t = T - 1 is the last processed cycle."""
    cfg_t, cfg_j = SimConfig(**KW3, **PERIODS), JConfig(**KW3, **PERIODS)
    pool, active = mix_pool()
    bcfg, step, _, carry = tsim.prepare_run(cfg_t, policy, pool, active,
                                            device="cpu")
    states, t0 = [], 0
    for t_end in CHECKPOINTS:
        carry, _ = tsim._run_cycles(step, None, carry, t0, t_end)
        states.append((t_end - 1, carry, tuple(_to_j(x) for x in carry)))
        t0 = t_end
    jcfg = jsim._init(cfg_j, policy)[0]
    return (bcfg, jcfg, tsim.prepare_pool(pool, active.shape, "cpu"),
            jsim.prepare_pool(pool, active.shape), torch.as_tensor(active),
            jnp.asarray(active), states)


def _rows(fn, n_args):
    """The reference's one-workload function over the rows, jitted once,
    the cycle counter traced (its last argument)."""
    f = jax.jit(jax.vmap(fn, in_axes=(0,) * (n_args - 1) + (None,)))
    return lambda *a: np.asarray(f(*a[:-1], jnp.int32(a[-1])))


def test_engine_and_substrate_witnesses():
    bcfg, jcfg, pool, jpool, active, jactive, states = _mid_runs("parbs")
    src = _rows(lambda p, s, a, t: jeng.next_source_event(jcfg, p, s, a, t),
                4)
    comp = _rows(lambda d, t: jeng.next_completion(d, t), 2)
    adm = _rows(lambda p, s, b, t: jsched.next_admission(jcfg, p, s, b, t), 4)
    iss = _rows(lambda b, d, t: jsched.next_issue_ready(jcfg, b, d, t), 3)
    for t, (st, buf, dram), (jst, jbuf, jdram) in states:
        got = engine.next_source_event(bcfg, pool, st, active, t)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), src(jpool, jst, jactive, t)), t
        assert np.array_equal(engine.next_completion(dram, t).numpy(),
                              comp(jdram, t)), t
        assert np.array_equal(
            tsched.next_admission(bcfg, pool, st, buf, t).numpy(),
            adm(jpool, jst, jbuf, t)), t
        assert np.array_equal(
            tsched.next_issue_ready(bcfg, buf, dram, t).numpy(),
            iss(jbuf, jdram, t)), t


@pytest.mark.parametrize("policy", ["atlas", "parbs", "tcm", "bliss",
                                    "squash_prio"])
def test_policy_boundary_witnesses(policy):
    bcfg, jcfg, pool, jpool, _, _, states = _mid_runs(policy)
    jp, tp = jpolicy.get(policy), tpolicy.get(policy)
    nb = _rows(lambda p, s, b, t: jp.next_boundary(jcfg, p, s, b, t), 4)
    ev = _rows(lambda p, s, b, d, t: jp.next_event(jcfg, p, s, b, d, t), 5)
    for t, carry, jcarry in states:
        got = tp.next_boundary(bcfg, pool, carry[0], carry[1], t)
        want = nb(jpool, jcarry[0], jcarry[1], t)
        if policy in ("atlas", "tcm", "bliss"):
            assert isinstance(got, int)         # t-only: a host int
            got = np.full(want.shape, got, np.int64)
        else:
            got = got.numpy()
        assert np.array_equal(got, want), (policy, t, got, want)
        got = tp.next_event(bcfg, pool, *carry, t)
        assert np.array_equal(got.numpy(), ev(jpool, *jcarry, t)), t


@pytest.mark.parametrize("policy", ["sms", "sms_dash"])
def test_sms_stage_witness_and_skip_cycles(policy):
    bcfg, jcfg, _, _, _, _, states = _mid_runs(policy)
    ev = _rows(lambda s, m, d, t: jsms.next_stage_event(jcfg, s, m, d, t), 4)
    for t, carry, jcarry in states:
        got = tsms.next_stage_event(bcfg, *carry, t)
        assert np.array_equal(got.numpy(), ev(*jcarry, t)), t
    sched, jsched_ = states[-1][1][1], states[-1][2][1]
    for k in (0, 1, 7, 1000):
        got = tsms.skip_cycles(sched, k)["rng2"].numpy().astype(np.uint32)
        want = np.asarray(jax.vmap(lambda m: jsms.skip_cycles(
            m, jnp.int32(k))["rng2"])(jsched_))
        assert np.array_equal(got, want), k


@pytest.mark.parametrize("policy", ["frfcfs", "sms"])
def test_span_replays(policy):
    """`skip_sources` and `energy.skip_accrue` (energy on, per channel) on
    mid-run states, against the reference for the same spans."""
    bcfg, jcfg, pool, jpool, active, jactive, states = _mid_runs(policy)
    src = jax.jit(jax.vmap(lambda p, s, a, k: jeng.skip_sources(
        jcfg, p, s, a, k), in_axes=(0, 0, 0, None)))
    acc = jax.jit(jax.vmap(lambda d, t, tn: jenergy.skip_accrue(
        jcfg, d, t, tn), in_axes=(0, None, None)))
    for t, carry, jcarry in states:
        for t_new in (t + 1, t + 2, t + 11, t + 300, t + 1100):
            k = t_new - t - 1
            got = engine.skip_sources(bcfg, pool, carry[0], active, k)
            want = src(jpool, jcarry[0], jactive, jnp.int32(k))
            for key in ("rng", "insts_acc", "insts_done"):
                g = got[key].numpy()
                g = g.astype(np.uint32) if key == "rng" else g
                assert np.array_equal(g, np.asarray(want[key])), (t, k, key)
            got = energy.skip_accrue(bcfg, carry[2], t, t_new)
            want = acc(jcarry[2], jnp.int32(t), jnp.int32(t_new))
            for key in energy.STATE_KEYS:
                assert np.array_equal(got[key].numpy(),
                                      np.asarray(want[key])), (t, k, key)


def test_lcg_skip_small_k_equals_repeated_steps():
    x0 = engine.u32_init(5, 2654435761, 12345, "cpu")
    x = x0
    for k in range(300):
        assert torch.equal(engine.lcg_skip(x0, k), x), k
        x, _ = engine.lcg_step(x)


def _check_lcg_skip(k, seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 2 ** 32, 8, dtype=np.uint64).astype(np.uint32)
    x[0], x[1] = 0, 2 ** 32 - 1
    got = engine.lcg_skip(torch.from_numpy(x.astype(np.int64)), k)
    want = np.asarray(jeng.lcg_skip(jnp.asarray(x),
                                    jnp.asarray(k, jnp.uint32)))
    assert np.array_equal(got.numpy().astype(np.uint32), want), k
    # f^(k+1) = f o f^k
    nxt, _ = engine.lcg_step(got)
    assert torch.equal(engine.lcg_skip(torch.from_numpy(x.astype(np.int64)),
                                       k + 1), nxt), k


@pytest.mark.parametrize("k", [0, 1, 2, 255, 65535, 65536, 2 ** 24 + 3,
                               2 ** 31 - 1, 2 ** 31])
def test_lcg_skip_against_reference(k):
    _check_lcg_skip(k, k % 1000)


def test_lcg_skip_hypothesis():
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(max_examples=60, deadline=None, derandomize=True)
    @hyp.given(st.integers(0, 2 ** 31), st.integers(0, 2 ** 16))
    def prop(k, seed):
        _check_lcg_skip(k, seed)

    prop()


# ---------------------------------------------------------------------------
# simulate(skip=True): all eight policies, sanitizer and recorder on
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def solo_runs():
    """{policy: (port, reference)} metrics of `simulate(skip=True)` at the
    3-class configuration, validate and telemetry on."""
    pool, active = mix_pool()
    out = {}
    for pol in POLICIES:
        got = tsim.simulate(SimConfig(**KW3, **PERIODS, **ON), pol, pool,
                            active, N_CYCLES, WARMUP, skip=True,
                            device="cpu")
        want = jsim.simulate(JConfig(**KW3, **PERIODS, **ON), pol, pool,
                             active, N_CYCLES, WARMUP, skip=True)
        out[pol] = (got, want)
    return out


@pytest.mark.parametrize("policy", POLICIES)
def test_simulate_skip_equals_reference(policy, solo_runs):
    got, want = solo_runs[policy]
    assert {"sim_steps", "violations", "telemetry",
            "telemetry_epoch"} <= set(want)
    assert_trees_equal(got, want, policy)
    assert (got["sim_steps"] <= N_CYCLES).all()
    if policy != "sms_dash":
        # the skip is real on the idle-heavy row, and per workload (sms_dash's
        # deadline-driven drains keep both rows busy in this short window)
        assert got["sim_steps"][1] < 0.95 * N_CYCLES, got["sim_steps"]
        assert got["sim_steps"][0] != got["sim_steps"][1]
    assert not got["violations"].any(), policy


@pytest.mark.parametrize("policy", ["frfcfs", "squash_prio", "sms"])
def test_skipping_equals_ticking_in_the_port(policy, solo_runs):
    """The port's ticked run equals its skipping run in every metric but
    `sim_steps` and the recorder's `steps` channel."""
    from repro_torch.core import telemetry
    pool, active = mix_pool()
    tick = tsim.simulate(SimConfig(**KW3, **PERIODS, **ON), policy, pool,
                         active, N_CYCLES, WARMUP, device="cpu")
    skip = solo_runs[policy][0]
    assert (tick["sim_steps"] == N_CYCLES).all()
    for k in tick:
        if k == "sim_steps":
            continue
        a, b = tick[k], skip[k]
        if k == "telemetry":
            n = telemetry.N_INVARIANT
            a, b = a[..., :n], b[..., :n]
        assert np.array_equal(a, b), (policy, k)
    # the skip meter: the idle-heavy row's ring counts fewer steps than
    # cycles
    steps = skip["telemetry"][..., telemetry.CH["steps"]].sum(-1)
    assert steps[1] < WARMUP + N_CYCLES <= steps[0] + N_CYCLES


def test_host_reads_count_processed_steps():
    """One host read per processed step: W = 1, so the loop's steps are the
    group's, warm-up and measured window alike."""
    pool, active = mix_pool()
    cfg = SimConfig(**KW3, **PERIODS, **ON)
    prep = tsim.prepare_run(cfg, "frfcfs", {k: v[1:] for k, v in pool.items()},
                            active[1:], skip=True, device="cpu")
    before = tsim.host_reads
    m = tsim._scan_and_measure(*prep, N_CYCLES, WARMUP)
    reads = tsim.host_reads - before
    from repro_torch.core import telemetry
    steps_all = int(m["telemetry"][0, :, telemetry.CH["steps"]].sum())
    assert reads == steps_all
    assert m["sim_steps"][0] < steps_all < WARMUP + N_CYCLES


def test_policy_without_next_event_ticks():
    """A policy written from scratch, with no `next_event`, keeps the
    reference's behaviour: the skipping driver ticks it (sim_steps ==
    n_cycles)."""
    class Plain:
        name = "_plain"
        variant_of = None
        stackable = False
        _inner = tpolicy.get("frfcfs")

        def configure(self, cfg):
            return cfg

        def init_state(self, cfg, W, device):
            return self._inner.init_state(cfg, W, device)

        def tick(self, cfg, pool, st, sched, t):
            return self._inner.tick(cfg, pool, st, sched, t)

        def select(self, cfg, pool, st, sched, dram, t):
            return self._inner.select(cfg, pool, st, sched, dram, t)

    tpolicy.POLICY_REGISTRY.register(Plain.name)(Plain())
    try:
        pool, active = mix_pool()
        cfg = SimConfig(**KW3)
        m = tsim.simulate(cfg, Plain.name, pool, active, 120, 40, skip=True,
                          device="cpu")
        ref = tsim.simulate(cfg, "frfcfs", pool, active, 120, 40,
                            device="cpu")
    finally:
        tpolicy.POLICY_REGISTRY._entries.pop(Plain.name)
    assert (m["sim_steps"] == 120).all()
    for k in ref:
        assert np.array_equal(m[k], ref[k]), k
