"""Each function of the port's engine, energy, qos, scheduler substrate and
SMS stages against its JAX counterpart, exactly, on the same input states
(made from a seed with numpy). The reference is vmapped over the leading
workload axis that the port carries."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import energy as jenergy  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import params as jparams  # noqa: E402
from repro.core import qos as jqos  # noqa: E402
from repro.core import schedulers as jsched  # noqa: E402
from repro.core import sms as jsms  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import params as tparams  # noqa: E402
from repro_torch.core import qos as tqos  # noqa: E402
from repro_torch.core import schedulers as tsched  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core import sms as tsms  # noqa: E402

W = 3
KW = dict(n_cpu=3, n_gpu=1, n_hwa=2, n_channels=2, buf_entries=24,
          fifo_size=5, dcs_size=3)
JCFG, TCFG = jparams.SimConfig(**KW), tparams.SimConfig(**KW)
S, C, B = TCFG.n_src, TCFG.n_channels, TCFG.n_banks


def _t(v):
    """numpy -> torch; a uint32 array goes to the port's int64 form."""
    v = np.asarray(v)
    return torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32
                            else v.copy())


def to_t(tree):
    return {k: _t(v) for k, v in tree.items()}


def to_j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _n(v, u32=False):
    if isinstance(v, torch.Tensor):
        v = v.numpy()
        return v.astype(np.uint32) if u32 else v
    return np.asarray(v)


def assert_same(got, want, name=""):
    """Exact equality, dtype included, after the port's export."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), (name, got.keys() ^ want.keys())
        for k in want:
            assert_same(got[k], want[k], f"{name}.{k}")
        return
    w = np.asarray(want)
    g = _n(got, u32=w.dtype == np.uint32)
    assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    assert np.array_equal(g, w), (name, g, w)


def _u32(rng, shape):
    return rng.randint(0, 2 ** 32, size=shape, dtype=np.uint64) \
        .astype(np.uint32)


def make_pool(rng):
    cls = np.tile(np.asarray([0, 0, 0, 1, 2, 2], np.int32), (W, 1))
    mpki = rng.uniform(1, 40, (W, S)).astype(np.float32)
    return {
        "mpki": mpki,
        "inst_per_miss": np.maximum(1000.0 / mpki, 1.0).astype(np.float32),
        "rbl": rng.uniform(0.1, 0.95, (W, S)).astype(np.float32),
        "blp": rng.randint(0, 7, (W, S)).astype(np.int32),
        "is_gpu": cls == 1,
        "src_class": cls,
        "dl_period": np.where(cls == 2, rng.choice([300, 400, 600], (W, S)),
                              0).astype(np.int32),
        "dl_reqs": np.where(cls == 2, rng.randint(5, 60, (W, S)), 0
                            ).astype(np.int32),
        "dl_jitter": np.where(cls == 2, rng.randint(0, 130, (W, S)), 0
                              ).astype(np.int32),
    }


def make_src(rng, t):
    i = lambda lo, hi: rng.randint(lo, hi, (W, S)).astype(np.int32)
    f = lambda hi: rng.uniform(0, hi, (W, S)).astype(np.float32)
    return {
        "insts_acc": f(60), "insts_done": f(9e4), "outstanding": i(0, 130),
        "emitted": i(200, 300), "completed": i(0, 200),
        "sum_lat": np.floor(f(5e5)), "pend_valid": rng.rand(W, S) < 0.5,
        "pend_bank": i(0, C * B), "pend_row": i(0, TCFG.n_rows),
        "pend_birth": i(0, t + 1), "cur_bank": i(0, C * B),
        "cur_row": i(0, TCFG.n_rows), "bank_ptr": i(0, 99),
        "rng": _u32(rng, (W, S)), "blp_sum": f(9), "blp_n": f(9),
        "period_done": i(0, 60), "dl_met": i(0, 9), "dl_missed": i(0, 9),
        "frames_released": i(0, 9),
    }


def make_dram(rng, t):
    i = lambda lo, hi, shape: rng.randint(lo, hi, shape).astype(np.int32)
    f = lambda shape: rng.uniform(0, 99, shape).astype(np.float32)
    return {
        "bank_free": i(t - 20, t + 40, (W, C, B)),
        "open_row": i(-1, 40, (W, C, B)),
        "open_valid": rng.rand(W, C, B) < 0.7,
        "act_ring": np.where(rng.rand(W, C, 4) < 0.2, teng.NEG_T,
                             i(t - 60, t, (W, C, 4))).astype(np.int32),
        "bus_free": i(t - 5, t + 40, (W, C)),
        "ring": i(0, 3, (W, teng.RING, S)),
        "hits": i(0, 99, (W, S)), "issued": i(99, 200, (W, S)),
        "e_act": f((W, S)), "e_rw": f((W, S)),
        "sb_cycles": i(0, 999, (W, C)), "e_wake": f((W, C)),
        "pd_down": rng.rand(W, C) < 0.5, "pd_cycles": i(0, 999, (W, C)),
        "busy_until": i(t - 99, t + 40, (W, C)),
        "lat_hist": i(0, 9, (W, S, TCFG.lat_bins)),
    }


def bound(cfg_t, cfg_j, **knobs):
    return (tparams.bind(cfg_t, tparams.Knobs.from_cfg(cfg_t, **knobs)),
            jparams.bind(cfg_j, jparams.Knobs.from_cfg(cfg_j, **knobs)))


# ---------------------------------------------------------------------------
# masked writes, the LCG, the frame hash, the state builders
# ---------------------------------------------------------------------------

def test_masked_writes():
    rng = np.random.RandomState(0)
    a = rng.randint(-9, 9, (W, C, 7)).astype(np.int32)
    a3 = rng.randint(-9, 9, (W, C, 4, 5)).astype(np.int32)
    idx = rng.randint(0, 7, (W, C))
    idx1, idx2 = rng.randint(0, 4, (W, C)), rng.randint(0, 5, (W, C))
    v = rng.randint(-99, 99, (W, C)).astype(np.int32)
    do = rng.rand(W, C) < 0.6
    jv = jax.vmap
    assert_same(teng.masked_set(_t(a), _t(idx), _t(v), _t(do)),
                jv(jeng.masked_set)(a, idx, v, do))
    assert_same(teng.masked_set(_t(a), _t(idx), 5, _t(do)),
                jv(lambda a, i, d: jeng.masked_set(a, i, 5, d))(a, idx, do))
    assert_same(teng.masked_add(_t(a), _t(idx), _t(v), _t(do)),
                jv(jeng.masked_add)(a, idx, v, do))
    assert_same(teng.masked_add(_t(a), _t(idx), -1, _t(do)),
                jv(lambda a, i, d: jeng.masked_add(a, i, -1, d))(a, idx, do))
    assert_same(teng.masked_set2(_t(a3), _t(idx1), _t(idx2), _t(v), _t(do)),
                jv(jeng.masked_set2)(a3, idx1, idx2, v, do))
    b = rng.rand(W, C, 7) < 0.5
    assert_same(teng.masked_set(_t(b), _t(idx), True, _t(do)),
                jv(lambda a, i, d: jeng.masked_set(a, i, True, d))(b, idx,
                                                                   do))


@pytest.mark.parametrize("n_ch", [2, 4])
def test_accum_by_index_duplicates_accumulate(n_ch):
    rng = np.random.RandomState(n_ch)
    acc_i = rng.randint(0, 99, (W, S)).astype(np.int32)
    acc_f = rng.uniform(0, 1e5, (W, S)).astype(np.float32)
    idx = rng.randint(0, S, (W, n_ch))
    idx[:, 1] = idx[:, 0]                        # a duplicate in every row
    do = rng.rand(W, n_ch) < 0.8
    do[:, :2] = True
    vi = rng.randint(0, 400, (W, n_ch)).astype(np.float32)
    vf = rng.uniform(0, 9, (W, n_ch)).astype(np.float32)
    jv = jax.vmap
    assert_same(teng.accum_by_index(_t(acc_i), _t(idx), 1, _t(do)),
                jv(lambda a, i, d: jeng.accum_by_index(a, i, 1, d))(
                    acc_i, idx, do))
    assert_same(teng.accum_by_index(_t(acc_f), _t(idx), _t(vi), _t(do)),
                jv(jeng.accum_by_index)(acc_f, idx, vi, do))
    c12 = float(np.float32(1.2))
    assert_same(teng.accum_by_index(_t(acc_f), _t(idx), c12, _t(do)),
                jv(lambda a, i, d: jeng.accum_by_index(
                    a, i, jnp.float32(1.2), d))(acc_f, idx, do))
    if n_ch == 2:                # two addends commute: any float is exact
        assert_same(teng.accum_by_index(_t(acc_f), _t(idx), _t(vf), _t(do)),
                    jv(jeng.accum_by_index)(acc_f, idx, vf, do))


def test_lcg_ten_thousand_draws():
    rng = np.random.RandomState(1)
    x0 = _u32(rng, (W, S))

    def body(x, _):
        x, u = jeng.lcg_step(x)
        return x, (x, u)

    _, (xs, us) = jax.lax.scan(body, jnp.asarray(x0), None, length=10_000)
    xs, us = np.asarray(xs), np.asarray(us)
    x = _t(x0)
    for i in range(10_000):
        x, u = teng.lcg_step(x)
        if i % 997 == 0 or i == 9_999:
            assert_same(x, xs[i], f"state {i}")
            assert_same(u, us[i], f"u {i}")


def test_frame_release_offset_with_jitter():
    rng = np.random.RandomState(2)
    frame = rng.randint(0, 5000, (W, S)).astype(np.int32)
    jit = rng.randint(0, 300, (W, S)).astype(np.int32)
    got = teng.frame_release_offset(S, _t(frame), _t(jit))
    want = jax.vmap(lambda f, j: jeng.frame_release_offset(S, f, j))(frame,
                                                                      jit)
    assert_same(got, want)
    assert (np.asarray(want) > 0).any()
    zero = teng.frame_release_offset(S, _t(frame), _t(np.zeros_like(jit)))
    assert not zero.any()


def test_state_builders_and_pool_helpers():
    dev = "cpu"
    jb = lambda tree: {k: np.broadcast_to(np.asarray(v), (W,) + v.shape)
                       for k, v in tree.items()}
    assert_same(teng.source_state(TCFG, W, dev), jb(jeng.source_state(JCFG)))
    assert_same(teng.dram_state(TCFG, W, dev), jb(jeng.dram_state(JCFG)))
    assert_same(tsched.buffer_state(TCFG, W, dev),
                jb(jsched.buffer_state(JCFG)))
    assert_same(tsms.sms_state(TCFG, W, dev), jb(jsms.sms_state(JCFG)))
    assert np.array_equal(teng.addr_base(S, C, B), jeng.addr_base(S, C, B))
    rng = np.random.RandomState(3)
    is_gpu = rng.rand(W, S) < 0.3
    dlp = np.where(rng.rand(W, S) < 0.3, 500, 0).astype(np.int32)
    assert_same(teng.derive_src_class(_t(is_gpu), _t(dlp)),
                jeng.derive_src_class(is_gpu, dlp))
    sp = jparams.SourcePool(mpki=np.asarray([2.0, 30.0, 1000.0], np.float32),
                            rbl=np.asarray([0.3, 0.5, 0.9], np.float32),
                            blp=np.asarray([1, 4, 4]),
                            is_gpu=np.asarray([False, False, True]),
                            dl_period=np.asarray([0, 400, 0]))
    tp = tparams.SourcePool(**{f: getattr(sp, f) for f in
                               sp.__dataclass_fields__})
    assert_same(teng.pool_arrays(tp), jeng.pool_arrays(sp))


# ---------------------------------------------------------------------------
# the per-cycle engine ticks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [0, 1, 1200, 12_345])
def test_source_tick(t):
    rng = np.random.RandomState(10 + t)
    pool, st = make_pool(rng), make_src(rng, t)
    active = rng.rand(W, S) < 0.9
    got = teng.source_tick(TCFG, to_t(pool), to_t(st), _t(active), t)
    want = jax.vmap(lambda p, s, a: jeng.source_tick(JCFG, p, s, a, t))(
        to_j(pool), to_j(st), jnp.asarray(active))
    assert_same(got, want)


@pytest.mark.parametrize("t", [0, 1200, 12_345])
def test_completions_and_deadline_ticks(t):
    rng = np.random.RandomState(20 + t)
    pool, st, dram = make_pool(rng), make_src(rng, t), make_dram(rng, t)
    got = teng.completions_tick(to_t(st), to_t(dram), t)
    want = jax.vmap(lambda s, d: jeng.completions_tick(s, d, t))(
        to_j(st), to_j(dram))
    assert_same(got[0], want[0])
    assert_same(got[1], want[1])
    got = teng.deadline_tick(TCFG, to_t(pool), to_t(st), t)
    want = jax.vmap(lambda p, s: jeng.deadline_tick(JCFG, p, s, t))(
        to_j(pool), to_j(st))
    assert_same(got, want)


@pytest.mark.parametrize("t", [5, 777])
def test_eligibility(t):
    rng = np.random.RandomState(30 + t)
    dram = make_dram(rng, t)
    N = 9
    bank = rng.randint(0, B, (W, C, N)).astype(np.int32)
    row = rng.randint(-1, 40, (W, C, N)).astype(np.int32)
    valid = rng.rand(W, C, N) < 0.7
    got = teng.eligibility(TCFG, to_t(dram), _t(bank), _t(row), _t(valid), t)
    want = jax.vmap(lambda d, b, r, v: jax.vmap(
        lambda c, bb, rr, vv: jeng.eligibility(JCFG, d, c, bb, rr, vv, t))(
            jnp.arange(C), b, r, v))(to_j(dram), bank, row, valid)
    for g, w in zip(got, want):
        assert_same(g, w)


@pytest.mark.parametrize("t", [64, 5_000])
def test_issue_channels_with_energy_and_qos(t):
    rng = np.random.RandomState(40 + t)
    st, dram = make_src(rng, t), make_dram(rng, t)
    do = rng.rand(W, C) < 0.8
    do[0] = True
    bank = rng.randint(0, B, (W, C)).astype(np.int32)
    row = rng.randint(0, 40, (W, C)).astype(np.int32)
    src = rng.randint(0, S, (W, C)).astype(np.int32)
    src[0, 1] = src[0, 0]                      # one source on both channels
    birth = rng.randint(t - 3000, t, (W, C)).astype(np.int32)
    lat = rng.choice([11, 22, 33], (W, C)).astype(np.int32)
    hit = rng.rand(W, C) < 0.5
    tcfg, jcfg = bound(TCFG, JCFG)
    args = (do, bank, row, src, birth, lat, hit)
    dram_t, st_t = teng.issue_channels(tcfg, to_t(dram), to_t(st),
                                       *map(_t, args), t)
    dram_j, st_j = jax.vmap(lambda d, s, *a: jeng.issue_channels(
        jcfg, d, s, *a, t))(to_j(dram), to_j(st), *args)
    assert_same(dram_t, dram_j)
    assert_same(st_t, st_j)


@pytest.mark.parametrize("t", [0, 300, 9_999])
def test_energy_background_and_on_issue(t):
    rng = np.random.RandomState(50 + t)
    dram = make_dram(rng, t)
    tcfg, jcfg = bound(TCFG, JCFG, energy_pd_idle=30)
    assert_same(tenergy.background_tick(tcfg, to_t(dram), t),
                jax.vmap(lambda d: jenergy.background_tick(jcfg, d, t))(
                    to_j(dram)))
    do = rng.rand(W, C) < 0.7
    src = rng.randint(0, S, (W, C)).astype(np.int32)
    src[:, 1] = src[:, 0]
    hit = rng.rand(W, C) < 0.4
    done = rng.randint(t, t + 40, (W, C)).astype(np.int32)
    assert_same(tenergy.on_issue(tcfg, to_t(dram), *map(_t, (do, src, hit,
                                                              done))),
                jax.vmap(lambda d, *a: jenergy.on_issue(jcfg, d, *a))(
                    to_j(dram), do, src, hit, done))
    off = TCFG.replace(energy_enabled=False)
    assert tenergy.energy_state(off, W, "cpu") == {}
    assert set(tenergy.energy_state(TCFG, W, "cpu")) == \
        set(jenergy.STATE_KEYS) == set(tenergy.STATE_KEYS)


def test_qos_histogram():
    rng = np.random.RandomState(60)
    hist = rng.randint(0, 9, (W, S, TCFG.lat_bins)).astype(np.int32)
    src = rng.randint(0, S, (W, C)).astype(np.int32)
    src[:, 1] = src[:, 0]
    lat = rng.choice([0, 63, 64, 700, 2047, 2048, 90_000], (W, C)) \
        .astype(np.int32)
    lat[:, 1] = lat[:, 0]                      # same source, same bin
    do = rng.rand(W, C) < 0.8
    assert_same(tqos.on_issue(TCFG, _t(hist), _t(src), _t(lat), _t(do)),
                jax.vmap(lambda h, s, la, d: jqos.on_issue(JCFG, h, s, la,
                                                           d))(
                    hist, src, lat, do))
    assert np.array_equal(tqos.bin_upper_edges(TCFG),
                          jqos.bin_upper_edges(JCFG))
    assert tqos.STATE_KEYS == jqos.STATE_KEYS
    assert tqos.qos_state(TCFG.replace(qos_enabled=False), W, "cpu") == {}


# ---------------------------------------------------------------------------
# the centralized substrate and the SMS stages, on mid-run states
# ---------------------------------------------------------------------------

def test_rank_pos_stable_ties_and_base_score():
    rng = np.random.RandomState(70)
    key = rng.randint(0, 4, (W, C, 11)).astype(np.int32)   # many ties
    assert_same(tsched.rank_pos(_t(key)), jsched.rank_pos(key))
    birth = rng.randint(0, 30_000, (W, C, 11)).astype(np.int32)
    hit = rng.rand(W, C, 11) < 0.5
    assert_same(tsched.base_score(TCFG, {"birth": _t(birth)}, _t(hit),
                                  20_000),
                jsched.base_score(JCFG, {"birth": birth}, hit, 20_000))


def _mid_run(policy, n_cycles, pool):
    """A mid-run state from the port, as numpy trees with a W axis of 1."""
    st, sched, dram = tsim.simulate_debug(TCFG, policy, pool,
                                          np.ones(S, bool), n_cycles,
                                          device="cpu")
    add_w = lambda tree: {k: v[None] for k, v in tree.items()}
    return add_w(st), add_w(sched), add_w(dram)


def _pool1(seed):
    rng = np.random.RandomState(seed)
    pool = make_pool(rng)
    return {k: v[0] for k, v in pool.items()}


@pytest.mark.parametrize("t", [450, 601])
def test_centralized_admit_and_select(t):
    pool = _pool1(80)
    st, buf, dram = _mid_run("frfcfs", t, pool)
    pool1 = {k: v[None] for k, v in pool.items()}
    tcfg, jcfg = bound(TCFG, JCFG)
    got = tsched.admit(tcfg, to_t(pool1), to_t(st), to_t(buf), t)
    want = jax.jit(jax.vmap(
        lambda p, s, b: jsched.admit(jcfg, p, s, b, t)))(
            to_j(pool1), to_j(st), to_j(buf))
    for g, w in zip(got, want):
        assert_same(g, w)
    from repro.core import policy as jpol
    from repro_torch.core import policy as tpol
    got = tpol.get("frfcfs").select(tcfg, to_t(pool1), to_t(st), to_t(buf),
                                    to_t(dram), t)
    want = jax.jit(jax.vmap(lambda p, s, b, d: jpol.get("frfcfs").select(
        jcfg, p, s, b, d, t)))(to_j(pool1), to_j(st), to_j(buf), to_j(dram))
    for g, w in zip(got, want):
        assert_same(g, w)


@pytest.mark.parametrize("dash", [False, True])
def test_sms_stages(dash):
    pool = _pool1(90)
    t = 677
    st, sms, dram = _mid_run("sms_dash" if dash else "sms", t, pool)
    pool1 = {k: v[None] for k, v in pool.items()}
    tcfg, jcfg = bound(TCFG, JCFG, dash=dash)
    jv = lambda f: jax.jit(jax.vmap(f))
    got = tsms.batch_info(tcfg, to_t(sms), t)
    want = jv(lambda s: jsms.batch_info(jcfg, s, t))(to_j(sms))
    for g, w in zip(got, want):
        assert_same(g, w)
    got = tsms.stage1_admit(tcfg, to_t(st), to_t(sms), t)
    want = jv(lambda s, m: jsms.stage1_admit(jcfg, s, m, t))(to_j(st),
                                                            to_j(sms))
    for g, w in zip(got, want):
        assert_same(g, w)
    st2, sms2 = (to_n_tree(x) for x in got)
    got = tsms.stage2_drain(tcfg, to_t(pool1), to_t(st2), to_t(sms2), t)
    want = jv(lambda p, s, m: jsms.stage2_drain(jcfg, p, s, m, t))(
        to_j(pool1), to_j(st2), to_j(sms2))
    for g, w in zip(got, want):
        assert_same(g, w)
    st3, sms3 = (to_n_tree(x) for x in got)
    got = tsms.stage3_issue(tcfg, to_t(st3), to_t(sms3), to_t(dram), t)
    want = jv(lambda s, m, d: jsms.stage3_issue(jcfg, s, m, d, t))(
        to_j(st3), to_j(sms3), to_j(dram))
    for g, w in zip(got, want):
        assert_same(g, w)


def test_run_from_head():
    rng = np.random.RandomState(95)
    F = 6
    rows = rng.randint(0, 2, (W, C, F)).astype(np.int32)
    banks = rng.randint(0, 2, (W, C, F)).astype(np.int32)
    head = rng.randint(0, F, (W, C)).astype(np.int32)
    length = rng.randint(0, F + 1, (W, C)).astype(np.int32)
    assert_same(tsms._run_from_head(_t(rows), _t(banks), _t(head),
                                    _t(length), F),
                jax.vmap(lambda r, b, h, n: jsms._run_from_head(r, b, h, n,
                                                                F))(
                    rows, banks, head, length))


def to_n_tree(tree):
    return {k: _n(v, u32=k in teng.U32_KEYS) for k, v in tree.items()}
