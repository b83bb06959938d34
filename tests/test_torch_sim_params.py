"""The port's simulator parameters and numpy support modules against the
reference: `params`, `workloads`, `metrics`, `power`."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import metrics as jmet  # noqa: E402
from repro.core import params as jparams  # noqa: E402
from repro.core import power as jpower  # noqa: E402
from repro.core import workloads as jwl  # noqa: E402
from repro_torch.core import metrics as tmet  # noqa: E402
from repro_torch.core import params as tparams  # noqa: E402
from repro_torch.core import power as tpower  # noqa: E402
from repro_torch.core import workloads as twl  # noqa: E402

SMALL = dict(n_cpu=3, n_gpu=1, n_hwa=2, n_channels=2, buf_entries=24,
             fifo_size=5, dcs_size=3)


def test_simconfig_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jparams.SimConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tparams.SimConfig)]
    assert [n for n, _ in tf] == [n for n, _ in jf]
    for (n, jd), (_, td) in zip(jf, tf):
        if n == "timing":
            assert dataclasses.asdict(td) == dataclasses.asdict(jd)
        else:
            assert td == jd and type(td) is type(jd), n
    j, t = jparams.SimConfig(**SMALL), tparams.SimConfig(**SMALL)
    assert (t.n_src, t.gpu_cap) == (j.n_src, j.gpu_cap)
    assert t.replace(cpu_reserve=0.3).gpu_cap == j.replace(
        cpu_reserve=0.3).gpu_cap
    tm, jm = t.timing, j.timing
    assert (tm.lat_hit, tm.lat_conflict, tm.lat_closed) == \
        (jm.lat_hit, jm.lat_conflict, jm.lat_closed)
    hash(t)                                     # frozen, hence hashable
    with pytest.raises(dataclasses.FrozenInstanceError):
        t.n_cpu = 4


def test_class_constants_match():
    assert (tparams.CLS_CPU, tparams.CLS_GPU, tparams.CLS_HWA) == \
        (jparams.CLS_CPU, jparams.CLS_GPU, jparams.CLS_HWA)
    assert tparams.CLASS_NAMES == jparams.CLASS_NAMES
    assert tparams.N_CLASSES == jparams.N_CLASSES


def test_knob_names_and_dtypes_match():
    assert len(tparams.KNOB_SPECS) == 14
    assert tparams.KNOB_FIELDS == jparams.KNOB_FIELDS
    assert tparams.PERIOD_KNOBS == jparams.PERIOD_KNOBS
    for (tn, tdt), (jn, jdt) in zip(tparams.KNOB_SPECS, jparams.KNOB_SPECS):
        assert tn == jn
        assert str(tdt).removeprefix("torch.") == np.dtype(jdt).name
    cfg = tparams.SimConfig(**SMALL)
    kn = tparams.Knobs.from_cfg(cfg, sjf_prob=0.7, dash=True)
    jkn = jparams.Knobs.from_cfg(jparams.SimConfig(**SMALL), sjf_prob=0.7,
                                 dash=True)
    for n in tparams.KNOB_FIELDS:
        v, jv = getattr(kn, n), np.asarray(getattr(jkn, n))
        assert v.dim() == 0 and str(v.dtype).removeprefix("torch.") == \
            str(jv.dtype), n
        assert v.numpy().tobytes() == jv.tobytes(), n


def test_knob_errors_match():
    cfg, jcfg = tparams.SimConfig(), jparams.SimConfig()
    for bad in ({"atlas_epoch": 10}, {"nonsense": 1}):
        with pytest.raises(ValueError) as te:
            tparams.Knobs.from_cfg(cfg, **bad)
        with pytest.raises(ValueError) as je:
            jparams.Knobs.from_cfg(jcfg, **bad)
        assert str(te.value) == str(je.value)
    mixed = {"atlas_epoch": 5, "sjf_prob": 0.5}
    assert tparams.split_overrides(mixed) == jparams.split_overrides(mixed)
    with pytest.raises(ValueError, match="not tunable knobs"):
        tparams.split_overrides({"n_cpu": 2})


@pytest.mark.parametrize("reserve", [0.5, 0.3, 0.1, 0.77, 0.0])
def test_bound_config_matches_reference(reserve):
    cfg = tparams.SimConfig(buf_entries=134, cpu_reserve=reserve)
    jcfg = jparams.SimConfig(buf_entries=134, cpu_reserve=reserve)
    b = tparams.bind(cfg, tparams.Knobs.from_cfg(cfg))
    jb = jparams.bind(jcfg, jparams.Knobs.from_cfg(jcfg))
    assert b.gpu_cap == int(jb.gpu_cap)
    for n in tparams.KNOB_FIELDS:
        assert getattr(b, n) == np.asarray(getattr(jb, n)).item(), n
        assert type(getattr(b, n)) is type(np.asarray(
            getattr(jb, n)).item()), n
    assert b.n_src == jb.n_src and b.base is cfg
    assert tparams.bind(b, b.knobs).base is cfg
    with pytest.raises(AttributeError):
        b.n_cpu = 2


def test_static_bool_reads_host_values_only():
    assert tparams.static_bool(True) is True
    assert tparams.static_bool(False) is False
    assert tparams.static_bool(torch.tensor(True)) is None
    cfg = tparams.SimConfig()
    kn = tparams.Knobs.from_cfg(cfg).replace(dash=True)
    assert kn.dash.dtype == torch.bool
    assert tparams.static_bool(tparams.bind(cfg, kn).dash) is True


def test_workloads_match_reference():
    for n_cpu, n_hwa, seed in ((4, 0, 0), (16, 0, 7), (3, 2, 3)):
        tw = twl.make_workloads(n_cpu, n_per_cat=2, seed=seed, n_hwa=n_hwa)
        jw = jwl.make_workloads(n_cpu, n_per_cat=2, seed=seed, n_hwa=n_hwa)
        assert [dataclasses.astuple(w) for w in tw] == \
            [dataclasses.astuple(w) for w in jw]
        kw = dict(n_cpu=n_cpu, n_hwa=n_hwa)
        tcfg, jcfg = tparams.SimConfig(**kw), jparams.SimConfig(**kw)
        tp, ta = twl.pool_batch(tcfg, tw)
        jp, ja = jwl.pool_batch(jcfg, jw)
        assert np.array_equal(ta, ja) and tp.keys() == jp.keys()
        for k in tp:
            assert tp[k].dtype == jp[k].dtype and np.array_equal(tp[k],
                                                                 jp[k]), k
        tp, ta, tm = twl.alone_batch(tcfg)
        jp, ja, jm = jwl.alone_batch(jcfg)
        assert tm == jm and np.array_equal(ta, ja)
        for k in tp:
            assert np.array_equal(tp[k], jp[k]), k
    cfg = tparams.SimConfig(n_cpu=3, n_hwa=2)
    tp, ta = twl.bursty_batch(cfg)
    jp, ja = jwl.bursty_batch(jparams.SimConfig(n_cpu=3, n_hwa=2))
    assert np.array_equal(ta, ja)
    assert all(np.array_equal(tp[k], jp[k]) for k in tp)


def test_metrics_match_reference():
    rng = np.random.RandomState(5)
    kw = dict(n_cpu=3, n_hwa=1)
    tcfg, jcfg = tparams.SimConfig(**kw), jparams.SimConfig(**kw)
    wls = twl.make_workloads(3, n_per_cat=1, seed=2, n_hwa=1)
    names = [b[0] for b in twl.CPU_BENCH + twl.GPU_BENCH + twl.HWA_BENCH]
    alone = {n: float(rng.uniform(0.1, 2.0)) for n in names}
    rows_t, rows_j = [], []
    for w in wls:
        perf = rng.uniform(0.05, 2.0, tcfg.n_src)
        rows_t.append(tmet.workload_metrics(tcfg, w, perf, alone))
        rows_j.append(jmet.workload_metrics(jcfg, w, perf, alone))
    assert rows_t == rows_j
    assert tmet.aggregate(rows_t) == jmet.aggregate(rows_j)
    assert tmet.by_category(wls, rows_t) == jmet.by_category(wls, rows_j)
    W, S = len(wls), tcfg.n_src
    pool, _ = twl.pool_batch(tcfg, wls)
    m = {"lat_hist": rng.randint(0, 9, (W, S, tcfg.lat_bins)),
         "frames_released": rng.randint(0, 5, (W, S)).astype(np.float32),
         "dl_met": rng.randint(0, 5, (W, S)).astype(np.float32),
         "energy_act": rng.uniform(0, 99, (W, S)).astype(np.float32),
         "energy_rw": rng.uniform(0, 99, (W, S)).astype(np.float32),
         "energy_bg": rng.uniform(0, 99, W).astype(np.float32),
         "energy_wake": rng.uniform(0, 9, W).astype(np.float32),
         "completed": rng.randint(0, 99, (W, S)).astype(np.float32),
         "pd_cycles": rng.randint(0, 99, W).astype(np.float32)}
    tq, jq = tmet.qos_breakdown(tcfg, m, pool), jmet.qos_breakdown(jcfg, m,
                                                                   pool)
    assert tq.keys() == jq.keys()
    assert all(np.array_equal(tq[k], jq[k]) for k in tq)
    te = tmet.energy_breakdown(tcfg, m, pool, 1000, 0.5)
    je = jmet.energy_breakdown(jcfg, m, pool, 1000, 0.5)
    assert te.keys() == je.keys()
    assert all(np.array_equal(te[k], je[k]) for k in te)
    assert tmet.max_slowdown(np.ones(3), np.zeros(3, bool)) != \
        tmet.max_slowdown(np.ones(3), np.zeros(3, bool))     # NaN
    assert np.array_equal(tmet.class_vector(tcfg), jmet.class_vector(jcfg))


@pytest.mark.parametrize("policy", ["frfcfs", "atlas", "sms", "sms_dash"])
def test_power_matches_reference(policy):
    kw = dict(n_cpu=16, n_channels=4, buf_entries=134, fifo_size=6,
              dcs_size=4)
    tcfg, jcfg = tparams.SimConfig(**kw), jparams.SimConfig(**kw)
    assert tpower.structure_cost(tcfg, policy) == \
        jpower.structure_cost(jcfg, policy)
    assert tpower.full_mc_energy(tcfg, policy, 123.4, 56.7, 4000, 999.0) \
        == jpower.full_mc_energy(jcfg, policy, 123.4, 56.7, 4000, 999.0)
    assert tpower.compare(tcfg) == jpower.compare(jcfg)
