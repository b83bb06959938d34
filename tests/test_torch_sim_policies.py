"""The port's atlas, parbs, tcm, bliss and squash_prio against the
reference's: `simulate` at W = 3 with `np.array_equal` on every metric,
with periods short enough for many boundaries (ATLAS decays, TCM quanta,
BLISS clears, SQUASH draws) and a 3-class pool where SQUASH's urgent tier
fires; each row of the W = 3 batch against its own W = 1 run; ATLAS's final
state across decay epochs where a fused and an unfused multiply-add round
apart; `pairwise_rank` against `rank_pos`; the exact `fma_f32`."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="dev dep; pip install -r "
                    "requirements-dev.txt")

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import simulator as jsim  # noqa: E402
from repro.core import workloads as jwl  # noqa: E402
from repro.core.params import SimConfig as JConfig  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core.params import SimConfig  # noqa: E402
from repro_torch.core.policies.parbs import pairwise_rank  # noqa: E402
from repro_torch.core.schedulers import rank_pos  # noqa: E402

N_CYCLES, WARMUP = 400, 100
# the goldens' configuration, with the periods cut so that every boundary
# fires many times in 500 cycles (25 ATLAS epochs, 10 TCM quanta, 7 BLISS
# clears, 20 SQUASH draws); squash_prio runs a 3-class pool (an HWA with
# short frames), where its urgent tier fires
KW = dict(n_cpu=3, n_gpu=1, n_channels=2, buf_entries=24, fifo_size=5,
          dcs_size=3, atlas_epoch=20, tcm_quantum=50,
          bliss_clear_interval=70, squash_epoch=25)
CASES = {"atlas": KW, "parbs": KW, "tcm": KW, "bliss": KW,
         "squash_prio": {**KW, "n_hwa": 1}}


def _batch(kw):
    cfg = JConfig(**kw)
    wls = jwl.make_workloads(cfg.n_cpu, n_per_cat=1, seed=5,
                             n_hwa=cfg.n_hwa)
    pool, active = jwl.pool_batch(cfg, [wls[i] for i in (0, 3, 6)])
    hwa = pool["src_class"] == 2
    pool["dl_period"] = np.where(hwa, 120, 0).astype(np.int32)
    pool["dl_reqs"] = np.where(hwa, 30, 0).astype(np.int32)
    return pool, active


def _golden_pool(cfg):
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


_RUNS = {}


def _port(pol):
    if pol not in _RUNS:
        pool, active = _batch(CASES[pol])
        _RUNS[pol] = tsim.simulate(SimConfig(**CASES[pol]), pol, pool,
                                   active, N_CYCLES, WARMUP, device="cpu")
    return _RUNS[pol]


def _equal(got, want, ctx):
    assert got.keys() == want.keys(), (ctx, set(got) ^ set(want))
    for k in want:
        assert got[k].dtype == want[k].dtype, (ctx, k)
        assert got[k].shape == want[k].shape, (ctx, k)
        assert np.array_equal(got[k], want[k]), (ctx, k)


@pytest.mark.parametrize("pol", sorted(CASES))
def test_policy_metrics_equal_reference(pol):
    kw = CASES[pol]
    pool, active = _batch(kw)
    want = jsim.simulate(JConfig(**kw), pol, pool, active, N_CYCLES, WARMUP)
    got = _port(pol)
    _equal(got, want, pol)
    assert got["completed"].sum() > 0
    if pol == "squash_prio":
        ua = got["urgent_admits"]
        hwa = pool["src_class"] == 2
        assert ua[hwa].sum() > 0, "the urgent tier never fired"
        assert (ua[~hwa] == 0).all()


@pytest.mark.parametrize("pol", sorted(CASES))
def test_each_row_equals_its_own_run(pol):
    """Every reduction in the policies runs over one workload's own axes:
    row w of the W = 3 batch equals the W = 1 run of workload w."""
    kw = CASES[pol]
    pool, active = _batch(kw)
    batch = _port(pol)
    for w in range(active.shape[0]):
        one = tsim.simulate(SimConfig(**kw), pol,
                            {k: v[w:w + 1] for k, v in pool.items()},
                            active[w:w + 1], N_CYCLES, WARMUP, device="cpu")
        _equal(one, {k: v[w:w + 1] for k, v in batch.items()},
               f"{pol} row {w}")


def test_atlas_decay_state_across_epochs():
    """ATLAS's `alpha * attained + served` over 38 epochs of 20 cycles: the
    reference rounds it once (XLA fuses the multiply-add); at cycles 500 and
    760 an unfused product and sum round to another float32 on this pool,
    so the final states at 761 cycles pin the fused form."""
    kw = dict(KW)
    cfg = SimConfig(**kw)
    pool = _golden_pool(cfg)
    got = tsim.simulate_debug(cfg, "atlas", pool, np.ones(cfg.n_src, bool),
                              761, device="cpu")
    want = jsim.simulate_debug(JConfig(**kw), "atlas", pool,
                               np.ones(cfg.n_src, bool), 761)
    for part, g, w in zip(("src", "sched", "dram"), got, want):
        assert g.keys() == w.keys(), part
        for k in w:
            assert g[k].dtype == w[k].dtype, (part, k)
            assert np.array_equal(g[k], w[k]), (part, k)
    att = torch.from_numpy(got[1]["attained"])
    assert att.abs().sum() > 0


def test_fma_f32_rounds_once():
    # the exact a*b+c lies just below a float32 midpoint: a float64 sum
    # rounds onto the midpoint and a second rounding goes the wrong way
    a = torch.tensor([2.0 ** -24 * (1 + 2.0 ** -18)], dtype=torch.float32)
    b = 1 - 2.0 ** -18
    c = torch.tensor([1 + 2.0 ** -23], dtype=torch.float32)
    assert (a.double() * b + c.double()).float().item() == 1 + 2.0 ** -22
    assert engine.fma_f32(a, b, c).item() == 1 + 2.0 ** -23
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1000).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 50, 1000).astype(np.float32))
    want = (x.double() * 0.875 + y.double()).float()    # exact here
    assert torch.equal(engine.fma_f32(x, 0.875, y), want)


@settings(deadline=None, max_examples=25)
@given(st.lists(st.integers(0, 4), min_size=1, max_size=12),
       st.integers(1, 3))
def test_pairwise_rank_equals_rank_pos(vals, rows):
    """Stable ranks with ties broken by index, on int and float keys."""
    key = torch.tensor([vals] * rows, dtype=torch.int32)
    key = key + torch.arange(rows, dtype=torch.int32)[:, None] % 2
    for k in (key, key.to(torch.float32) * 0.5):
        got = pairwise_rank(k)
        assert got.dtype == torch.int32
        assert torch.equal(got, rank_pos(k))
