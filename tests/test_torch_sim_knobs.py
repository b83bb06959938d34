"""The port's knob-grid drivers against the tunable-knob contract: every
slice of `simulate_grid` and `simulate_stacked_grid` equals a solo run with
the same values baked into SimConfig and the reference's grid run; a
period-like override stays a per-slice Python int; sms_dash is the dash
knob point of sms; the default point is the legacy run; the knob guards
raise as the reference's do."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import params as jparams  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import workloads as jwl  # noqa: E402
from repro.core.params import SimConfig as JConfig  # noqa: E402
from repro_torch.core import params  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core.params import Knobs, SimConfig  # noqa: E402

KW = dict(n_cpu=3, n_gpu=1, n_channels=2, buf_entries=24, fifo_size=5,
          dcs_size=3)
CFG = SimConfig(**KW)
N_CYCLES, WARMUP = 300, 100

# one non-default value point per policy (value-like knobs only)
VALUE_POINTS = {
    "frfcfs": {"cpu_reserve": 0.25},
    "atlas": {"atlas_alpha": 0.75},
    "parbs": {"parbs_cap": 3},
    "tcm": {"tcm_lat_frac": 0.5},
    "bliss": {"bliss_threshold": 2},
    "squash_prio": {"squash_lead": 40, "squash_pb": 0.5},
    "sms": {"sjf_prob": 0.5, "batch_age_cap": 100, "dash": True},
}
# period-like knobs ride each slice's own config; short enough to fire
# several times in 400 cycles
PERIOD_POINTS = {
    "atlas": {"atlas_epoch": 150},
    "tcm": {"tcm_quantum": 80},
    "bliss": {"bliss_clear_interval": 200},
}


@pytest.fixture(scope="module")
def pool():
    wls = jwl.make_workloads(CFG.n_cpu, n_per_cat=1)[:4]
    return jwl.pool_batch(JConfig(**KW), wls)


def _assert_equal(a, b, ctx, skip_keys=()):
    # urgent_admits surfaces whenever squash_prio is in the stacked family,
    # so a stacked slice may carry it while the solo run does not
    assert (set(a) ^ set(b)) <= {"urgent_admits"}, ctx
    for k in set(a) & set(b):
        if k in skip_keys:
            continue
        assert a[k].dtype == b[k].dtype, f"{ctx}: metric {k}"
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{ctx}: {k}")


@pytest.mark.parametrize("pol", sorted(VALUE_POINTS))
def test_grid_slice_matches_baked_config_and_reference(pol, pool):
    p, a = pool
    ov = VALUE_POINTS[pol]
    got = tsim.simulate_grid(CFG, pol, [{}, ov], p, a, N_CYCLES, WARMUP,
                             device="cpu")
    want = jsim.simulate_grid(JConfig(**KW), pol, [{}, ov], p, a, N_CYCLES,
                              WARMUP)
    for i in range(2):
        assert got[i].keys() == want[i].keys()
        _assert_equal(got[i], want[i], f"{pol} slice {i} vs reference")
    baked = tsim.simulate(CFG.replace(**ov), pol, p, a, N_CYCLES, WARMUP,
                          device="cpu")
    _assert_equal(got[1], baked, f"{pol} variant slice vs baked")


def test_stacked_grid_matches_baked_configs_and_reference(pool):
    """Policy x knob points on one folded slice axis, with period-like
    overrides (each slice's own Python int) and a repeated policy."""
    p, a = pool
    slices = [(pol, {**VALUE_POINTS[pol], **PERIOD_POINTS.get(pol, {})})
              for pol in sorted(set(VALUE_POINTS) - {"sms"})] \
        + [("frfcfs", {})]
    got = tsim.simulate_stacked_grid(CFG, slices, p, a, N_CYCLES, WARMUP,
                                     device="cpu")
    want = jsim.simulate_stacked_grid(JConfig(**KW), slices, p, a, N_CYCLES,
                                      WARMUP)
    assert len(got) == len(slices)
    for (pol, ov), g, w in zip(slices, got, want):
        assert g.keys() == w.keys()
        _assert_equal(g, w, f"stacked {pol}@{ov} vs reference")
        legacy = tsim.simulate(CFG.replace(**ov), pol, p, a, N_CYCLES,
                               WARMUP, device="cpu")
        _assert_equal(g, legacy, f"stacked {pol}@{ov} vs baked",
                      skip_keys=("sim_steps",))


def test_sms_grid_is_sms_and_sms_dash(pool):
    """sms at [{}, dash=True] on the folded step (tick and select per
    slice) == the solo sms and sms_dash runs: the fork is only the knob."""
    p, a = pool
    grid = tsim.simulate_grid(CFG, "sms", [{}, {"dash": True}], p, a,
                              N_CYCLES, WARMUP, device="cpu")
    for g, name in zip(grid, ("sms", "sms_dash")):
        solo = tsim.simulate(CFG, name, p, a, N_CYCLES, WARMUP, device="cpu")
        _assert_equal(g, solo, f"sms grid vs {name}")


def test_default_grid_slice_is_legacy_run(pool):
    p, a = pool
    got = tsim.simulate_grid(CFG, "atlas", [{}], p, a, N_CYCLES, WARMUP,
                             device="cpu")[0]
    legacy = tsim.simulate(CFG, "atlas", p, a, N_CYCLES, WARMUP,
                           device="cpu")
    _assert_equal(got, legacy, "atlas default point")


def test_default_knobs_match_cfg():
    kn = Knobs.from_cfg(CFG)
    for f in params.KNOB_FIELDS:
        assert getattr(kn, f).item() == pytest.approx(getattr(CFG, f)), f


def test_period_knobs_rejected_as_value_overrides(pool):
    with pytest.raises(ValueError, match="period"):
        Knobs.from_cfg(CFG, atlas_epoch=1500)
    with pytest.raises(ValueError):
        Knobs.from_cfg(CFG, not_a_knob=1)
    p, a = pool
    with pytest.raises(ValueError, match="period"):
        tsim.simulate_grid(CFG, "atlas", [{"atlas_epoch": 1500}], p, a, 5, 1,
                           device="cpu")


def test_split_overrides_partitions():
    mixed = {"atlas_epoch": 1500, "atlas_alpha": 0.75}
    assert params.split_overrides(mixed) == jparams.split_overrides(mixed)
    per, val = params.split_overrides(mixed)
    assert per == {"atlas_epoch": 1500} and val == {"atlas_alpha": 0.75}
    with pytest.raises(ValueError):
        params.split_overrides({"nope": 1})


def test_sms_dash_not_stackable(pool):
    assert not tpolicy.is_stackable("sms_dash", CFG)
    assert tpolicy.is_stackable("frfcfs", CFG)
    p, a = pool
    with pytest.raises(ValueError, match="not stackable"):
        tsim.simulate_stacked_grid(CFG, ["sms_dash"], p, a, 5, 1,
                                   device="cpu")


def test_row_config_serves_only_the_shared_knobs():
    """The shared work of a folded step reads gpu_cap and energy_pd_idle
    per row and no other knob."""
    b = [params.bind(CFG, Knobs.from_cfg(CFG, **ov)) for ov in
         ({}, {"cpu_reserve": 0.25}, {"energy_pd_idle": 7, "sjf_prob": 0.1})]
    rc = params.row_config(CFG, b, 2, "cpu")
    assert rc.gpu_cap.tolist() == [[12], [12], [18], [18], [12], [12]]
    assert rc.energy_pd_idle.tolist() == [[48]] * 4 + [[7]] * 2
    assert rc.n_channels == CFG.n_channels and rc.timing == CFG.timing
    with pytest.raises(AttributeError, match="sjf_prob"):
        rc.sjf_prob
