"""The N-class requester model through the port: a legacy 2-class pool runs
bit-identically to the same pool with the classes spelled out, for every
built-in policy; the HWA frame-deadline accounting identities; the frame
jitter; stacked parity on a 3-class pool, against the solo runs and the
reference's stacked run; SQUASH's urgent tier only on deadline sources."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import simulator as jsim  # noqa: E402
from repro.core.params import SimConfig as JConfig  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core.params import (CLS_CPU, CLS_GPU, CLS_HWA,  # noqa: E402
                                     SimConfig)

KW2 = dict(n_cpu=3, n_gpu=1, n_channels=2, buf_entries=32, fifo_size=5,
           dcs_size=3)
CFG2 = SimConfig(**KW2)
CFG3 = CFG2.replace(n_hwa=2)
CYCLES, WARMUP = 1_000, 300
# the reference's registration order
BUILTIN = ("frfcfs", "atlas", "parbs", "tcm", "sms", "sms_dash", "bliss",
           "squash_prio")


def _legacy_pool():
    """2-class pool with only the legacy keys (no src_class/dl_jitter)."""
    mpki = np.array([25, 40, 18, 1000], np.float32)
    return {
        "mpki": mpki, "inst_per_miss": np.maximum(1000 / mpki, 1),
        "rbl": np.array([.5, .4, .6, .9], np.float32),
        "blp": np.array([3, 2, 4, 4], np.int32),
        "is_gpu": np.array([0, 0, 0, 1], bool),
    }


def _nclass_pool(jitter=(12, 0)):
    """3 CPUs + 1 GPU + 2 frame-deadline HWAs, full N-class schema."""
    mpki = np.array([25, 40, 18, 1000, 1000, 1000], np.float32)
    return {
        "mpki": mpki, "inst_per_miss": np.maximum(1000 / mpki, 1),
        "rbl": np.array([.5, .4, .6, .9, .85, .7], np.float32),
        "blp": np.array([3, 2, 4, 4, 2, 3], np.int32),
        "is_gpu": np.array([0, 0, 0, 1, 0, 0], bool),
        "src_class": np.array([CLS_CPU] * 3 + [CLS_GPU] + [CLS_HWA] * 2,
                              np.int32),
        "dl_period": np.array([0, 0, 0, 0, 500, 400], np.int32),
        "dl_reqs": np.array([0, 0, 0, 0, 25, 15], np.int32),
        "dl_jitter": np.array([0, 0, 0, 0, jitter[0], jitter[1]], np.int32),
    }


def _batch(pool):
    return {k: v[None] for k, v in pool.items()}


def _run(cfg, pol, pool, n_cycles=CYCLES, warmup=WARMUP):
    active = np.ones((1, cfg.n_src), bool)
    return tsim.simulate(cfg, pol, _batch(pool), active, n_cycles, warmup,
                         device="cpu")


def _expected_frames(period, warmup=WARMUP, n_cycles=CYCLES):
    return sum(1 for t in range(warmup, warmup + n_cycles)
               if t > 0 and t % period == 0)


@pytest.mark.parametrize("pol", BUILTIN)
def test_legacy_pool_bit_identical_to_explicit_classes(pol):
    legacy = _legacy_pool()
    explicit = dict(legacy)
    explicit["src_class"] = np.array([CLS_CPU, CLS_CPU, CLS_CPU, CLS_GPU],
                                     np.int32)
    for k in ("dl_period", "dl_reqs", "dl_jitter"):
        explicit[k] = np.zeros(CFG2.n_src, np.int32)
    a = _run(CFG2, pol, legacy, 500, 100)
    b = _run(CFG2, pol, explicit, 500, 100)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{pol}:{k}")
    assert a["completed"].sum() > 0


@pytest.mark.parametrize("pol", ("frfcfs", "sms_dash"))
def test_frame_accounting_identity(pol):
    m = _run(CFG3, pol, _nclass_pool())
    rel = m["frames_released"][0]
    np.testing.assert_array_equal(rel, m["dl_met"][0] + m["dl_missed"][0],
                                  err_msg=pol)
    assert rel[4] == _expected_frames(500)
    assert rel[5] == _expected_frames(400)
    assert (rel[:4] == 0).all()


def test_jitter_delays_release_not_accounting():
    m0 = _run(CFG3, "frfcfs", _nclass_pool(jitter=(0, 0)))
    mj = _run(CFG3, "frfcfs", _nclass_pool(jitter=(120, 90)))
    for m in (m0, mj):
        np.testing.assert_array_equal(
            m["frames_released"][0, 4:], [_expected_frames(500),
                                          _expected_frames(400)])
    assert mj["emitted"][0, 4:].sum() <= m0["emitted"][0, 4:].sum()
    want = jsim.simulate(JConfig(**KW2, n_hwa=2), "frfcfs",
                         _batch(_nclass_pool(jitter=(120, 90))),
                         np.ones((1, CFG3.n_src), bool), CYCLES, WARMUP)
    for k in want:
        np.testing.assert_array_equal(mj[k], want[k], err_msg=k)


def test_stacked_parity_on_3class_pool():
    """Every stackable policy's slice on a 3-class pool equals its solo run
    and the reference's stacked slice: the N-class keys (src_class,
    dl_jitter, frames_released, lat_hist, sq_urgent_adm) ride the union."""
    pool, active = _nclass_pool(), np.ones((1, CFG3.n_src), bool)
    fam = tsim.stackable_names(CFG3)
    assert "squash_prio" in fam
    stacked = tsim.simulate_stacked(CFG3, fam, _batch(pool), active, CYCLES,
                                    WARMUP, device="cpu")
    want = jsim.simulate_stacked(JConfig(**KW2, n_hwa=2), fam, _batch(pool),
                                 active, CYCLES, WARMUP)
    for pol in fam:
        assert stacked[pol].keys() == want[pol].keys()
        for k in want[pol]:
            np.testing.assert_array_equal(stacked[pol][k], want[pol][k],
                                          err_msg=f"{pol}:{k} vs reference")
        solo = _run(CFG3, pol, pool)
        for k in solo:
            np.testing.assert_array_equal(stacked[pol][k], solo[k],
                                          err_msg=f"{pol}:{k} vs solo")
    assert stacked["squash_prio"]["urgent_admits"][0, 4:].sum() > 0


def test_squash_urgent_admissions_only_on_deadline_sources():
    m = _run(CFG3, "squash_prio", _nclass_pool())
    ua = m["urgent_admits"][0]
    assert ua[4:].sum() > 0, "HWA mix never hit the urgent tier"
    assert (ua[:4] == 0).all(), "urgent tier admitted a non-deadline source"
    # per-policy runs of urgent-tier-free policies don't grow the key
    assert "urgent_admits" not in _run(CFG3, "frfcfs", _nclass_pool(),
                                       200, 50)
