"""The port's simulator reproduces the reference's golden final states.

`tests/golden_policy_states.json` holds per-key sha1 digests of the
reference's `simulate_debug` final raw state (dtype, shape, bytes). The
port's `simulate_debug` (its batched path at W = 1, exported to the
reference dtypes) must reproduce them for every policy they hold; the energy
and qos counters, which the goldens predate, must equal a live reference
run array for array.
"""
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import simulator as jsim  # noqa: E402
from repro.core.params import SimConfig as JConfig  # noqa: E402
from repro_torch.core import energy, engine, qos  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core.params import SimConfig  # noqa: E402

GOLDEN = json.loads(
    (Path(__file__).parent / "golden_policy_states.json").read_text())
KW = dict(n_cpu=3, n_gpu=1, n_channels=2, buf_entries=24, fifo_size=5,
          dcs_size=3)
CFG = SimConfig(**KW)
N_CYCLES = 1_500
PORTED = ("frfcfs", "atlas", "parbs", "tcm", "sms", "sms_dash")
ESSENTIAL_SCHED = {
    "sms": ("f_len", "f_row", "d_len", "d_src", "drain_left", "rr_bank"),
    "centralized": ("valid", "src", "bank", "row", "birth", "marked"),
}


def _golden_pool(cfg):
    """The capture-time generator (seed 42)."""
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


def _digest(tree):
    out = {}
    for key in sorted(tree):
        v = np.ascontiguousarray(tree[key])
        h = hashlib.sha1()
        h.update(str(v.dtype).encode())
        h.update(str(v.shape).encode())
        h.update(v.tobytes())
        out[key] = h.hexdigest()
    return out


_RUNS = {}


def _port_run(name):
    if name not in _RUNS:
        _RUNS[name] = tsim.simulate_debug(CFG, name, _golden_pool(CFG),
                                          np.ones(CFG.n_src, bool),
                                          n_cycles=N_CYCLES, device="cpu")
    return _RUNS[name]


@pytest.mark.parametrize("policy_name", PORTED)
def test_port_reproduces_golden_digests(policy_name):
    assert CFG.energy_enabled and CFG.qos_enabled
    st_f, sched_f, dram_f = _port_run(policy_name)
    g = GOLDEN[policy_name]
    for part, tree in (("src", st_f), ("dram", dram_f)):
        new = _digest(tree)
        allowed = set(energy.STATE_KEYS) | set(qos.STATE_KEYS) \
            if part == "dram" else set(engine.NCLASS_SRC_KEYS)
        assert set(new) ^ set(g[part]) <= allowed, \
            f"{policy_name} {part} keys drifted: {set(new) ^ set(g[part])}"
        for k, h in g[part].items():
            assert new[k] == h, f"{policy_name} {part}[{k}] diverged"
    sched = _digest(sched_f)
    essential = ESSENTIAL_SCHED[
        "sms" if policy_name.startswith("sms") else "centralized"]
    for k in essential:
        assert k in sched and k in g["sched"], f"missing sched key {k}"
    common = set(sched) & set(g["sched"])
    assert common >= set(essential)
    for k in common:
        assert sched[k] == g["sched"][k], f"{policy_name} sched[{k}] diverged"


@pytest.mark.parametrize("policy_name", PORTED)
def test_energy_and_qos_equal_a_live_reference_run(policy_name):
    st_f, sched_f, dram_f = _port_run(policy_name)
    j_st, j_sched, j_dram = jsim.simulate_debug(
        JConfig(**KW), policy_name, _golden_pool(CFG),
        np.ones(CFG.n_src, bool), n_cycles=N_CYCLES)
    for k in energy.STATE_KEYS + qos.STATE_KEYS:
        assert dram_f[k].dtype == j_dram[k].dtype, k
        assert np.array_equal(dram_f[k], j_dram[k]), k
    # and the whole final state, every key the reference has
    for mine, ref in ((st_f, j_st), (sched_f, j_sched), (dram_f, j_dram)):
        assert mine.keys() == ref.keys()
        for k in ref:
            assert mine[k].dtype == ref[k].dtype, k
            assert np.array_equal(mine[k], ref[k]), k
    assert dram_f["lat_hist"].sum(-1).tolist() == dram_f["issued"].tolist()


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pool = _golden_pool(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.simulate_debug(CFG, "frfcfs", pool, np.ones(CFG.n_src, bool),
                            n_cycles=5)
    batch = {k: v[None] for k, v in pool.items()}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsim.simulate(CFG, "sms", batch, np.ones((1, CFG.n_src), bool), 5, 1)
    assert tsim.resolve_device("cpu").type == "cpu"
