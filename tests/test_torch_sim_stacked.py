"""The port's stacked cross-policy driver (`schedulers.make_stacked_step`,
the family folded into the leading row axis) against the goldens, the
port's own solo runs and the reference's stacked run; the stackable
surface; the union schema's padding and its refusal of collisions."""
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import simulator as jsim  # noqa: E402
from repro.core.params import SimConfig as JConfig  # noqa: E402
from repro_torch.core import energy, engine, qos  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import schedulers  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core.params import SimConfig  # noqa: E402

KW = dict(n_cpu=3, n_gpu=1, n_channels=2, buf_entries=24, fifo_size=5,
          dcs_size=3)
CFG = SimConfig(**KW)
GOLDEN = json.loads(
    (Path(__file__).parent / "golden_policy_states.json").read_text())
FAMILY = tsim.stackable_names(CFG)
N_CYCLES = 1_500


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


@pytest.fixture(scope="module")
def stacked_final_states():
    """One stacked run of the whole family at the goldens' configuration."""
    return tsim.simulate_debug_stacked(CFG, FAMILY, _golden_pool(CFG),
                                       np.ones(CFG.n_src, bool), N_CYCLES,
                                       device="cpu")


@pytest.mark.parametrize("policy_name", [n for n in FAMILY if n in GOLDEN])
def test_stacked_slice_reproduces_golden(policy_name, stacked_final_states):
    st_f, sched_f, dram_f = stacked_final_states[policy_name]
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
    shared = set(sched) & set(g["sched"])
    assert {"valid", "src", "bank", "row", "birth", "marked"} <= shared
    for k in shared:
        assert sched[k] == g["sched"][k], f"{policy_name} sched[{k}] diverged"


@pytest.mark.parametrize("policy_name",
                         [n for n in FAMILY if n not in GOLDEN])
def test_stacked_slice_equals_solo_debug(policy_name, stacked_final_states):
    """Policies younger than the goldens (bliss, squash_prio): the stacked
    slice against the port's solo run, array for array."""
    solo = tsim.simulate_debug(CFG, policy_name, _golden_pool(CFG),
                               np.ones(CFG.n_src, bool), N_CYCLES,
                               device="cpu")
    for part, s, r in zip(("src", "sched", "dram"),
                          stacked_final_states[policy_name], solo):
        assert s.keys() == r.keys(), (policy_name, part)
        for k in r:
            assert s[k].dtype == r[k].dtype, (policy_name, part, k)
            assert np.array_equal(s[k], r[k]), (policy_name, part, k)


def _batch(W=2, seed=3):
    rng = np.random.RandomState(seed)
    S = CFG.n_src
    mpki = rng.uniform(2, 40, (W, S)).astype(np.float32)
    pool = {
        "mpki": mpki,
        "inst_per_miss": np.maximum(1000.0 / mpki, 1.0).astype(np.float32),
        "rbl": rng.uniform(0.1, 0.95, (W, S)).astype(np.float32),
        "blp": rng.randint(1, 7, (W, S)).astype(np.int32),
        "is_gpu": np.tile([False] * CFG.n_cpu + [True], (W, 1)),
    }
    return pool, np.ones((W, S), bool)


def test_stacked_metrics_equal_reference_and_solo():
    """The whole family stacked: every slice equals the reference's stacked
    run in every metric, and the port's own `simulate` in every metric but
    the family's `sim_steps`."""
    pool, active = _batch()
    got = tsim.simulate_stacked(CFG, FAMILY, pool, active, 400, 100,
                                device="cpu")
    want = jsim.simulate_stacked(JConfig(**KW), FAMILY, pool, active, 400,
                                 100)
    assert list(got) == list(FAMILY)
    for pol in FAMILY:
        assert got[pol].keys() == want[pol].keys(), pol
        for k in want[pol]:
            assert got[pol][k].dtype == want[pol][k].dtype, (pol, k)
            assert np.array_equal(got[pol][k], want[pol][k]), (pol, k)
        # squash_prio's counter rides the union schema on every slice
        assert "urgent_admits" in got[pol]
    for pol in ("frfcfs", "atlas", "squash_prio"):
        solo = tsim.simulate(CFG, pol, pool, active, 400, 100, device="cpu")
        assert set(got[pol]) ^ set(solo) <= {"urgent_admits"}
        for k in solo:
            assert np.array_equal(got[pol][k], solo[k]), (pol, k)


def test_stackable_surface():
    assert FAMILY == ("frfcfs", "atlas", "parbs", "tcm", "bliss",
                      "squash_prio")
    assert FAMILY == tuple(jsim.stackable_names(JConfig(**KW)))
    assert not tpolicy.is_stackable("sms", CFG)
    assert not tpolicy.is_stackable("sms_dash", CFG)
    with pytest.raises(ValueError, match="not stackable"):
        tsim.simulate_stacked(CFG, ("frfcfs", "sms"), *_batch(1), 5, 1,
                              device="cpu")


def test_undeclared_write_is_dropped():
    """Only the declared write-sets are re-concatenated: a write outside
    them never reaches the stacked state, as in the reference."""
    class Sneaky(schedulers.CentralizedPolicy):
        name = "_sneaky"
        stacked_issue_keys = ()

        def extra_state(self, cfg, W, device):
            return {"hits_seen": torch.zeros((W,), dtype=torch.int32,
                                             device=device)}

        def on_issue(self, cfg, pool, buf, do, pick, src, t):
            return {**buf, "hits_seen": buf["hits_seen"] + 1}

    tpolicy.POLICY_REGISTRY.register(Sneaky.name)(Sneaky())
    try:
        pool = _golden_pool(CFG)
        stk = tsim.simulate_debug_stacked(CFG, ("frfcfs", Sneaky.name), pool,
                                          np.ones(CFG.n_src, bool), 50,
                                          device="cpu")
        solo = tsim.simulate_debug(CFG, Sneaky.name, pool,
                                   np.ones(CFG.n_src, bool), 50,
                                   device="cpu")
    finally:
        tpolicy.POLICY_REGISTRY._entries.pop(Sneaky.name)
    assert int(solo[1]["hits_seen"]) == 50
    assert int(stk[Sneaky.name][1]["hits_seen"]) == 0


def test_union_state_pads_and_rejects_collisions():
    pols = [tpolicy.get(n) for n in FAMILY]
    padded = schedulers.stacked_union_state(CFG, pols, 2, "cpu")
    keys = set(padded[0])
    for p, s in zip(pols, padded):
        assert set(s) == keys, p.name
        for k, v in p.init_state(CFG, 2, "cpu").items():   # own state kept
            assert s[k].shape == v.shape and s[k].dtype == v.dtype
            assert torch.equal(s[k], v), (p.name, k)
        for k in keys - set(p.init_state(CFG, 2, "cpu")):  # padding is 0
            assert not s[k].any(), (p.name, k)
    # the same union as the reference's, key for key and dtype for dtype
    from repro.core import policy as jpolicy
    from repro.core import schedulers as jsched
    jpad = jsched.stacked_union_state(JConfig(**KW),
                                      [jpolicy.get(n) for n in FAMILY])
    assert keys == set(jpad[0])
    for k in keys:
        want = np.asarray(jpad[0][k])
        got = padded[0][k][0].numpy()
        assert got.shape == want.shape, k
        assert got.dtype == want.dtype or (k == "sq_rng"
                                           and want.dtype == np.uint32), k

    class Collider:
        name = "collider"

        def init_state(self, cfg, W, device):
            return {"pri_src": torch.zeros((W, 1), dtype=torch.float32)}

    with pytest.raises(ValueError, match="collision"):
        schedulers.stacked_union_state(CFG, pols + [Collider()], 2, "cpu")
