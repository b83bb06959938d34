"""`examples/quickstart_torch.py` prints the rows the reference computes.

Each policy's row (the aggregate over the quickstart's workloads, from
alone runs and shared runs) is computed by the port's example on the CPU
at reduced cycle counts and by the reference's own quickstart code at the
same counts; the aggregates must be equal and the printed rows identical.
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import policy as jpolicy  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_CYCLES, WARMUP = 300, 100
ROWS = ("frfcfs", "atlas", "parbs", "tcm", "sms", "sms_dash", "bliss",
        "squash_prio", "oldest")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def examples():
    """Both quickstarts, each registering its `Oldest` policy; the entry is
    taken out of each registry again afterwards."""
    tpolicy.names()
    jpolicy.names()
    port = _load("_quickstart_torch",
                 ROOT / "examples" / "quickstart_torch.py")
    ref = _load("_quickstart_ref", ROOT / "examples" / "quickstart.py")
    try:
        yield port, ref
    finally:
        for reg in (tpolicy.POLICY_REGISTRY, jpolicy.POLICY_REGISTRY):
            reg._entries.pop("oldest", None)


def _reference_row(ref, pol):
    """The body of the reference quickstart's loop, for one policy."""
    cfg = ref.SimConfig(n_cpu=4, n_channels=2, buf_entries=72, fifo_size=8,
                        dcs_size=4)
    wls = [w for w in ref.wl.make_workloads(cfg.n_cpu, n_per_cat=3, seed=0)
           if w.category in ("H", "HM")]
    pool, active = ref.wl.pool_batch(cfg, wls)
    apool, aactive, amap = ref.wl.alone_batch(cfg)
    am = ref.sim.simulate(cfg, pol, apool, aactive, N_CYCLES, WARMUP)
    alone = ref.wl.alone_perf_lookup(cfg, am, amap)
    m = ref.sim.simulate(cfg, pol, pool, active, N_CYCLES, WARMUP)
    perf = ref.sim.perf_vector(cfg, m, pool)
    rows = [ref.met.workload_metrics(cfg, w, perf[i], alone)
            for i, w in enumerate(wls)]
    a = ref.met.aggregate(rows)
    line = (f"{pol:12s} {a['weighted_speedup']:6.3f} "
            f"{a['cpu_weighted_speedup']:6.3f} {a['gpu_speedup']:6.3f} "
            f"{a['max_slowdown']:6.2f}")
    return a, line


def test_same_configuration_and_policies(examples):
    port, _ = examples
    assert port.CFG.replace() == port.SimConfig(
        n_cpu=4, n_channels=2, buf_entries=72, fifo_size=8, dcs_size=4)
    # the reference quickstart's nine rows, in the reference's order
    assert tpolicy.names() == ROWS
    assert tpolicy.names() == jpolicy.names()


@pytest.mark.parametrize("pol", ROWS)
def test_printed_row_equals_the_reference_row(examples, pol, capsys):
    port, ref = examples
    out = port.main(["--device", "cpu", "--policies", pol,
                     "--cycles", str(N_CYCLES), "--warmup", str(WARMUP)])
    printed = capsys.readouterr().out.splitlines()
    want, line = _reference_row(ref, pol)
    got = out[pol]
    assert got.keys() == want.keys()
    for k in want:
        assert np.float64(got[k]) == np.float64(want[k]), (k, got[k],
                                                           want[k])
    assert line in printed, (line, printed)
    assert printed[0] == "6 workloads x 5 sources, 2 channels"
