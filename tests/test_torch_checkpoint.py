"""Port's checkpointer (``repro_torch/checkpoint/checkpointer.py``): round
trip, atomic publish and prune, shape mismatch, async, and checkpoints
crossing between the packages both ways (the same npz keys), all exact
(``np.array_equal``)."""
import tempfile
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.checkpoint import checkpointer as jckpt
from repro.configs.base import reduced as jreduced
from repro.configs.registry import get_config as jget_config
from repro.models.registry import get_model as jget_model
from repro.optim import adamw as jadamw
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.models.common import params_from_numpy
from repro_torch.models.registry import get_model
from repro_torch.optim import adamw


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    return {"layer": {"w": t(4, 3), "b": t(3)},
            "stack": [t(2, 2) for _ in range(3)]}


def _equal(a, b):
    la, lb = tree_lib.flatten_with_path(a), tree_lib.flatten_with_path(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y), k


def test_checkpoint_roundtrip_exact():
    t = _tree()
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 7, t)
        assert ckpt.latest_step(d) == 7
        restored, manifest = ckpt.restore(d, 7, t)
        _equal(restored, t)
        assert manifest["step"] == 7
        assert manifest["keys"] == sorted(k for k, _ in
                                          tree_lib.flatten_with_path(t))


def test_checkpoint_atomic_and_prune():
    t = _tree()
    with tempfile.TemporaryDirectory() as d:
        assert ckpt.latest_step(d) is None
        for s in (1, 2, 3, 4):
            ckpt.save(d, s, t)
        ckpt.prune_old(d, keep=2)
        steps = sorted(int(p.name.split("_")[1])
                       for p in Path(d).glob("step_*"))
        assert steps == [3, 4]
        assert not list(Path(d).glob(".tmp*")), "tmp dirs must not survive"
        ckpt.save(d, 4, _tree(1))             # a re-save replaces the step
        _equal(ckpt.restore(d, 4, t)[0], _tree(1))


def test_checkpoint_shape_mismatch_raises():
    t = _tree()
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 1, t)
        bad = {"layer": {"w": torch.zeros(5, 3), "b": torch.zeros(3)},
               "stack": t["stack"]}
        with pytest.raises(ValueError, match="shape mismatch"):
            ckpt.restore(d, 1, bad)


def test_checkpoint_async_snapshots_before_the_thread():
    t = _tree()
    want = [x.clone() for x in tree_lib.leaves(t)]
    with tempfile.TemporaryDirectory() as d:
        th = ckpt.save_async(d, 2, t)
        assert isinstance(th, threading.Thread)
        for x in tree_lib.leaves(t):          # training goes on in place
            x.add_(1.0)
        th.join()
        restored, _ = ckpt.restore(d, 2, t)
        assert all(torch.equal(a, b)
                   for a, b in zip(tree_lib.leaves(restored), want))


def test_restore_to_a_named_device_and_dtype():
    t = _tree()
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 3, t)
        target = tree_lib.tree_map(lambda x: x.double(), t)
        restored, _ = ckpt.restore(d, 3, target, device="cpu")
        assert all(x.dtype == torch.float64 and x.device.type == "cpu"
                   for x in tree_lib.leaves(restored))


def _train_states():
    """The reference's and the port's trainer trees from one JAX init."""
    jcfg = jreduced(jget_config("xlstm-125m"), n_layers=2)
    cfg = reduced(get_config("xlstm-125m"), n_layers=2)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(0))
    jopt = jadamw.init(jp)
    jopt = jopt._replace(
        step=jnp.int32(5),
        mu=jax.tree_util.tree_map(lambda a: a * 0.5, jopt.mu),
        nu=jax.tree_util.tree_map(lambda a: a + 0.25, jopt.nu))
    jtree = {"params": jp, "opt": jopt, "err": jnp.zeros(())}
    p = get_model(cfg).init(torch.Generator().manual_seed(1))
    ttree = {"params": p, "opt": adamw.init(p), "err": torch.zeros(())}
    return jtree, ttree


def test_reference_checkpoint_restores_into_the_port():
    jtree, ttree = _train_states()
    with tempfile.TemporaryDirectory() as d:
        jckpt.save(d, 5, jtree)
        assert ckpt.latest_step(d) == 5
        restored, manifest = ckpt.restore(d, 5, ttree)
        assert manifest["step"] == 5
        _equal(restored, jax.tree_util.tree_map(np.asarray, jtree))
        assert isinstance(restored["opt"], adamw.AdamWState)


def test_port_checkpoint_restores_into_the_reference():
    jtree, _ = _train_states()
    host = jax.tree_util.tree_map(np.asarray, jtree)
    ttree = {"params": params_from_numpy(host["params"], "cpu"),
             "opt": adamw.AdamWState(*(params_from_numpy(x, "cpu")
                                       for x in host["opt"])),
             "err": torch.zeros(())}
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_async(d, 9, ttree).join()
        assert jckpt.latest_step(d) == 9
        target = jax.tree_util.tree_map(jnp.zeros_like, jtree)
        restored, _ = jckpt.restore(d, 9, target)
        _equal(jax.tree_util.tree_map(np.asarray, restored), ttree)
