"""GPipe (``repro_torch.distributed.pipeline``) on 4 gloo ranks (a
subprocess, ``FileStore`` under ``tmp_path``) against the reference test's
sequential chain ``tanh(h @ W[i])`` computed in JAX on the same inputs
(tests/test_distribution.py::test_gpipe_multidevice's case and bars: output
1e-5, gradients 1e-4), and reduced-qwen blocks as stages against the same
blocks run in order (f32 bar). ``split_layers_to_stages`` is held against
the reference's.
"""
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.distributed.pipeline import \
    split_layers_to_stages as jsplit_layers_to_stages
from repro_torch.distributed.pipeline import split_layers_to_stages

REPO = Path(__file__).resolve().parents[1]
TOL = dict(atol=2e-5, rtol=2e-4)

SCRIPT = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import tree as tree_lib
    from repro_torch.configs.base import RunConfig, reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import world
    from repro_torch.distributed.pipeline import (gpipe_apply,
                                                  split_layers_to_stages)
    from repro_torch.models import lm

    def body(rank, n, inp, out):
        torch.set_num_threads(1)     # 4 ranks share the cores with pytest's
        d = np.load(inp)
        mesh = init_device_mesh("cpu", (n,), mesh_dim_names=("pod",))
        group = mesh.get_group("pod")
        W = torch.from_numpy(d["W"]).requires_grad_()
        x = torch.from_numpy(d["x"])
        fn = lambda w, h: torch.tanh(h @ w)
        y = gpipe_apply(fn, W, x, 4, mesh)
        y.sum().backward()
        # each rank holds the gradient of its own stage: sum the four
        g = coll.all_reduce(W.grad, group)
        res = {"y": y.detach().numpy(), "g": g.numpy()}
        # reduced-qwen blocks, one per stage, against the blocks in order
        cfg = reduced(get_config("qwen1.5-4b"), n_layers=n)
        run = RunConfig(compute_dtype="float32", remat="none")
        blocks = lm.init(torch.Generator().manual_seed(0), cfg)["blocks"]
        h = torch.from_numpy(d["h"])
        stage = lambda p, h: lm.apply_block(lm._layer(p, 0), cfg, run, h,
                                            window=0)[0]
        staged = split_layers_to_stages(blocks, n)
        with torch.no_grad():
            res["blocks"] = gpipe_apply(stage, staged, h, 2, mesh).numpy()
            seq = h
            for i in range(n):
                seq = lm.apply_block(lm._layer(blocks, i), cfg, run, seq,
                                     window=0)[0]
        res["blocks_seq"] = seq.numpy()
        if rank == 0:
            np.savez(out, **res)

    if __name__ == "__main__":
        inp, out, store = sys.argv[1:]
        world.spawn(body, 4, store, args=(inp, out))
''')


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gpipe")
    W = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 16, 16))
                   * 0.3, np.float32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, 16)),
                   np.float32)
    h = np.random.RandomState(2).randn(4, 8, 128).astype(np.float32)
    np.savez(tmp / "in.npz", W=W, x=x, h=h)
    (tmp / "run.py").write_text(SCRIPT)
    r = subprocess.run([sys.executable, str(tmp / "run.py"),
                        str(tmp / "in.npz"), str(tmp / "out.npz"),
                        str(tmp / "store")], capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": str(REPO / "src")},
                       timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return W, x, dict(np.load(tmp / "out.npz"))


def _chain(W, x):
    return functools.reduce(lambda h, i: jnp.tanh(h @ W[i]), range(4), x)


def test_gpipe_output_matches_the_sequential_chain(run):
    W, x, out = run
    ref = _chain(jnp.asarray(W), jnp.asarray(x))
    assert float(np.abs(out["y"] - np.asarray(ref)).max()) < 1e-5


def test_gpipe_gradients_match_the_sequential_chain(run):
    W, x, out = run
    gr = jax.grad(lambda W: _chain(W, jnp.asarray(x)).sum())(jnp.asarray(W))
    assert float(np.abs(out["g"] - np.asarray(gr)).max()) < 1e-4


def test_gpipe_of_model_blocks_matches_the_blocks_in_order(run):
    _, _, out = run
    np.testing.assert_allclose(out["blocks"], out["blocks_seq"], **TOL)


def test_split_layers_to_stages_matches_reference():
    a = np.arange(6 * 2 * 3, dtype=np.float32).reshape(6, 2, 3)
    tree = {"w": a, "b": [a[:, 0]]}
    ref = jsplit_layers_to_stages(jax.tree_util.tree_map(jnp.asarray, tree),
                                  3)
    got = split_layers_to_stages({"w": torch.from_numpy(a),
                                  "b": [torch.from_numpy(a[:, 0].copy())]}, 3)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(ref["w"]))
    np.testing.assert_array_equal(got["b"][0].numpy(),
                                  np.asarray(ref["b"][0]))
    with pytest.raises(ValueError, match="not divisible"):
        split_layers_to_stages({"w": torch.zeros(5, 2)}, 3)
