"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's (``repro.distributed.sharding``), on fake production meshes
(no device, no process group).

The reference's rules return ``NamedSharding``s, which need a real mesh;
here they run with a stand-in ``NamedSharding`` that keeps the spec, and
the port's placements are held against ``placements(spec)`` leaf by leaf,
mesh axis for mesh axis: for every architecture's params, ZeRO-1 moments,
train batches and decode caches at every shape cell, on the single-pod
(16, 16) and multi-pod (2, 16, 16) meshes.
"""
import numpy as np
import pytest

pytest.importorskip("torch")
import jax
from torch.distributed.tensor import Replicate, Shard

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import shape_cells
from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as jget_config
from repro.distributed import sharding as jsh
from repro.models.registry import get_model as jget_model
from repro.models.registry import input_specs as jinput_specs
from repro.train import steps as jsteps
from repro_torch import tree as tree_lib
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as shlib
from repro_torch.models.registry import get_model, input_specs


class JaxMesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, names, sizes):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))
        self.devices = np.empty(sizes, object)


class TorchMesh:
    """What the port's rules read of a mesh (a DeviceMesh's two fields)."""

    def __init__(self, names, sizes):
        self.mesh_dim_names, self.shape = names, tuple(sizes)


class SpecSharding:
    """Stands in for ``NamedSharding``: the spec it was given."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec


MESHES = {"single_pod": (("data", "model"), (16, 16)),
          "multi_pod": (("pod", "data", "model"), (2, 16, 16))}


@pytest.fixture(autouse=True)
def _spec_only(monkeypatch):
    monkeypatch.setattr(jsh, "NamedSharding", SpecSharding)
    monkeypatch.setattr(jsteps, "NamedSharding", SpecSharding)


def _meshes(name):
    names, sizes = MESHES[name]
    return JaxMesh(names, sizes), TorchMesh(names, sizes)


def _specs(tree):
    return [tuple(s.spec) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, SpecSharding))]


def _assert_same(ref_tree, port_tree, tmesh, what):
    ref = _specs(ref_tree)
    port = shlib.placement_leaves(port_tree)
    assert len(ref) == len(port), what
    for i, (spec, pl) in enumerate(zip(ref, port)):
        assert pl == shlib.placements(spec, tmesh), (what, i, spec, pl)


def test_placements_of_a_spec():
    m = TorchMesh(("pod", "data", "model"), (2, 16, 16))
    assert shlib.placements((("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert shlib.placements((None, None), m) == (Replicate(),) * 3
    assert shlib.placements(("data", ("model",)), m) == (
        Replicate(), Shard(0), Shard(1))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_match_reference(arch, mesh):
    jm, tm = _meshes(mesh)
    jcfg, cfg = jget_config(arch), get_config(arch)
    assert shlib.axis_rules(cfg, tm) == jsh.axis_rules(jcfg, jm)
    ref = jsh.param_shardings(jget_model(jcfg).axes(), jcfg, jm)
    _assert_same(ref, shlib.param_shardings(get_model(cfg).axes(), cfg, tm),
                 tm, f"{arch} params")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_zero1_shardings_match_reference(arch):
    jm, tm = _meshes("single_pod")
    jcfg, cfg = jget_config(arch), get_config(arch)
    jb = jget_model(jcfg)
    ref = jsteps._zero1_shardings(
        jsh.param_shardings(jb.axes(), jcfg, jm), jb.abstract_params(), jm)
    b = get_model(cfg)
    port = shlib.zero1_shardings(shlib.param_shardings(b.axes(), cfg, tm),
                                 b.abstract_params(), tm)
    _assert_same(ref, port, tm, f"{arch} zero1")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_shardings_match_reference(arch, mesh):
    jm, tm = _meshes(mesh)
    jcfg, cfg = jget_config(arch), get_config(arch)
    for cell in shape_cells(arch):
        jshape, shape = JSHAPES[cell], SHAPES[cell]
        assert shlib.batch_axes(tm, shape.global_batch) == \
            jsh.batch_axes(jm, jshape.global_batch)
        ref_b = jsh.batch_shardings(jcfg, jm, jshape)
        port_b = shlib.batch_shardings(cfg, tm, shape)
        assert sorted(ref_b) == sorted(port_b)
        _assert_same(ref_b, port_b, tm, f"{arch} {cell} batch")
        _assert_same(jsh.cache_shardings(jcfg, jm, jshape),
                     shlib.cache_shardings(cfg, tm, shape), tm,
                     f"{arch} {cell} cache")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sharding_rules_legal(arch):
    """tests/test_distribution.py::test_sharding_rules_legal on the port:
    every param dim a mesh axis shards divides by 16, and the axes tree
    matches the abstract params leaf for leaf."""
    _, tm = _meshes("single_pod")
    cfg = get_config(arch)
    b = get_model(cfg)
    pls = shlib.placement_leaves(shlib.param_shardings(b.axes(), cfg, tm))
    abstract = tree_lib.leaves(b.abstract_params())
    assert len(pls) == len(abstract)
    for pl, t in zip(pls, abstract):
        assert t.device.type == "meta"
        for size, p in zip(tm.shape, pl):
            if isinstance(p, Shard):
                assert t.shape[p.dim] % size == 0, (arch, t.shape, pl)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_and_axes_match_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jb, b = jget_model(jcfg), get_model(cfg)
    ref = jax.tree_util.tree_flatten_with_path(jb.abstract_params())[0]
    port = tree_lib.flatten_with_path(b.abstract_params())
    assert [tuple(a.shape) for _, a in ref] == \
        [tuple(t.shape) for _, t in port]
    ref_axes = jax.tree_util.tree_leaves(
        jb.axes(), is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(e, (str, type(None))) for e in x))

    def axes_leaves(t):
        if shlib._is_axes(t):
            return [t]
        if isinstance(t, dict):
            return [a for k in sorted(t) for a in axes_leaves(t[k])]
        return [a for v in t for a in axes_leaves(v)]

    assert axes_leaves(b.axes()) == ref_axes


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    """Meta stand-ins with the reference's keys, shapes and dtypes, at
    every shape cell (the decode cache's too)."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    for cell in shape_cells(arch):
        ref = jax.tree_util.tree_flatten_with_path(
            jinput_specs(jcfg, JSHAPES[cell]))[0]
        port = tree_lib.flatten_with_path(input_specs(cfg, SHAPES[cell]))
        assert ["/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                         for q in k) for k, _ in ref] == [k for k, _ in port]
        assert [(tuple(a.shape), str(a.dtype)) for _, a in ref] == \
            [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
             for _, t in port], (arch, cell)
        assert all(t.device.type == "meta" for _, t in port)
        assert len(ref) == len(port)
