"""Sharding rules: logical param/activation axes -> mesh axes -> DTensor
placements.

Port of ``repro/distributed/sharding.py``. The production mesh is
single-pod ``(data=16, model=16)`` or multi-pod ``(pod=2, data=16,
model=16)``. Per-arch rules resolve which logical axes can legally map onto
``model`` (divisibility) and replicate the rest: gemma2 has 8 q-heads < 16-way
TP, so its attention params replicate over ``model`` while MLP/vocab stay
sharded.

A rule first gives a *spec*: one entry per tensor dim, each ``None``, a mesh
axis name or a tuple of them (JAX's ``PartitionSpec`` as a tuple). ``placements``
turns a spec into DTensor placements, one per mesh dim: ``Shard(i)`` where
tensor dim ``i`` names that mesh axis, ``Replicate()`` elsewhere. Where two
mesh axes shard one dim, the specs list them in mesh order, which is the
order DTensor shards in. Every public rule returns placements per leaf; a
leaf of a placements tree is a tuple of ``Placement``.

A mesh is anything with ``mesh_dim_names`` and ``shape`` (a ``DeviceMesh``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig, ShapeConfig

PyTree = Any
Spec = Tuple[Any, ...]
Placements = Tuple[Placement, ...]


def mesh_axis_size(mesh, name: str) -> int:
    """The size of mesh axis ``name``; 1 where the mesh has no such axis
    (or no named axes at all)."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    return dict(zip(names, tuple(getattr(mesh, "shape", ())))).get(name, 1)


def placements(spec: Spec, mesh) -> Placements:
    """A spec (``PartitionSpec``-like tuple) -> placements on ``mesh``."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def replicated(mesh) -> Placements:
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def drop_leading(pl: Placements) -> Placements:
    """Placements of ``t[i]`` for ``t`` placed by ``pl`` (its leading dim,
    the layer axis, is never sharded)."""
    if any(isinstance(p, Shard) and p.dim == 0 for p in pl):
        raise ValueError(f"leading dim is sharded: {pl}")
    return tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p for p in pl)


def batch_axes(mesh, global_batch: int) -> Tuple[str, ...]:
    """Mesh axes the batch dim is sharded over (pod+data when divisible)."""
    names = mesh.mesh_dim_names
    axes = [a for a in ("pod", "data") if a in names]
    total = math.prod(mesh_axis_size(mesh, a) for a in axes)
    if axes and global_batch % total == 0:
        return tuple(axes)
    if "data" in names and global_batch % mesh_axis_size(mesh, "data") == 0:
        return ("data",)
    return ()


def axis_rules(cfg: ModelConfig, mesh) -> Dict[Optional[str], Any]:
    tp = mesh_axis_size(mesh, "model")
    div = lambda n: n and n % tp == 0
    d_inner = cfg.ssm_expand * cfg.d_model
    return {
        None: None,
        "layers": None,
        "embed": None,
        "head_dim": None,
        "vocab": "model" if div(cfg.vocab_size) else None,
        "mlp": "model" if div(cfg.d_ff or cfg.moe_d_ff) else None,
        "experts": "model" if div(cfg.n_experts) else None,
        "heads": "model" if div(cfg.n_heads) else None,
        "kv_heads": "model" if div(cfg.n_kv_heads) else None,
        # ssm inner dim: sharded for the hybrid (hymba) family; the tiny
        # xlstm-125m replicates its cell
        "inner": "model" if (cfg.family == "hybrid" and div(d_inner)) else None,
    }


# ---------------------------------------------------------------------------
# trees whose leaves are tuples (axes, specs, placements)
# ---------------------------------------------------------------------------

def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        isinstance(e, (str, type(None))) for e in x)


def _is_placements(x) -> bool:
    return isinstance(x, tuple) and bool(x) and all(
        isinstance(e, Placement) for e in x)


def map_tuples(fn: Callable, tree: PyTree, is_leaf: Callable) -> PyTree:
    """``fn`` over the leaves of a tree of dicts, lists and NamedTuples
    whose leaves are tuples (``is_leaf`` tells them from the nodes)."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tuples(fn, v, is_leaf) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(map_tuples(fn, v, is_leaf) for v in tree))
    return type(tree)(map_tuples(fn, v, is_leaf) for v in tree)


def placement_leaves(tree: PyTree) -> list:
    """The placements of a placements tree in ``tree.leaves`` order."""
    if _is_placements(tree):
        return [tree]
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in placement_leaves(tree[k])]
    return [p for v in tree for p in placement_leaves(v)]


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def param_spec(axes: Tuple[Optional[str], ...], rules) -> Spec:
    # a mesh axis may appear once per spec: first logical axis wins (MoE
    # expert weights (experts, embed, mlp): `experts` takes `model`; the
    # per-expert mlp dim stays local)
    spec, used = [], set()
    for a in axes:
        m = rules.get(a)
        if m is not None and m in used:
            m = None
        if m is not None:
            used.add(m)
        spec.append(m)
    return tuple(spec)


def param_shardings(axes_tree: PyTree, cfg: ModelConfig, mesh) -> PyTree:
    rules = axis_rules(cfg, mesh)
    return map_tuples(lambda ax: placements(param_spec(ax, rules), mesh),
                      axes_tree, _is_axes)


def zero1_shardings(params_pl: PyTree, shapes: PyTree, mesh) -> PyTree:
    """ZeRO-1: additionally shard optimizer moments over ``data`` along the
    largest dim that is unsharded and divisible. ``shapes``: the params (or
    anything with ``.shape``) in the same tree."""
    data = mesh_axis_size(mesh, "data")
    di = list(mesh.mesh_dim_names).index("data")

    def opt_pl(pl: Placements, shape) -> Placements:
        used = {p.dim for p in pl if isinstance(p, Shard)}
        best, best_size = -1, 0
        for i, n in enumerate(shape):
            if i not in used and n % data == 0 and n > best_size:
                best, best_size = i, n
        out = list(pl)
        if best >= 0 and best_size >= data:
            out[di] = Shard(best)
        return tuple(out)

    def walk(pl, shapes):
        if _is_placements(pl):
            return opt_pl(pl, tuple(shapes.shape))
        if isinstance(pl, dict):
            return {k: walk(v, shapes[k]) for k, v in pl.items()}
        return type(pl)(walk(p, s) for p, s in zip(pl, shapes))

    return walk(params_pl, shapes)


def batch_shardings(cfg: ModelConfig, mesh, shape: ShapeConfig) -> PyTree:
    """Placements of the train-batch dict (tokens/labels/stub embeddings)."""
    b = batch_axes(mesh, shape.global_batch) or None
    tok = placements((b, None), mesh)
    out = {"tokens": tok, "labels": tok}
    if cfg.family == "vlm":
        out["image_embeds"] = placements((b, None, None), mesh)
    if cfg.family == "audio":
        out["audio_embeds"] = placements((b, None, None), mesh)
    return out


def cache_shardings(cfg: ModelConfig, mesh, shape: ShapeConfig) -> PyTree:
    """Placements of the decode cache.

    * kv heads sharded over ``model`` when divisible;
    * otherwise the *sequence* dim of the cache is sharded over ``model``
      (flash-decoding style: decode softmax/contract collectives are tiny);
    * batch over (pod, data) when divisible; batch==1 additionally pushes the
      sequence dim onto ``data``.
    """
    rules = axis_rules(cfg, mesh)
    bspec = batch_axes(mesh, shape.global_batch)
    b = bspec or None
    kv = rules["kv_heads"]
    seq_axes = []
    if kv is None:
        seq_axes.append("model")
    if not bspec and "data" in mesh.mesh_dim_names and \
            shape.seq_len % (mesh_axis_size(mesh, "data") *
                             mesh_axis_size(mesh, "model")) == 0:
        seq_axes.insert(0, "data")
    seq = tuple(seq_axes) or None
    kv_pl = placements((None, b, seq, kv, None), mesh)

    if cfg.family == "ssm":
        # xlstm: a list of per-layer state tuples, replicated (tiny model)
        from repro_torch.models import xlstm as xlstm_lib
        cache = xlstm_lib.init_cache(cfg, shape.global_batch, shape.seq_len,
                                     device="meta")
        return [tuple(replicated(mesh) for _ in layer) for layer in cache]
    if cfg.family == "hybrid":
        inner = rules["inner"]
        return {"k": kv_pl, "v": kv_pl,
                "ssm": placements((None, b, inner, None), mesh),
                "conv": placements((None, b, None, inner), mesh)}
    if cfg.family == "audio":
        cross = placements((None, b, None, kv, None), mesh)
        return {"k": kv_pl, "v": kv_pl, "ck": cross, "cv": cross}
    return {"k": kv_pl, "v": kv_pl}


# ---------------------------------------------------------------------------
# laying tensors out
# ---------------------------------------------------------------------------

def place(tree: PyTree, pl_tree: PyTree, mesh) -> PyTree:
    """Each leaf of ``tree`` laid out by its placements: a DTensor is
    redistributed (kept as it is when already so), a plain tensor, the same
    full tensor on every rank, is cut to its local shard (no collective;
    differentiable, as a redistribute is).
    A leaf of ``pl_tree`` may stand for a whole subtree of ``tree`` (e.g.
    one placements for every moment)."""
    leaves = tree_lib.leaves(tree)
    pls = placement_leaves(pl_tree)
    if len(pls) != len(leaves):
        raise ValueError(f"place: {len(leaves)} leaves, {len(pls)} "
                         f"placements")
    return tree_lib.unflatten(tree, [place_one(t, p, mesh)
                                     for t, p in zip(leaves, pls)])


def place_one(t: torch.Tensor, pl: Sequence[Placement], mesh) -> DTensor:
    pl = tuple(pl)
    if not isinstance(t, DTensor):
        # differentiable: a gradient comes back to the plain tensor
        t = DTensor.from_local(t, mesh, replicated(mesh))
    return t if tuple(t.placements) == pl else t.redistribute(mesh, pl)


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def to_local(t: DTensor, grad_placements=None) -> torch.Tensor:
    """``t.to_local()`` whose gradient reaches the DTensor contiguous (the
    backward wraps the local gradient as it is, and DTensor lays its ops out
    by the global, contiguous strides)."""
    return _ContiguousGrad.apply(t.to_local(grad_placements=grad_placements))


def local(t: torch.Tensor, pl: Sequence[Placement], mesh,
          grad_placements=None) -> torch.Tensor:
    """This rank's shard of ``t`` laid out by ``pl`` (``place_one``, then
    ``to_local``)."""
    return to_local(place_one(t, pl, mesh), grad_placements)


def from_local(t: torch.Tensor, mesh, pl: Sequence[Placement],
               shape=None) -> DTensor:
    """A DTensor from this rank's shard ``t`` (made contiguous: DTensor
    lays its ops out by the global, contiguous strides). ``shape``: the
    global shape, where the shards may be uneven."""
    stride = None if shape is None else torch.empty(
        shape, device="meta").stride()
    return DTensor.from_local(t.contiguous(), mesh, pl, shape=shape,
                              stride=stride)


def batch_only(t: torch.Tensor) -> torch.Tensor:
    """A DTensor activation laid out with its batch dim as it is and every
    other dim replicated (a partial sum is reduced): the residual stream's
    layout, which GSPMD reaches from the param rules (Megatron's: the
    row-parallel products' all-reduce). A plain tensor is returned as it
    is."""
    if not isinstance(t, DTensor):
        return t
    pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
               for p in t.placements)
    return place_one(t, pl, t.device_mesh)


def zeros(tree: PyTree, pl_tree: PyTree, mesh, device) -> PyTree:
    """DTensors of zeros in the shapes and dtypes of ``tree``'s leaves (meta
    tensors will do), laid out by ``pl_tree``: each rank allocates only its
    own shard."""
    def one(t, pl):
        local, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
        z = torch.zeros(local, dtype=t.dtype, device=device)
        return DTensor.from_local(z, mesh, pl, shape=t.shape,
                                  stride=t.stride())
    return tree_lib.unflatten(tree, [one(t, pl) for t, pl in zip(
        tree_lib.leaves(tree), placement_leaves(pl_tree))])


def full(tree: PyTree) -> PyTree:
    """Every DTensor leaf gathered to a plain full tensor."""
    return tree_lib.tree_map(
        lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)
