"""The few pytree operations the training path needs, in JAX's order.

A tree is nested dicts, lists, tuples and NamedTuples with tensors (or
numpy arrays, or numbers) at the leaves. Leaves come in the order
``jax.tree_util`` flattens the same tree: a dict's keys sorted, sequences
and NamedTuple fields in order. A leaf's path is its keys joined by "/",
with a NamedTuple field written ".name" and a sequence index as a number,
as ``repro/checkpoint/checkpointer.py::_flatten`` writes them, so the two
packages name every leaf alike.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

PyTree = Any
SEP = "/"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [("." + f, getattr(tree, f)) for f in tree._fields]
    return [(str(i), v) for i, v in enumerate(tree)]


def _is_leaf(tree) -> bool:
    return not isinstance(tree, (dict, list, tuple))


def flatten_with_path(tree: PyTree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf), ...] in JAX's leaf order."""
    if _is_leaf(tree):
        return [(prefix, tree)]
    out = []
    for key, sub in _children(tree):
        out += flatten_with_path(sub, f"{prefix}{SEP}{key}" if prefix else key)
    return out


def leaves(tree: PyTree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(tree: PyTree, new_leaves) -> PyTree:
    """``tree``'s structure with its leaves replaced, in order, by
    ``new_leaves``."""
    it = iter(new_leaves)

    def build(t):
        if _is_leaf(t):
            return next(it)
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        return type(t)(build(v) for v in t)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over matching leaves of trees of one structure."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(leaves(tree))])
