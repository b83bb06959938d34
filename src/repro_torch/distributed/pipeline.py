"""GPipe-style pipeline parallelism over a mesh axis (default: ``pod``).

Port of ``repro/distributed/pipeline.py``. The pod axis has the slowest
links of the production mesh and pipeline parallelism the least traffic
per step (one activation hand-off per microbatch per stage boundary), so
stages map onto pods. Fill-drain schedule: T = n_micro + n_stages - 1
ticks; the stage hand-off is one ``ppermute`` (point-to-point, no
collective fan-in).

``gpipe_apply`` runs on each rank's own stage (local tensors, the
reference's ``shard_map`` body). Its backward comes from autograd: the
hand-off is ``collectives.ppermute``, whose backward is the reverse permute
(the reference gets it from JAX transposing the ``ppermute``s).
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch import tree as tree_lib
from repro_torch.distributed import collectives as coll

PyTree = Any


def _own_stage(a: torch.Tensor, sidx: int) -> torch.Tensor:
    """This rank's stage of a stage-stacked leaf: a DTensor sharded over
    the stage axis holds it as its local shard (leading dim 1); a plain
    tensor holds every stage."""
    if isinstance(a, DTensor):
        return a.to_local()[0]
    return a[sidx]


def gpipe_apply(stage_fn: Callable[[PyTree, torch.Tensor], torch.Tensor],
                stage_params: PyTree, x: torch.Tensor, n_micro: int,
                mesh, axis: str = "pod") -> torch.Tensor:
    """Run ``n_stages`` chained stages over microbatches of x.

    stage_params: leading axis = stage (a DTensor sharded over ``axis``, or
    a plain tensor holding every stage); x: (batch, ...) with batch %
    n_micro == 0, the same on every rank of ``axis``. Returns
    stage_{S-1}(...stage_0(x)) with the same shape as x, on every rank.
    """
    group = mesh.get_group(axis)
    n_stages = mesh.size(list(mesh.mesh_dim_names).index(axis))
    sidx = mesh.get_local_rank(axis)
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
    xm = x.reshape((n_micro, B // n_micro) + tuple(x.shape[1:]))
    params = tree_lib.tree_map(lambda a: _own_stage(a, sidx), stage_params)
    zero = torch.zeros_like(xm[0])
    # the stage's role is a tensor condition, as in the reference, so every
    # rank builds the same autograd graph and runs the reverse permutes of
    # the backward in the same order (a send waits for its receive)
    first = torch.tensor(sidx == 0, device=x.device)
    last = torch.tensor(sidx == n_stages - 1, device=x.device)
    recv, outs = zero, [zero] * n_micro
    for t in range(n_micro + n_stages - 1):
        inp = torch.where(first, xm[t] if t < n_micro else zero, recv)
        h = stage_fn(params, inp)
        recv = coll.ppermute(h, group, 1)
        # the last stage emits microbatch t - (n_stages - 1)
        oidx = t - (n_stages - 1)
        if oidx >= 0:
            outs[oidx] = torch.where(last, h, outs[oidx])
    # only the last stage holds real outputs; broadcast by a sum
    out = coll.psum(torch.stack(outs), group)
    return out.reshape(x.shape)


def split_layers_to_stages(stacked_params: PyTree, n_stages: int) -> PyTree:
    """(L, ...) stacked layer params -> (n_stages, L/n_stages, ...)."""
    def re(a):
        L = a.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers not divisible by {n_stages}")
        return a.reshape((n_stages, L // n_stages) + tuple(a.shape[1:]))
    return tree_lib.tree_map(re, stacked_params)
