"""The collectives of the reference's ``shard_map`` regions, on one axis
of a mesh, with gradients.

Inside a region the code runs on local shards (``DTensor.to_local``), as
JAX's ``shard_map`` bodies do, and these stand in for ``psum``, ``pmean``
and ``ppermute``:

* ``psum`` / ``pmean``: an all-reduce whose result every rank of the axis
  then uses alike (the region returns it as replicated), so its backward
  passes the cotangent through (``pmean`` scales it);
* ``ppermute``: each rank sends to ``(rank + shift) % n`` (an all-to-all
  whose one nonzero split is that peer, ``funcol.permute_tensor``); its
  backward is the reverse permute (autograd does not differentiate through
  a collective, so this ``autograd.Function`` does).

Both are functional collectives (``_c10d_functional``, which also run on
meta tensors): the dry-run's cost counter reads their bytes.
A gloo group moves CUDA tensors through the host: NCCL refuses two ranks on
one card, so ranks that share it run over gloo, their compute on the card.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A sum (or max) over ``group``, no gradient."""
    if _via_host(t, group):
        return all_reduce(t.cpu(), group, op).to(t.device)
    return funcol.wait_tensor(funcol.all_reduce(t.contiguous(), op, group))


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group; the result is used alike on every rank."""
    return _PSum.apply(t, group)


def pmean(t: torch.Tensor, group) -> torch.Tensor:
    return psum(t, group) / dist.get_world_size(group)


def _permute(t: torch.Tensor, group, shift: int) -> torch.Tensor:
    if _via_host(t, group):
        return _permute(t.cpu(), group, shift).to(t.device)
    n = dist.get_world_size(group)
    if n == 1:
        return t.clone()
    flat = t.contiguous().reshape(-1)
    out = funcol.permute_tensor(flat, [(i + shift) % n for i in range(n)],
                                group)
    return funcol.wait_tensor(out).reshape(t.shape)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, shift):
        ctx.group, ctx.shift = group, shift
        return _permute(t, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.group, -ctx.shift), None, None


def ppermute(t: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Rank ``i`` of the group sends ``t`` to rank ``(i + shift) % n`` and
    returns what rank ``(i - shift) % n`` sent."""
    return _PPermute.apply(t, group, shift)
