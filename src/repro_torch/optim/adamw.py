"""AdamW + gradient clipping + schedules over trees of tensors.

Port of ``repro/optim/adamw.py``: the same float32 arithmetic in the same
order (bias corrections from a float32 step, decoupled weight decay on
leaves with ``ndim >= 2`` only). The state lives on the params' device.
``update`` works in place, leaf by leaf, as the reference's jitted step
does under donation: the params and moments it is given are the ones it
returns, and its float32 temporaries are one leaf's size. A moment that is
not float32 (a bf16 leaf's, from ``init``) becomes the reference's float32
result at its first update: one new tensor per such leaf, once.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple, Union

import torch

from repro_torch import tree as tree_lib

PyTree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: PyTree           # first moment
    nu: PyTree           # second moment


def init(params: PyTree) -> AdamWState:
    p0 = tree_lib.leaves(params)[0]
    zeros = lambda p: torch.zeros_like(p)
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=p0.device),
                      mu=tree_lib.tree_map(zeros, params),
                      nu=tree_lib.tree_map(zeros, params))


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tree_lib.leaves(tree)))


def clip_by_global_norm(grads: PyTree, max_norm: float
                        ) -> Tuple[PyTree, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_lib.tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def _weak(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as JAX's weak type makes it: in ``like``'s dtype."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


@torch.no_grad()
def update(grads: PyTree, state: AdamWState, params: PyTree, *,
           lr: torch.Tensor, b1: float = 0.9, b2: float = 0.95,
           eps: float = 1e-8, weight_decay: float = 0.1
           ) -> Tuple[PyTree, AdamWState]:
    """One AdamW step; ``params``, ``state.mu`` and ``state.nu`` are
    updated in place and returned (``grads`` is only read). Moments come
    back float32, as the reference's (``m.astype(v.dtype)``, ``v``
    float32): a moment of another dtype is replaced. Its ``b1 * m`` is the
    reference's: a weak-typed scalar takes the moment's dtype, so ``b1``
    and the product are rounded to it."""
    step = state.step + 1
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()
    mu, nu = tree_lib.leaves(state.mu), tree_lib.leaves(state.nu)
    replaced = False
    for i, (g, m, v, p) in enumerate(zip(tree_lib.leaves(grads), mu, nu,
                                         tree_lib.leaves(params))):
        g = g.float()
        if m.dtype == torch.float32:
            m.mul_(b1).add_((1 - b1) * g)
        else:
            m = mu[i] = (m * _weak(b1, m)).float().add_((1 - b1) * g)
            replaced = True
        if v.dtype == torch.float32:
            v.mul_(b2).add_((1 - b2) * g.square())
        else:
            v = nu[i] = (v * _weak(b2, v)).float().add_(
                (1 - b2) * g.square())
            replaced = True
        delta = m / c1
        delta.div_((v / c2).sqrt_().add_(eps))
        if p.dim() >= 2:     # decoupled weight decay on matrices only
            delta.add_(weight_decay * p.float())
        delta.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p.float() - delta)
    if replaced:
        return params, AdamWState(step, tree_lib.unflatten(state.mu, mu),
                                  tree_lib.unflatten(state.nu, nu))
    return params, AdamWState(step, state.mu, state.nu)


def cosine_schedule(step: Union[int, torch.Tensor], *, base_lr: float,
                    warmup: int, total: int, min_ratio: float = 0.1,
                    device=None) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), a float32 0-d
    tensor on ``device`` (for an int) or the step's device."""
    step = torch.as_tensor(step, device=device).float()
    warm = base_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                     (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)
