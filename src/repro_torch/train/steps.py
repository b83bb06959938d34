"""Train / prefill / decode steps.

Port of ``repro/train/steps.py``. ``build_train_step`` returns the full
production step: loss, gradient, optional microbatch gradient accumulation,
optional top-k gradient compression with error feedback, clipping, the
cosine schedule and the AdamW update, in the reference's order. The
gradient is ``torch.autograd.grad`` over the parameter leaves.

``run.zero1`` is accepted and, on one device, places nothing differently,
as on the reference's one-device mesh; sharded optimizer state comes with
the port's distribution layer. The ``build_*`` functions take no mesh and
return the step function alone (the reference also returns its
shardings).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.models.registry import get_model
from repro_torch.optim import adamw

PyTree = Any


def _topk_compress(g: torch.Tensor, err: torch.Tensor, ratio: float):
    """Top-k sparsification with error feedback. Returns (g_hat, new_err)."""
    if g.dim() < 2:
        return g, err
    acc = g.float() + err
    flat = acc.reshape(-1)
    k = max(1, int(flat.numel() * ratio))
    thresh = torch.topk(flat.abs(), k).values[-1]
    sent = torch.where(flat.abs() >= thresh, flat, 0.0)
    return sent.reshape(g.shape).to(g.dtype), (flat - sent).reshape(g.shape)


def value_and_grad(loss_fn: Callable, params: PyTree, batch
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(loss, grads) of ``loss_fn(params, batch)``; the grads are a list in
    ``tree.leaves(params)`` order (a leaf the loss does not use gets
    zeros). ``params`` itself is left without gradients."""
    leaves = [p.detach().requires_grad_() for p in tree_lib.leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_lib.unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), list(grads)


def build_train_step(cfg: ModelConfig, run: RunConfig, shape: ShapeConfig):
    """Returns train_step(params, opt_state, err_state, batch, step,
    before_update=None) -> (params, opt_state, err_state, metrics), metrics
    = {loss, grad_norm, lr} as 0-d tensors on the params' device. ``step``
    is an int or an int tensor; params and the optimizer state are updated
    in place (the reference donates them), and ``before_update()``, if
    given, is called just before the first of them is written."""
    bundle = get_model(cfg)
    use_compress = run.grad_compression == "topk"
    n_micro = (shape.global_batch // run.microbatch
               if run.microbatch and run.microbatch < shape.global_batch
               else 0)

    def loss_fn(params, batch):
        return bundle.train_loss(params, run, batch)

    def train_step(params, opt_state, err_state, batch, step,
                   before_update=None):
        if n_micro:
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for p in tree_lib.leaves(params)]
            lsum = 0.0
            for i in range(n_micro):
                rows = slice(i * run.microbatch, (i + 1) * run.microbatch)
                l, g = value_and_grad(loss_fn, params,
                                      {k: v[rows] for k, v in batch.items()})
                for acc, gi in zip(gsum, g):
                    acc.add_(gi)
                lsum = lsum + l
            loss = lsum / n_micro
            grads = [g / n_micro for g in gsum]
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)

        if use_compress:
            comp = [_topk_compress(g, e, run.topk_ratio)
                    for g, e in zip(grads, tree_lib.leaves(err_state))]
            grads = [c[0] for c in comp]
            err_state = tree_lib.unflatten(err_state, [c[1] for c in comp])

        grads, gnorm = adamw.clip_by_global_norm(grads, run.grad_clip)
        lr = adamw.cosine_schedule(step, base_lr=run.lr,
                                   warmup=run.warmup_steps,
                                   total=run.total_steps, device=loss.device)
        if before_update is not None:
            before_update()
        params, opt_state = adamw.update(grads, opt_state, params, lr=lr,
                                         weight_decay=run.weight_decay)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return params, opt_state, err_state, metrics

    return train_step


def build_prefill_step(cfg: ModelConfig, run: RunConfig, shape: ShapeConfig):
    """prefill_step(params, tokens[, extra]) -> (logits, cache, lengths);
    the cache (none for the ssm family) is made on the tokens' device."""
    bundle = get_model(cfg)

    def prefill_step(params, tokens, extra=None):
        cache = None if cfg.family == "ssm" else bundle.init_cache(
            shape.global_batch, shape.seq_len, device=tokens.device)
        return bundle.prefill(params, run, cache, tokens, extra=extra)

    return prefill_step


def build_decode_step(cfg: ModelConfig, run: RunConfig, shape: ShapeConfig):
    """serve_step(params, cache, token, pos) -> (logits, cache)."""
    bundle = get_model(cfg)

    def serve_step(params, cache, token, pos):
        return bundle.decode_step(params, run, cache, token, pos)

    return serve_step
