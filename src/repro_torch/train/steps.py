"""Train / prefill / decode steps, on one device or over a mesh.

Port of ``repro/train/steps.py``. ``build_train_step`` returns the full
production step: loss, gradient, optional microbatch gradient accumulation,
optional top-k gradient compression with error feedback, clipping, the
cosine schedule and the AdamW update, in the reference's order. The
gradient is ``torch.autograd.grad`` over the parameter leaves.

Every ``build_*`` takes ``mesh`` last (None: the one-device step). With a
mesh the step lays its inputs out as the reference's ``in_shardings`` do
(``in_placements``; ``distributed/sharding.py``): params, the optimizer
state (``run.zero1`` further shards each moment over ``data``), the batch
and the cache become DTensors, and the model runs on them under
``implicit_replication`` (a plain tensor the code makes, such as a
position range, counts as replicated). The gradient's reduction over the
batch axes is the one DTensor's backward inserts; the optimizer's update
reshards it to the moments' and params' layouts. Params and moments placed
by an earlier call are reused as they are, so the in-place update carries
from step to step. The step's metrics come back as plain tensors.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.distributed import sharding as shlib
from repro_torch.models.registry import get_model
from repro_torch.optim import adamw

PyTree = Any


def _topk_compress(g: torch.Tensor, err: torch.Tensor, ratio: float):
    """Top-k sparsification with error feedback. Returns (g_hat, new_err).
    A DTensor gradient is compressed whole (the top k of the full tensor,
    as the reference's), on its replicated form."""
    if g.dim() < 2:
        return g, err
    if isinstance(g, DTensor):
        mesh, rep = g.device_mesh, shlib.replicated(g.device_mesh)
        gh, eh = _topk_compress(shlib.place_one(g, rep, mesh).to_local(),
                                shlib.place_one(err, rep, mesh).to_local(),
                                ratio)
        return (shlib.from_local(gh, mesh, rep).redistribute(
                    mesh, g.placements),
                shlib.from_local(eh, mesh, rep).redistribute(
                    mesh, err.placements))
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


def _plain(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def in_placements(cfg: ModelConfig, run: RunConfig, mesh,
                  shape: ShapeConfig):
    """The train step's input layouts, the reference's ``in_shardings``:
    (params, opt_state, err_state, batch, step)."""
    bundle = get_model(cfg)
    p_pl = shlib.param_shardings(bundle.axes(), cfg, mesh)
    opt_p = (shlib.zero1_shardings(p_pl, bundle.abstract_params(), mesh)
             if run.zero1 else p_pl)
    rep = shlib.replicated(mesh)
    opt = adamw.AdamWState(step=rep, mu=opt_p, nu=opt_p)
    err = p_pl if run.grad_compression == "topk" else rep
    return p_pl, opt, err, shlib.batch_shardings(cfg, mesh, shape), rep


def build_train_step(cfg: ModelConfig, run: RunConfig, shape: ShapeConfig,
                     mesh=None):
    """Returns train_step(params, opt_state, err_state, batch, step,
    before_update=None) -> (params, opt_state, err_state, metrics), metrics
    = {loss, grad_norm, lr} as plain 0-d tensors on the params' device.
    ``step`` is an int or an int tensor; params and the optimizer state are
    updated in place (the reference donates them), and ``before_update()``,
    if given, is called just before the first of them is written."""
    bundle = get_model(cfg)
    use_compress = run.grad_compression == "topk"
    n_micro = (shape.global_batch // run.microbatch
               if run.microbatch and run.microbatch < shape.global_batch
               else 0)
    if mesh is None:
        kw, layout = {}, None
    else:
        baxes = shlib.batch_axes(mesh, shape.global_batch)
        kw = {"mesh": mesh, "batch_axes": baxes or ("data",)}
        layout = in_placements(cfg, run, mesh, shape)

    def loss_fn(params, batch):
        return bundle.train_loss(params, run, batch, **kw)

    def place_batch(batch):
        return batch if layout is None else {
            k: shlib.place_one(v, layout[3][k], mesh)
            for k, v in batch.items()}

    def train_step(params, opt_state, err_state, batch, step,
                   before_update=None):
        if layout is None:
            return _step(params, opt_state, err_state, batch, step,
                         before_update)
        with implicit_replication():
            params, opt_state, err_state = (
                shlib.place(t, pl, mesh) for t, pl in
                ((params, layout[0]), (opt_state, layout[1]),
                 (err_state, layout[2])))
            params, opt_state, err_state, metrics = _step(
                params, opt_state, err_state, batch, step, before_update)
        return params, opt_state, err_state, {
            k: _plain(v) for k, v in metrics.items()}

    def _step(params, opt_state, err_state, batch, step, before_update):
        if n_micro:
            gsum = [torch.zeros_like(p, dtype=torch.float32)
                    for p in tree_lib.leaves(params)]
            lsum = 0.0
            for i in range(n_micro):
                rows = slice(i * run.microbatch, (i + 1) * run.microbatch)
                mb = place_batch({k: _plain(v)[rows]
                                  for k, v in batch.items()})
                l, g = value_and_grad(loss_fn, params, mb)
                for acc, gi in zip(gsum, g):
                    acc.add_(gi)
                lsum = lsum + l
            loss = lsum / n_micro
            grads = [g / n_micro for g in gsum]
        else:
            loss, grads = value_and_grad(loss_fn, params, place_batch(batch))
        if layout is not None:
            # the reduction over the batch axes, to the params' layouts
            grads = [shlib.place_one(g, p.placements, mesh)
                     for g, p in zip(grads, tree_lib.leaves(params))]

        if use_compress:
            comp = [_topk_compress(g, e, run.topk_ratio)
                    for g, e in zip(grads, tree_lib.leaves(err_state))]
            grads = [c[0] for c in comp]
            err_state = tree_lib.unflatten(err_state, [c[1] for c in comp])

        grads, gnorm = adamw.clip_by_global_norm(grads, run.grad_clip)
        lr = adamw.cosine_schedule(step, base_lr=run.lr,
                                   warmup=run.warmup_steps,
                                   total=run.total_steps,
                                   device=_plain(loss).device)
        if before_update is not None:
            before_update()
        params, opt_state = adamw.update(grads, opt_state, params, lr=lr,
                                         weight_decay=run.weight_decay)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return params, opt_state, err_state, metrics

    return train_step


def build_prefill_step(cfg: ModelConfig, run: RunConfig, shape: ShapeConfig,
                       mesh=None):
    """prefill_step(params, tokens[, extra]) -> (logits, cache, lengths);
    the cache (none for the ssm family) is made on the tokens' device,
    with a mesh already laid out by ``cache_shardings``."""
    bundle = get_model(cfg)

    def make_cache(device):
        if cfg.family == "ssm":
            return None
        return bundle.init_cache(shape.global_batch, shape.seq_len,
                                 device=device)

    if mesh is None:
        def prefill_step(params, tokens, extra=None):
            return bundle.prefill(params, run, make_cache(tokens.device),
                                  tokens, extra=extra)
        return prefill_step

    baxes = shlib.batch_axes(mesh, shape.global_batch)
    b = baxes or None
    p_pl = shlib.param_shardings(bundle.axes(), cfg, mesh)
    tok_pl = shlib.placements((b, None), mesh)
    emb_pl = shlib.placements((b, None, None), mesh)
    c_pl = shlib.cache_shardings(cfg, mesh, shape)

    def prefill_step(params, tokens, extra=None):
        with implicit_replication():
            params = shlib.place(params, p_pl, mesh)
            tokens = shlib.place_one(tokens, tok_pl, mesh)
            if extra:
                extra = {k: shlib.place_one(v, emb_pl, mesh)
                         for k, v in extra.items()}
            cache = make_cache("meta")
            if cache is not None:
                cache = shlib.zeros(cache, c_pl, mesh,
                                    tokens.to_local().device)
            return bundle.prefill(params, run, cache, tokens, mesh=mesh,
                                  batch_axes=baxes or ("data",), extra=extra)

    return prefill_step


def build_decode_step(cfg: ModelConfig, run: RunConfig, shape: ShapeConfig,
                      mesh=None):
    """serve_step(params, cache, token, pos) -> (logits, cache)."""
    bundle = get_model(cfg)
    if mesh is None:
        def serve_step(params, cache, token, pos):
            return bundle.decode_step(params, run, cache, token, pos)
        return serve_step

    baxes = shlib.batch_axes(mesh, shape.global_batch)
    p_pl = shlib.param_shardings(bundle.axes(), cfg, mesh)
    c_pl = shlib.cache_shardings(cfg, mesh, shape)
    tok_pl = shlib.placements((baxes or None,), mesh)

    def serve_step(params, cache, token, pos):
        with implicit_replication():
            params = shlib.place(params, p_pl, mesh)
            cache = shlib.place(cache, c_pl, mesh)
            token, pos = (shlib.place_one(t, tok_pl, mesh)
                          for t in (token, pos))
            return bundle.decode_step(params, run, cache, token, pos,
                                      mesh=mesh,
                                      batch_axes=baxes or ("data",))

    return serve_step
