"""Mixture-of-Experts layer: top-k routing, capacity-bounded dispatch,
expert FFNs, gated combine, and its expert-parallel execution.

Port of ``repro/models/moe.py``. Two implementations:

* ``moe_apply`` — without a mesh, the local path (``_moe_local`` with every
  expert local): gather each expert's tokens through the (E, C) dispatch
  table, run the experts as batched products, combine the k outputs of
  each token by its gates. With a mesh, the reference's ``shard_map``
  expert-parallel path (``_moe_ep``): experts sharded over ``model``,
  tokens over the batch axes, the partial outputs summed over ``model``.
* ``moe_apply_einsum`` — the one-hot dispatch-einsum baseline
  (O(T·E·C·d)), for tests and cross-checks.

Routing and capacity drops are exact: top-k of the float32 softmax
(``torch.topk(sorted=True)``, as ``jax.lax.top_k``), and a (token, k)
pair's slot is its running count within its expert in token-major,
k-minor order, so the same pairs are dropped. The combine adds each
token's k rows in a fixed order (a sum over a (T, k, d) view), never
through atomics.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shlib
from repro_torch.models.common import ParamDef, act_fn

PyTree = Any


def moe_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, dff, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
    defs = {
        "router": ParamDef((d, e), ("embed", "experts")),
        "w_gate": ParamDef((e, d, dff), ("experts", "embed", "mlp")),
        "w_up": ParamDef((e, d, dff), ("experts", "embed", "mlp")),
        "w_down": ParamDef((e, dff, d), ("experts", "mlp", "embed")),
    }
    if cfg.shared_expert:
        defs.update({
            "sh_gate": ParamDef((d, cfg.d_ff), ("embed", "mlp")),
            "sh_up": ParamDef((d, cfg.d_ff), ("embed", "mlp")),
            "sh_down": ParamDef((cfg.d_ff, d), ("mlp", "embed")),
        })
    return defs


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(8, -(-c // 8) * 8)  # round up to 8


def _route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """Top-k routing. x: (T, d). Returns (idx (T, k) int64, gate (T, k)
    float32, aux loss)."""
    logits = x.float() @ router.float()
    gates_all = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(gates_all, cfg.top_k, dim=-1, sorted=True)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux loss (Switch-style) + router z-loss; the expert
    # counts are integer sums of a one-hot, so their share is exact and in
    # no atomic order (and shape-only: the dry-run counts it on meta)
    me = gates_all.mean(0)
    ce = F.one_hot(idx.reshape(-1), cfg.n_experts).sum(0).float() \
        * (1.0 / idx.numel())
    aux = cfg.n_experts * (me * ce).sum()
    aux = aux + 1e-4 * torch.logsumexp(logits, dim=-1).square().mean()
    return idx, gate, aux


def _dispatch_tables(idx: torch.Tensor, n_experts: int, capacity: int):
    """(E, C) token-slot tables from (T, k) expert assignments.

    Returns token_id (E, C) int64 (-1 = empty) and slot (T, k) int64 (the
    position within its expert; >= capacity means dropped). A dropped pair
    writes to a spare row that is cut off, so nothing waits for the host.
    """
    T, k = idx.shape
    flat = idx.reshape(-1)                                  # (T*k,)
    # (E, T*k): the running count along the inner axis, a fast scan
    onehot = F.one_hot(flat, n_experts).t().contiguous()
    pos = torch.cumsum(onehot, dim=1) - 1                   # pos within expert
    slot = pos.gather(0, flat[None])[0]
    tok = torch.arange(T * k, device=idx.device) // k
    keep = slot < capacity
    row = torch.where(keep, flat, n_experts)
    col = torch.where(keep, slot, 0)
    token_id = torch.full(((n_experts + 1) * capacity,), -1, dtype=torch.long,
                          device=idx.device)
    token_id[row * capacity + col] = tok
    return token_id[:n_experts * capacity].reshape(n_experts, capacity), \
        slot.reshape(T, k)


def _expert_ffn(xg: torch.Tensor, wg, wu, wd, act) -> torch.Tensor:
    """xg: (E_loc, C, d) -> (E_loc, C, d)."""
    wg, wu, wd = (w.to(xg.dtype) for w in (wg, wu, wd))
    h = act(torch.bmm(xg, wg)) * torch.bmm(xg, wu)
    return torch.bmm(h, wd)


def _moe_local(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig,
               act, e_lo: int, n_local: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE over experts [e_lo, e_lo + n_local): x (T, d) -> (out (T, d),
    aux). The router sees every expert."""
    T, d = x.shape
    C = _capacity(T, cfg)
    k = cfg.top_k
    idx, gate, aux = _route(x, p["router"], cfg)
    token_id, slot = _dispatch_tables(idx, cfg.n_experts, C)
    local_tok = token_id[e_lo:e_lo + n_local]                # (E_loc, C)
    # expert weights that hold only the local experts (an expert-parallel
    # shard) are taken whole, as the reference's clamped dynamic slice does
    ws = [w if w.shape[0] == n_local else w[e_lo:e_lo + n_local]
          for w in (p["w_gate"], p["w_up"], p["w_down"])]
    xg = torch.where((local_tok >= 0)[..., None],
                     x[torch.clamp(local_tok, min=0)], 0.0)  # (E_loc, C, d)
    yg = _expert_ffn(xg.to(x.dtype), *ws, act)               # (E_loc, C, d)
    # combine: the k outputs of each token whose expert is local and whose
    # slot was kept, scaled by their gates, added in k order
    e_flat, s_flat = idx.reshape(-1), slot.reshape(-1)
    is_local = (e_flat >= e_lo) & (e_flat < e_lo + n_local) & (s_flat < C)
    rows = torch.where(is_local, e_flat - e_lo, 0)
    vals = yg[rows, torch.where(is_local, s_flat, 0)]        # (T*k, d)
    vals = torch.where(is_local[:, None],
                       vals.float() * gate.reshape(-1)[:, None], 0.0)
    out = vals.view(T, k, d).sum(dim=1)
    return out.to(x.dtype), aux


def _shared(x: torch.Tensor, p, act) -> torch.Tensor:
    h = act(x @ p["sh_gate"].to(x.dtype)) * (x @ p["sh_up"].to(x.dtype))
    return shlib.batch_only(h @ p["sh_down"].to(x.dtype))


def moe_apply(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig,
              run: RunConfig = None, mesh=None,
              batch_axes: Tuple[str, ...] = ("data",)
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE layer. x: (B, S, d). Returns (y (B, S, d), aux loss).

    Without a mesh, or on a mesh whose ``model`` axis is 1 or absent, the
    local path runs every expert. With a mesh the routed experts run in
    the expert-parallel region (``_moe_ep``); x and the params may be plain
    tensors (the same full tensor on every rank) or DTensors, and y and aux
    come back as DTensors. The shared expert stays outside the region.
    """
    B, S, d = x.shape
    act = act_fn(cfg.act)
    tp = 1 if mesh is None else shlib.mesh_axis_size(mesh, "model")
    if cfg.n_experts % tp:
        raise ValueError(f"{cfg.n_experts} experts not divisible by "
                         f"model={tp}")
    if tp == 1 and not isinstance(x, DTensor):
        y2, aux = _moe_local(x.reshape(B * S, d), p, cfg, act, 0,
                             cfg.n_experts)
        y = y2.reshape(B, S, d)
    else:
        rep = shlib.replicated(mesh)
        x = shlib.place_one(x, x.placements if isinstance(x, DTensor)
                            else rep, mesh)
        p = {k: shlib.place_one(v, v.placements if isinstance(v, DTensor)
                                else rep, mesh) for k, v in p.items()}
        y, aux = _moe_ep(x, p, cfg, act, mesh, batch_axes)
    if cfg.shared_expert:
        y = y + _shared(x, p, act)
    return y, aux


def _moe_ep(x: DTensor, p, cfg: ModelConfig, act, mesh, batch_axes):
    """The reference's ``shard_map`` region: each ``model`` rank routes its
    (batch-sharded, model-replicated) tokens over all experts, runs its
    local experts ``[e_lo, e_lo + E/tp)``, and the partial outputs are
    summed over ``model``; aux is ``psum/tp`` over ``model``, then the mean
    over the other axes. With ``model`` 1 or absent the local path runs on
    the whole batch, as GSPMD runs the reference's (global capacity)."""
    names = mesh.mesh_dim_names
    tp = shlib.mesh_axis_size(mesh, "model")
    n_local = cfg.n_experts // tp
    B, S, d = x.shape
    if tp == 1:
        rep = shlib.replicated(mesh)
        xl = shlib.local(x, rep, mesh)
        pl = {k: shlib.local(v, rep, mesh) for k, v in p.items()
              if k in ("router", "w_gate", "w_up", "w_down")}
        y2, aux = _moe_local(xl.reshape(B * S, d), pl, cfg, act, 0,
                             cfg.n_experts)
        y = shlib.from_local(y2.reshape(B, S, d), mesh, rep)
        return (y.redistribute(mesh, x.placements),
                shlib.from_local(aux, mesh, rep))
    # placements in (forward) and of the gradients coming back: a rank's
    # gradient of a replicated input is partial where its tokens or its
    # experts are only a part (a batch axis; model)
    batch = [a for a in names if a in batch_axes]
    x_pl = shlib.placements((tuple(batch) or None, None, None), mesh)
    part = lambda a: Partial() if a == "model" or a in batch else Replicate()
    x_grad = tuple(Partial() if a == "model" else pl
                   for a, pl in zip(names, x_pl))
    rep = shlib.replicated(mesh)
    r_grad = tuple(part(a) for a in names)
    w_pl = shlib.placements(("model", None, None), mesh)
    w_grad = tuple(Shard(0) if a == "model" else part(a) for a in names)
    xl = shlib.local(x, x_pl, mesh, x_grad)
    pl = {"router": shlib.local(p["router"], rep, mesh, r_grad)}
    for k in ("w_gate", "w_up", "w_down"):
        pl[k] = shlib.local(p[k], w_pl, mesh, w_grad)
    e_lo = mesh.get_local_rank("model") * n_local
    Bl = xl.shape[0]
    y2, aux = _moe_local(xl.reshape(Bl * S, d), pl, cfg, act, e_lo, n_local)
    y2 = coll.psum(y2, mesh.get_group("model"))
    # aux is identical across `model` ranks (same tokens, same router);
    # psum/tp keeps it differentiable. Across the other axes tokens differ
    # -> average (the per-data-shard aux-loss semantics).
    aux = coll.psum(aux, mesh.get_group("model")) / tp
    for a in names:
        if a != "model":
            aux = coll.pmean(aux, mesh.get_group(a))
    return (shlib.from_local(y2.reshape(Bl, S, d), mesh, x_pl),
            shlib.from_local(aux, mesh, rep))


def moe_apply_einsum(x: torch.Tensor, p: Dict[str, torch.Tensor],
                     cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-hot dispatch-einsum baseline (O(T·E·C·d) dispatch)."""
    B, S, d = x.shape
    T, k, E = B * S, cfg.top_k, cfg.n_experts
    act = act_fn(cfg.act)
    xf = x.reshape(T, d)
    C = _capacity(T, cfg)
    idx, gate, aux = _route(xf, p["router"], cfg)
    _, slot = _dispatch_tables(idx, E, C)
    # dispatch one-hot (T, E, C); gates apply at the combine only (the
    # expert nonlinearity must see the raw token)
    t_flat = torch.arange(T * k, device=x.device) // k
    keep = slot.reshape(-1) < C
    at = (t_flat, idx.reshape(-1), torch.clamp(slot.reshape(-1), 0, C - 1))
    disp = torch.zeros((T, E, C), dtype=x.dtype, device=x.device)
    disp.index_put_(at, keep.to(x.dtype), accumulate=True)
    comb = torch.zeros((T, E, C), dtype=x.dtype, device=x.device)
    comb.index_put_(at, torch.where(keep, gate.reshape(-1), 0.0).to(x.dtype),
                    accumulate=True)
    xg = torch.einsum("tec,td->ecd", disp, xf)
    yg = _expert_ffn(xg, p["w_gate"], p["w_up"], p["w_down"], act)
    y = torch.einsum("tec,ecd->td", comb, yg).reshape(B, S, d)
    if cfg.shared_expert:
        y = y + _shared(x, p, act)
    return y, aux
