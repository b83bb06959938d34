"""Local regions: the model ops that DTensor cannot shard as GSPMD does,
written on local shards with the placements GSPMD would give.

Each function takes DTensors, runs plain PyTorch (or a kernel) on
``to_local()`` shards and returns DTensors. The gradient of a replicated
input that a rank uses only in part is declared ``Partial``
(``to_local(grad_placements=...)``), so the backward adds the ranks' parts.

* ``embedding``: a vocab-sharded table (DTensor's masked lookup keeps its
  mask in a buffer that a second use of the table, as in a tied unembed,
  consumes: its backward then fails).
* ``data_parallel``: a block whose params are all replicated, run on the
  local batch (DTensor has no rule for some of xLSTM's ops, e.g.
  ``log_sigmoid_backward``, and the sLSTM's loop over the sequence is
  cheaper so);
* ``selective_scan``: Mamba's scan, elementwise over the inner dim, run
  on the local inner shards (thousands of small ops per layer, which
  DTensor dispatches slowly on a three-axis mesh);
* ``write_prefix``: positions [0, S) of a (possibly sequence-sharded)
  cache; DTensor has no rule for writing a slice of a sharded dim.
* ``attention``: full-sequence attention on local shards (batch over the
  batch axes, heads over ``model`` where they divide, else every ``model``
  rank computes them all, as GSPMD does), for the plain path, for the
  flash kernel (which never sees a DTensor) and for ``attn_pad_heads``;
* ``gqa_attention``: attention against a cache laid out by
  ``cache_shardings``: where its sequence is sharded each rank attends to
  its own keys and the softmax is combined over those axes
  (flash-decoding), the collectives a few floats per query;
* ``xent``: the cross-entropy of vocab-sharded logits (Megatron's
  vocab-parallel form: max, sum of exponentials and the label's logit
  combined over ``model``), where DTensor would gather the logits.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from repro_torch import tree as tree_lib
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shlib


def _grad_partial_where_split(pl, split_axes, mesh):
    """Gradient placements for an input placed by ``pl`` whose use differs
    across the ranks of ``split_axes`` (each holds a part): Partial there
    where the input is replicated."""
    return tuple(Partial() if (n in split_axes and isinstance(p, Replicate))
                 else p for n, p in zip(mesh.mesh_dim_names, pl))


def embedding(tokens: DTensor, table: DTensor) -> DTensor:
    """``table[tokens]``: tokens (B, S) placed by the batch rule, table (V,
    d) by the param rule. A vocab-sharded table gives a ``Partial`` output
    over ``model`` (each rank looks up its own rows, zero elsewhere)."""
    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    tok_pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                   for p in tokens.placements)
    tok = shlib.local(tokens, tok_pl, mesh)
    split = {n for n, p in zip(names, tok_pl) if isinstance(p, Shard)}
    tab = shlib.to_local(table, _grad_partial_where_split(
        table.placements, split, mesh))
    _, (v_lo, _) = compute_local_shape_and_global_offset(
        table.shape, mesh, table.placements)
    ok = (tok >= v_lo) & (tok < v_lo + tab.shape[0])
    out = F.embedding(torch.where(ok, tok - v_lo, 0).long(), tab)
    if tab.shape[0] != table.shape[0]:
        out = out * ok[..., None].to(out.dtype)
    out_pl = tuple(Partial() if isinstance(tp, Shard) else p
                   for p, tp in zip(tok_pl, table.placements))
    return shlib.from_local(out, mesh, out_pl)


def data_parallel(fn: Callable, params, x, *rest):
    """``fn(params, x, *rest)`` for a block whose params are all replicated
    (xLSTM's cells): pure data parallelism, as GSPMD runs it. x and the
    tensors of ``rest`` (states, batch first) are cut to the batch axes on
    which x is sharded; each param's gradient is Partial over those axes.
    Every tensor ``fn`` returns comes back batch-sharded like x. Plain
    tensors just run ``fn``."""
    if not isinstance(x, DTensor):
        return fn(params, x, *rest)
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    batch = _dividing(mesh, [n for n, p in zip(names, x.placements)
                             if isinstance(p, Shard) and p.dim == 0],
                      x.shape[0])
    b_pl = shlib.placements((batch or None,), mesh)
    grad = tuple(Partial() if n in batch else Replicate() for n in names)

    def param(t):
        if not isinstance(t, DTensor):
            return t
        if any(not isinstance(p, Replicate) for p in t.placements):
            raise ValueError(f"data_parallel: a param is laid out "
                             f"{t.placements}; the region takes replicated "
                             f"params only")
        return shlib.to_local(t, grad)

    def local(t):
        if isinstance(t, DTensor):
            return shlib.local(t, b_pl, mesh)
        return t

    out = fn(tree_lib.tree_map(param, params), local(x),
             *(None if r is None else tree_lib.tree_map(local, r)
               for r in rest))
    return tree_lib.tree_map(
        lambda t: shlib.from_local(t, mesh, b_pl)
        if isinstance(t, torch.Tensor) else t, out)


def selective_scan(fn: Callable, u, dt, A, Bc, Cc, h0):
    """``fn(u, dt, A, Bc, Cc, h0)`` (``ssm.selective_scan``) on local
    shards: u, dt (B, S, di) and h0 (B, di, N) with the batch as u has it
    and the inner dim over ``model`` where u has it so, A (di, N) over the
    inner dim, Bc, Cc (B, S, N) over the batch only (every inner shard
    reads them whole: their gradients are Partial over ``model``; A's is
    Partial over the batch axes, every batch shard reading it). Returns
    (y (B, S, di), h (B, di, N)) laid out so. Plain tensors just run
    ``fn``."""
    if not isinstance(u, DTensor):
        return fn(u, dt, A, Bc, Cc, h0)
    mesh = u.device_mesh
    names = mesh.mesh_dim_names
    batch = [n for n, p in zip(names, u.placements)
             if isinstance(p, Shard) and p.dim == 0]
    inner = [n for n, p in zip(names, u.placements)
             if isinstance(p, Shard) and p.dim == 2]
    spec = lambda *dims: shlib.placements(dims, mesh)
    b, i = tuple(batch) or None, tuple(inner) or None
    u_pl, h_pl = spec(b, None, i), spec(b, i, None)
    bc_pl = spec(b, None, None)
    bc_grad = _grad_partial_where_split(bc_pl, set(inner), mesh)
    y, h = fn(shlib.local(u, u_pl, mesh), shlib.local(dt, u_pl, mesh),
              shlib.local(A, spec(i, None), mesh, _grad_partial_where_split(
                  spec(i, None), set(batch), mesh)),
              shlib.local(Bc, bc_pl, mesh, bc_grad),
              shlib.local(Cc, bc_pl, mesh, bc_grad),
              shlib.local(h0, h_pl, mesh))
    return shlib.from_local(y, mesh, u_pl), shlib.from_local(h, mesh, h_pl)


def write_prefix(cache: DTensor, x: DTensor) -> DTensor:
    """A copy of cache (B, Smax, ...) with positions [0, S) set to x (B, S,
    ...): each rank writes the part of x that falls in its own shard of the
    sequence."""
    mesh = cache.device_mesh
    x_pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                 for p in cache.placements)
    xl = shlib.local(x, x_pl, mesh)
    cl = shlib.to_local(cache)
    _, off = compute_local_shape_and_global_offset(cache.shape, mesh,
                                                   cache.placements)
    lo, hi = off[1], off[1] + cl.shape[1]
    out = cl.clone()
    a, b = max(lo, 0), min(hi, x.shape[1])
    if a < b:
        out[:, a - lo:b - lo] = xl[:, a:b].to(out.dtype)
    return shlib.from_local(out, mesh, cache.placements)


def _dividing(mesh, axes: Sequence[str], n: int) -> Tuple[str, ...]:
    """``axes`` if their sizes divide ``n`` (else none: replicated)."""
    axes = tuple(a for a in axes if a in mesh.mesh_dim_names)
    size = 1
    for a in axes:
        size *= shlib.mesh_axis_size(mesh, a)
    return axes if n % size == 0 else ()


def attention(q: DTensor, k: DTensor, v: DTensor, fn: Callable, *,
              batch: Sequence[str], heads_over_model: bool,
              pad_to: Optional[int] = None) -> DTensor:
    """``fn(q, k, v)`` on local shards of (B, S, H, d) operands: the batch
    over the mesh axes ``batch`` (where they divide it), the heads over
    ``model`` when ``heads_over_model`` (then H must divide, or ``pad_to``
    gives the padded head count: zero heads are appended and sliced off
    after). Returns the (B, S, H, d) output, heads replicated when
    padded."""
    mesh = q.device_mesh
    H = q.shape[2]
    batch = _dividing(mesh, batch, q.shape[0])
    b = batch or None
    shard_heads = heads_over_model and pad_to is None
    pl = shlib.placements((b, None, "model" if shard_heads else None, None),
                          mesh)
    split = set(batch) | ({"model"} if heads_over_model else set())
    grad = _grad_partial_where_split(pl, split, mesh)
    ql, kl, vl = (shlib.local(t, pl, mesh, grad)
                  for t in (q, k, v))
    if pad_to is not None:
        tp = shlib.mesh_axis_size(mesh, "model")
        per = pad_to // tp
        lo = mesh.get_local_rank("model") * per
        pad = lambda t: F.pad(t, (0, 0, 0, pad_to - H))[:, :, lo:lo + per]
        ql, kl, vl = pad(ql), pad(kl), pad(vl)
    out = fn(ql, kl, vl)
    if pad_to is None:
        return shlib.from_local(out, mesh, pl)
    full_pl = shlib.placements((b, None, "model", None), mesh)
    out = shlib.from_local(out, mesh, full_pl)
    out = out.redistribute(mesh, shlib.placements((b, None, None, None),
                                                  mesh))
    return out[:, :, :H]


def gqa_attention(q: DTensor, k: DTensor, v: DTensor, *, causal: bool,
                  q_offset, window: int, attn_softcap: float,
                  kv_len=None) -> DTensor:
    """``common.gqa_attention`` with k/v (B, Sk, Hkv, D) as they are laid
    out (a cache: batch, sequence and kv heads each maybe sharded) and q
    (B, Sq, Hq, D) placed to match. Each rank attends to its own keys (at
    their global positions); where the sequence is sharded the partial
    softmax sums are combined over those axes. float32 math, masked
    logits -1e30, as the plain version."""
    mesh = k.device_mesh
    names = mesh.mesh_dim_names
    seq_axes = [n for n, p in zip(names, k.placements)
                if isinstance(p, Shard) and p.dim == 1]
    q_pl = tuple(p if isinstance(p, Shard) and p.dim in (0, 2)
                 else Replicate() for p in k.placements)
    b_pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in k.placements)
    ql = shlib.local(q, q_pl, mesh)
    kl, vl = shlib.to_local(k), shlib.to_local(v)
    _, (_, k_lo, _, _) = compute_local_shape_and_global_offset(
        k.shape, mesh, k.placements)
    dev = ql.device

    def local_vec(t):
        if isinstance(t, DTensor):
            return shlib.local(t, b_pl, mesh)
        return torch.as_tensor(t, device=dev)

    B, Sq, Hq, D = ql.shape
    Sk, Hkv = kl.shape[1], kl.shape[2]
    g = Hq // Hkv
    qh = ql.reshape(B, Sq, Hkv, g, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qh.float(),
                          kl.float()) * (1.0 / D ** 0.5)
    if attn_softcap:
        logits = attn_softcap * torch.tanh(logits / attn_softcap)
    q_pos = local_vec(q_offset).reshape(-1, 1) + \
        torch.arange(Sq, device=dev)[None]
    k_pos = k_lo + torch.arange(Sk, device=dev)[None]
    mask = torch.ones((q_pos.shape[0], Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= q_pos[:, :, None] >= k_pos[:, None, :]
    if window > 0:
        mask &= (q_pos[:, :, None] - k_pos[:, None, :]) < window
    if kv_len is not None:
        mask &= k_pos[:, None, :] < local_vec(kv_len).reshape(-1, 1, 1)
    logits = torch.where(mask[:, None, None], logits,
                         torch.tensor(-1e30, device=dev))
    if not seq_axes:
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", w, vl.float())
    else:
        m = logits.amax(-1, keepdim=True)
        groups = [mesh.get_group(a) for a in seq_axes]
        m_all = m.detach()
        for gr in groups:
            m_all = coll.all_reduce(m_all, gr, "max")
        p = torch.exp(logits - m_all)
        num = torch.einsum("bhgqk,bkhd->bqhgd", p, vl.float())
        den = p.sum(-1).permute(0, 3, 1, 2)[..., None]
        for gr in groups:
            num, den = coll.psum(num, gr), coll.psum(den, gr)
        out = num / den
    out = out.reshape(B, Sq, Hq, D).to(ql.dtype)
    return shlib.from_local(out, mesh, q_pl)


def xent(logits: DTensor, labels: DTensor, mask=None,
         z_loss: float = 1e-4) -> DTensor:
    """``common.softmax_xent`` of logits (B, S, V) whose vocab is sharded
    over ``model``: the row max, the sum of exponentials and the label's
    logit are combined over ``model``, the mean over the batch axes by
    DTensor. Returns a replicated scalar."""
    mesh = logits.device_mesh
    names = mesh.mesh_dim_names
    batch = _dividing(mesh, [n for n, p in zip(names, logits.placements)
                             if isinstance(p, Shard) and p.dim == 0],
                      logits.shape[0])
    split = shlib.mesh_axis_size(mesh, "model") > 1 and \
        logits.shape[-1] % shlib.mesh_axis_size(mesh, "model") == 0
    pl = shlib.placements((batch or None, None, "model" if split else None),
                          mesh)
    ll = shlib.local(logits, pl, mesh).float()
    lab_pl = shlib.placements((batch or None, None), mesh)
    lab = shlib.local(labels, lab_pl, mesh).long()
    _, (_, _, v_lo) = compute_local_shape_and_global_offset(
        logits.shape, mesh, pl)
    m = ll.detach().amax(-1)
    if split:
        group = mesh.get_group("model")
        m = coll.all_reduce(m, group, "max")
    sumexp = torch.exp(ll - m[..., None]).sum(-1)
    ok = (lab >= v_lo) & (lab < v_lo + ll.shape[-1])
    pick = torch.gather(ll, -1, torch.where(ok, lab - v_lo, 0)[..., None])
    tgt = torch.where(ok, pick[..., 0], 0.0)
    if split:
        sumexp, tgt = coll.psum(sumexp, group), coll.psum(tgt, group)
    lse = torch.log(sumexp) + m
    loss = lse - tgt
    if z_loss:
        loss = loss + z_loss * lse.square()
    out_pl = lab_pl
    loss = shlib.from_local(loss, mesh, out_pl)
    if mask is None:
        return loss.mean()
    mask = shlib.place_one(mask, out_pl, mesh).float()
    return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)
