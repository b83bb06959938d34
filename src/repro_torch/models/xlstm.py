"""xLSTM: mLSTM (matrix memory, chunkwise-parallel) + sLSTM (scalar memory).

Port of ``repro/models/xlstm.py``. The mLSTM runs in chunkwise-parallel
form: within a chunk a masked attention-like product, across chunks a loop
carrying the stabilized (C, n, m) state, so the work is O(S * chunk) rather
than O(S^2). The sLSTM has a true sequential dependency (recurrent gate
products) and runs as a plain loop over time steps.

State is stabilized in log space: the carried (C, n) have the running max
m factored out (true C = C * e^m). The state math is float32 exactly where
the reference casts. Like the reference, the model keeps its own chunk
scan; the mLSTM scan kernel (``kernels/mlstm_scan``) is a standalone op.
``run.remat`` is ignored, as in ``models/lm.py``.

The parameter tree is ``{"embed", "final_norm", "blocks": [...]}`` with
``blocks`` a list of per-layer dicts (sLSTM or mLSTM), the reference's
layout, so the tests hand both packages the same weights
(``params_from_numpy``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.common import (ParamDef, init_params, rms_norm,
                                       softmax_xent)

PyTree = Any

NEG = -1e30
MMIN = -40.0


def _d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def mlstm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, di, h = cfg.d_model, _d_inner(cfg), cfg.mlstm_heads
    dh = di // h
    return {
        "ln": ParamDef((d,), ("embed",), "zeros"),
        "w_up": ParamDef((d, 2 * di), ("embed", "inner")),
        "conv": ParamDef((cfg.conv_width, di), (None, "inner")),
        "wq": ParamDef((di, h, dh), ("inner", None, None)),
        "wk": ParamDef((di, h, dh), ("inner", None, None)),
        "wv": ParamDef((di, h, dh), ("inner", None, None)),
        "w_if": ParamDef((di, h, 2), ("inner", None, None), scale=0.1),
        "b_if": ParamDef((h, 2), (None, None), "zeros"),
        "gn": ParamDef((di,), ("inner",), "zeros"),
        "w_down": ParamDef((di, d), ("inner", "embed")),
    }


def slstm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, h = cfg.d_model, cfg.mlstm_heads
    dh = d // h
    return {
        "ln": ParamDef((d,), ("embed",), "zeros"),
        "wx": ParamDef((d, h, 4, dh), ("embed", None, None, None)),
        "wr": ParamDef((h, dh, 4, dh), (None, None, None, None), scale=0.5),
        "b": ParamDef((h, 4, dh), (None, None, None), "zeros"),
        "wz_gate": ParamDef((d, d), ("embed", None)),
        "gn": ParamDef((d,), ("embed",), "zeros"),
        "w_down": ParamDef((d, d), ("embed", "embed")),
    }


def is_slstm(cfg: ModelConfig, i: int) -> bool:
    return bool(cfg.slstm_every) and (i % cfg.slstm_every == 0)


def full_defs(cfg: ModelConfig) -> Dict[str, Any]:
    defs: Dict[str, Any] = {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed")),
        "final_norm": ParamDef((cfg.d_model,), ("embed",), "zeros"),
        "blocks": [slstm_defs(cfg) if is_slstm(cfg, i) else mlstm_defs(cfg)
                   for i in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                   ("embed", "vocab"))
    return defs


def init(gen: torch.Generator, cfg: ModelConfig,
         dtype=torch.float32) -> PyTree:
    """Random weights on ``gen``'s device, drawn in ``dtype``."""
    return init_params(gen, full_defs(cfg), dtype)


# ---------------------------------------------------------------------------
# mLSTM cell — chunkwise parallel
# ---------------------------------------------------------------------------

def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """x: (B,S,di); w: (W,di). Depthwise causal conv. Returns (y, new_state)."""
    W = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(W))
    return y, xp[:, -(W - 1):] if W > 1 else state


def mlstm_chunk_scan(q, k, v, lf, li, state, chunk: int = 256):
    """Chunkwise-parallel mLSTM.

    q,k,v: (B,H,S,dh); lf: (B,H,S) log-forget (<=0); li: (B,H,S) log-input.
    state: (C (B,H,dh,dh), n (B,H,dh), m (B,H)) with true C = C·e^m.
    Returns (h (B,H,S,dh), new_state). When ``chunk`` does not divide S the
    tail is padded, the log-input gate with NEG so padded steps add nothing.
    """
    B, H, S, dh = q.shape
    pad = (-S) % chunk
    if pad:
        q = F.pad(q, (0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        lf = F.pad(lf, (0, pad))
        li = F.pad(li, (0, pad), value=NEG)
    nc = (S + pad) // chunk
    # scale q once so intra-chunk AND carried-state terms are consistent
    qs = q * dh ** -0.5
    iidx = torch.arange(chunk, device=q.device)
    causal = iidx[:, None] >= iidx[None, :]
    neg = torch.tensor(NEG, dtype=lf.dtype, device=q.device)
    C, n, m = state          # C: (B,H,dh,dh) with true value C*e^m
    hs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        qc, kc, vc, lfc, lic = qs[:, :, sl], k[:, :, sl], v[:, :, sl], \
            lf[:, :, sl], li[:, :, sl]
        Fc = torch.cumsum(lfc, dim=-1)                          # (B,H,L)
        # log weight of input j as seen at position i: F_i - F_j + li_j
        dlog = Fc[..., :, None] - Fc[..., None, :] + lic[..., None, :]
        dlog = torch.where(causal, dlog, neg)
        state_log = Fc + m[..., None]                           # (B,H,L)
        m_i = torch.maximum(dlog.amax(dim=-1), state_log)
        m_i = torch.clamp(m_i, min=MMIN)                        # no -inf carries
        w = torch.exp(dlog - m_i[..., None])                    # (B,H,L,L)
        sqk = torch.einsum("bhid,bhjd->bhij", qc, kc)
        num_intra = torch.einsum("bhij,bhjd->bhid", w * sqk, vc)
        den_intra = torch.einsum("bhij,bhij->bhi", w, sqk)
        sfac = torch.exp(state_log - m_i)                       # (B,H,L)
        num_state = torch.einsum("bhid,bhde->bhie", qc, C) * sfac[..., None]
        den_state = torch.einsum("bhid,bhd->bhi", qc, n) * sfac
        num = num_intra + num_state
        den = den_intra + den_state
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_i))[..., None])
        # end-of-chunk state
        FL = Fc[..., -1:]                                       # (B,H,1)
        m_new = torch.maximum(FL[..., 0] + m, (FL - Fc + lic).amax(dim=-1))
        m_new = torch.clamp(m_new, min=MMIN)
        wL = torch.exp(FL - Fc + lic - m_new[..., None])        # (B,H,L)
        decay = torch.exp(FL[..., 0] + m - m_new)
        C = decay[..., None, None] * C + \
            torch.einsum("bhj,bhjd,bhje->bhde", wL, kc, vc)
        n = decay[..., None] * n + torch.einsum("bhj,bhjd->bhd", wL, kc)
        m = m_new
    h = torch.cat(hs, dim=2)[:, :, :S]
    return h, (C, n, m)


def mlstm_decode_cell(q, k, v, lf, li, state):
    """Single-token mLSTM update. q,k,v: (B,H,dh); lf,li: (B,H)."""
    C, n, m = state
    m_new = torch.maximum(lf + m, li)
    fprime = torch.exp(lf + m - m_new)
    iprime = torch.exp(li - m_new)
    C_new = fprime[..., None, None] * C + \
        iprime[..., None, None] * (k[..., :, None] * v[..., None, :])
    n_new = fprime[..., None] * n + iprime[..., None] * k
    scale = q.shape[-1] ** -0.5
    num = torch.einsum("bhd,bhde->bhe", q * scale, C_new)
    den = torch.einsum("bhd,bhd->bh", q * scale, n_new)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h, (C_new, n_new, m_new)


def _mlstm_qkvg(p, cfg, h, conv_state=None):
    """Shared projections. h: (B,S,d) normed input."""
    di = _d_inner(cfg)
    dt = h.dtype
    up = h @ p["w_up"].to(dt)
    xm, z = torch.split(up, di, dim=-1)
    xc, new_conv = _causal_conv(xm, p["conv"].to(dt), conv_state)
    xc = F.silu(xc)
    q = torch.einsum("bsi,ihd->bhsd", xc, p["wq"].to(dt))
    k = torch.einsum("bsi,ihd->bhsd", xc, p["wk"].to(dt))
    v = torch.einsum("bsi,ihd->bhsd", xm, p["wv"].to(dt))
    gates = torch.einsum("bsi,ihg->bhsg", xm, p["w_if"].to(dt)) + \
        p["b_if"].to(dt)[None, :, None, :]
    li = gates[..., 0].float()
    lf = F.logsigmoid(gates[..., 1].float() + 3.0)
    return q, k, v, lf, li, z, new_conv


def _mlstm_out(p, cfg, hcell, z, x):
    """hcell: (B,H,S,dh) -> residual output."""
    B, H, S, dh = hcell.shape
    hflat = hcell.permute(0, 2, 1, 3).reshape(B, S, H * dh)
    hflat = rms_norm(hflat.to(z.dtype), p["gn"], cfg.norm_eps)
    y = hflat * F.silu(z)
    return x + y @ p["w_down"].to(z.dtype)


def mlstm_block(p, cfg: ModelConfig, x, state=None):
    """x: (B,S,d). state: (C,n,m,conv) or None (train). Returns (x, state)."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    conv_state = state[3] if state is not None else None
    q, k, v, lf, li, z, new_conv = _mlstm_qkvg(p, cfg, h, conv_state)
    B = x.shape[0]
    H = cfg.mlstm_heads
    dh = _d_inner(cfg) // H
    if state is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        s0 = (torch.zeros((B, H, dh, dh), **f32),
              torch.zeros((B, H, dh), **f32),
              torch.full((B, H), MMIN, **f32))
        hcell, s_fin = mlstm_chunk_scan(q.float(), k.float(), v.float(), lf,
                                        li, s0)
        return _mlstm_out(p, cfg, hcell.to(x.dtype), z, x), \
            (s_fin[0], s_fin[1], s_fin[2], new_conv)
    C, n, m = state[0], state[1], state[2]
    hc, (C2, n2, m2) = mlstm_decode_cell(
        q[:, :, 0].float(), k[:, :, 0].float(), v[:, :, 0].float(),
        lf[:, :, 0], li[:, :, 0], (C, n, m))
    hcell = hc[:, :, None, :]
    y = _mlstm_out(p, cfg, hcell.to(x.dtype), z, x)
    return y, (C2, n2, m2, new_conv)


# ---------------------------------------------------------------------------
# sLSTM — sequential loop
# ---------------------------------------------------------------------------

def slstm_cell(p, cfg, xt, state):
    """One sLSTM step. xt: (B,H,4,dh) pre-activations from W·x_t.

    state: (c, n, h, m) each (B,H,dh).
    """
    c, n, h, m = state
    rec = torch.einsum("bhd,hdge->bhge", h, p["wr"].to(h.dtype))
    pre = xt + rec + p["b"].to(h.dtype)[None]
    zt = torch.tanh(pre[:, :, 0].float())
    it = pre[:, :, 1].float()
    ft = F.logsigmoid(pre[:, :, 2].float() + 3.0)
    ot = torch.sigmoid(pre[:, :, 3].float())
    m_new = torch.maximum(ft + m, it)
    iprime = torch.exp(it - m_new)
    fprime = torch.exp(ft + m - m_new)
    c_new = fprime * c + iprime * zt
    n_new = fprime * n + iprime
    h_new = ot * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new.to(h.dtype), m_new), h_new


def _slstm_in(p, cfg: ModelConfig, x):
    """The normed input's gate pre-activations (B,S,H,4,dh) and the output
    gate z (B,S,d)."""
    hin = rms_norm(x, p["ln"], cfg.norm_eps)
    xw = torch.einsum("bsd,dhge->bshge", hin, p["wx"].to(x.dtype))
    return xw, hin @ p["wz_gate"].to(x.dtype)


def _slstm_out(p, cfg: ModelConfig, x, hs, z):
    """hs: (B,S,H,dh) float32 cell outputs -> residual output."""
    B, S, d = x.shape
    hs = hs.reshape(B, S, d).to(x.dtype)
    hs = rms_norm(hs, p["gn"], cfg.norm_eps) * F.silu(z)
    return x + hs @ p["w_down"].to(x.dtype)


def slstm_block(p, cfg: ModelConfig, x, state=None):
    """x: (B,S,d). Returns (x_out, state)."""
    B, S, d = x.shape
    H = cfg.mlstm_heads
    dh = d // H
    xw, z = _slstm_in(p, cfg, x)
    if state is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        zero = torch.zeros((B, H, dh), **f32)
        state = (zero, zero, torch.zeros((B, H, dh), dtype=x.dtype,
                                         device=x.device),
                 torch.full((B, H, dh), MMIN, **f32))
    # the cell's casts of the recurrent weights, once for every step
    pc = dict(p, wr=p["wr"].to(state[2].dtype), b=p["b"].to(state[2].dtype))
    hs = []
    for t in range(S):
        state, h = slstm_cell(pc, cfg, xw[:, t], state)
        hs.append(h)
    return _slstm_out(p, cfg, x, torch.stack(hs, dim=1), z), state


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def _embed(params, run: RunConfig, tokens) -> torch.Tensor:
    return params["embed"][tokens.long()].to(getattr(torch, run.compute_dtype))


def _unembed(params, cfg: ModelConfig, x) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].to(x.dtype).T
    return x @ params["lm_head"].to(x.dtype)


def forward_train(params, cfg: ModelConfig, run: RunConfig, batch):
    """batch: tokens (B, S). Returns (logits (B, S, V), aux loss 0)."""
    x = _embed(params, run, batch["tokens"])
    for i in range(cfg.n_layers):
        blk = slstm_block if is_slstm(cfg, i) else mlstm_block
        x, _ = blk(params["blocks"][i], cfg, x)
    return _unembed(params, cfg, x), torch.zeros((), device=x.device)


def train_loss(params, cfg: ModelConfig, run: RunConfig, batch):
    logits, _ = forward_train(params, cfg, run, batch)
    return softmax_xent(logits, batch["labels"], batch.get("loss_mask"))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cuda") -> List:
    """Recurrent state per layer (no KV pages — O(1) in seq length)."""
    di, H = _d_inner(cfg), cfg.mlstm_heads
    dh_m = di // H
    dh_s = cfg.d_model // H

    def mk(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    f32 = torch.float32
    cache = []
    for i in range(cfg.n_layers):
        if is_slstm(cfg, i):
            cache.append((mk((batch, H, dh_s), f32), mk((batch, H, dh_s), f32),
                          mk((batch, H, dh_s), dtype),
                          mk((batch, H, dh_s), f32)))
        else:
            cache.append((mk((batch, H, dh_m, dh_m), f32),
                          mk((batch, H, dh_m), f32), mk((batch, H), f32),
                          mk((batch, cfg.conv_width - 1, di), dtype)))
    return cache


def prefill(params, cfg: ModelConfig, run: RunConfig, cache, tokens,
            extra=None):
    """Process the prompt, returning last-token logits + recurrent states.

    The states are created fresh (O(1) in prompt length); ``cache`` is not
    read. Returns (logits (B, V), states, lengths (B,) int32).
    """
    del cache, extra
    B, S = tokens.shape
    x = _embed(params, run, tokens)
    new_cache = []
    for i in range(cfg.n_layers):
        blk = slstm_block if is_slstm(cfg, i) else mlstm_block
        x, st = blk(params["blocks"][i], cfg, x)
        new_cache.append(st)
    logits = _unembed(params, cfg, x[:, -1:])
    return (logits[:, 0], new_cache,
            torch.full((B,), S, dtype=torch.int32, device=x.device))


def decode_step(params, cfg: ModelConfig, run: RunConfig, cache, token, pos):
    """One token per sequence. token: (B,) int. Returns (logits (B, V),
    new states); ``cache`` is left as it was."""
    del pos
    x = _embed(params, run, token[:, None])
    new_cache = []
    for i in range(cfg.n_layers):
        p = params["blocks"][i]
        if is_slstm(cfg, i):
            xw, z = _slstm_in(p, cfg, x)
            st, h = slstm_cell(p, cfg, xw[:, 0], cache[i])
            x = _slstm_out(p, cfg, x, h[:, None], z)
        else:
            x, st = mlstm_block(p, cfg, x, cache[i])
        new_cache.append(st)
    return _unembed(params, cfg, x)[:, 0], new_cache
