"""Port's flash attention (plain version on the CPU) vs the JAX Pallas kernel
in interpret mode and its oracle, the port's plain attention functions vs
the JAX package's, and the wrapper's CPU routing, refusals and launch
arguments. Emulations of the two tensor-core kernels' arithmetic (bfloat16
and float16: csrc/flash_attention_sm90.cu; float32, 3xTF32:
csrc/flash_attention_f32_sm90.cu), their d > 256 tiling and the 2-byte
kernel's own loads are held against the Pallas kernel too; single-pass TF32
is shown to miss the float32 bar, and one float16 rounding of P to meet the
float16 bar. The CUDA kernels themselves are held against the plain version
on the card by chip_smoke.py."""
import ctypes
import functools
import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np
from hypothesis import given, settings, strategies as st

from repro.kernels.flash_attention.kernel import flash_attention as jax_kernel
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.models import common as jcommon
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import common
from tf32_split import mm3, tf32

# tests/test_kernels.py tolerances
F32_TOL = dict(atol=2e-5, rtol=2e-4)
BF16_TOL = dict(atol=2e-3, rtol=2e-2)
F16_TOL = dict(atol=1e-3, rtol=2e-3)    # float16: 11 significant bits
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL),
          "float16": (jnp.float16, torch.float16, F16_TOL)}
SWEEP = [  # tests/test_kernels.py::test_flash_attention_sweep
    (2, 4, 2, 128, 128, 64, True, 0, 0.0),
    (1, 8, 4, 256, 256, 32, True, 64, 0.0),     # sliding window
    (1, 2, 2, 128, 256, 64, False, 0, 50.0),    # softcap, cross len
    (2, 6, 1, 64, 128, 128, True, 0, 0.0),      # MQA
    (1, 4, 4, 192, 192, 16, True, 128, 30.0),   # window + softcap
]


def _qkv(seed, B, Hq, Hkv, Sq, Sk, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Hq, Sq, d).astype(np.float32),
            rng.randn(B, Hkv, Sk, d).astype(np.float32),
            rng.randn(B, Hkv, Sk, d).astype(np.float32))


def _port(x, tdt, fn=ops.flash_attention, **kw):
    q, k, v = (torch.from_numpy(a).to(tdt) for a in x)
    return fn(q, k, v, **kw).float().numpy()


def _jax(x, jdt, fn, **kw):
    out = fn(*(jnp.asarray(a, jdt) for a in x), **kw)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,d,causal,window,softcap", SWEEP)
def test_matches_pallas_kernel(B, Hq, Hkv, Sq, Sk, d, causal, window,
                               softcap, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x = _qkv(0, B, Hq, Hkv, Sq, Sk, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = _jax(x, jdt, jax_kernel, block_q=64, block_k=64, interpret=True,
                **kw)
    np.testing.assert_allclose(_port(x, tdt, **kw), want, **tol)


@settings(deadline=None, max_examples=6)
@given(st.integers(1, 2), st.integers(1, 3), st.integers(1, 3),
       st.sampled_from([32, 48]), st.booleans(),
       st.sampled_from([0, 1, 8, 40]), st.sampled_from([0.0, 20.0]),
       st.integers(0, 10_000))
def test_matches_jax_oracle_property(B, Hkv, g, S, causal, window, softcap,
                                     seed):
    x = _qkv(seed, B, Hkv * g, Hkv, S, S, 16)
    kw = dict(causal=causal, window=window, softcap=softcap)
    np.testing.assert_allclose(_port(x, torch.float32, **kw),
                               _jax(x, jnp.float32, jax_ref, **kw), **F32_TOL)


def test_strided_views_give_the_contiguous_result():
    """The model hands the kernel (B, S, H, d) -> (B, H, S, d) views."""
    x = _qkv(1, 2, 4, 2, 64, 64, 32)
    views = [torch.from_numpy(a).transpose(1, 2).contiguous().transpose(1, 2)
             for a in x]
    assert not views[0].is_contiguous()
    out = ops.flash_attention(*views, window=16)
    np.testing.assert_array_equal(out.numpy(),
                                  _port(x, torch.float32, window=16))


def test_cpu_tensors_take_the_plain_version_without_counting():
    x = _qkv(2, 1, 4, 2, 64, 64, 32)
    before = ops.flash_attention.launches
    for name in DTYPES:
        tdt = DTYPES[name][1]
        np.testing.assert_array_equal(_port(x, tdt),
                                      _port(x, tdt, fn=attention_ref))
    assert ops.flash_attention.launches == before


@pytest.mark.parametrize("bad", ["mixed_device", "dtype", "mixed_dtype",
                                 "group", "head_dim", "window", "layout"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 4, 2, 64, 64, 32))
    kw = {}
    if bad == "head_dim":
        # every head dim and every q length is taken: past 65,535 q tiles
        # (the grid's old y limit) the wrapper's checks pass and the
        # kernels' grid has more tiles; what is still refused is a device
        # with no kernel. Meta tensors: only the shape is read.
        for dtype, d, rows in ((torch.bfloat16, 1024, 128),
                               (torch.float16, 37, 128),
                               (torch.float32, 128, 128),
                               (torch.float32, 256, 64),
                               (torch.float32, 320, 128),
                               (torch.float32, 1280, 64)):
            assert ops.q_rows_per_block(dtype, d) == rows
            Sq = 65535 * rows + 1
            mq = torch.empty(1, 1, Sq, d, dtype=dtype, device="meta")
            mk = torch.empty(1, 1, 256, d, dtype=dtype, device="meta")
            ops._check(mq, mk, mk, 0)
            (gx, gy, gz), n_qt, n_sl = ops.flash_grid(dtype, 1, 1, Sq, d)
            assert n_qt == 65536 and gy <= ops.GRID_YZ and gz <= ops.GRID_YZ
            assert gy * gz >= n_qt * n_sl
            with pytest.raises(ValueError, match="no kernel for meta"):
                ops.flash_attention(mq, mk, mk)
        return
    if bad == "mixed_device":
        k = k.to("meta")
    elif bad == "dtype":      # float64 (float16 is taken, as the TPU's is)
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "mixed_dtype":
        v = v.to(torch.bfloat16)
    elif bad == "group":
        q = torch.zeros(1, 3, 64, 32)
    elif bad == "window":
        kw = dict(window=-1)
    else:
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((TypeError, ValueError)):
        ops.flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_head_dim_320_matches_pallas_kernel(dtype):
    """d = 320, which the Pallas kernel computes and only the card's
    kernels refuse: the CPU wrapper against the Pallas kernel."""
    jdt, tdt, tol = DTYPES[dtype]
    x = _qkv(4, 1, 4, 2, 128, 128, 320)
    want = _jax(x, jdt, jax_kernel, block_q=64, block_k=64, interpret=True,
                causal=True)
    np.testing.assert_allclose(_port(x, tdt, causal=True), want, **tol)


# --- the 2-byte tensor-core kernel: its arithmetic, tiling, loads, route ----

def _chunked_qk(q, kt, mm, route):
    """S = Q.K^T as the 2-byte kernel sums it on ``route``
    (``ops.sm90_route``): "plain" one product; "stream" summed over
    64-column chunks of d, in order, as that route streams them; "cluster"
    each CTA's partial over its 256-column slice (its 64-column chunks in
    order), the partials summed in rank order, as every CTA sums them."""
    def chunks(lo, hi):
        s = mm(q[..., lo:lo + 64], kt[..., lo:lo + 64].transpose(-1, -2))
        for c in range(lo + 64, hi, 64):
            s = s + mm(q[..., c:c + 64], kt[..., c:c + 64].transpose(-1, -2))
        return s
    d = q.shape[-1]
    if route == "plain":
        return mm(q, kt.transpose(-1, -2))
    if route == "stream":
        return chunks(0, d)
    cols = ops.SLICE_COLS
    s = chunks(0, min(d, cols))
    for c0 in range(cols, d, cols):
        s = s + chunks(c0, min(d, c0 + cols))
    return s


def _sm90_emulate(q, k, v, *, causal=True, window=0, softcap=0.0,
                  parts=None):
    """csrc/flash_attention_sm90.cu's arithmetic in plain PyTorch: 2-byte
    q.k^T summed in f32 (past d = 256 as ``_chunked_qk`` sums it on the
    route ``ops.sm90_route`` takes: the output's 256-column slices change
    no other arithmetic), then scaled; key tiles
    of 128 (64 at d > 128); a float32 online softmax from -1e30; P.V as
    two bf16 products for bfloat16, P_hi = bf16(p) and P_lo = bf16(p -
    P_hi), and one product of P = f16(p) for float16 (``parts`` overrides
    the number); l summed from the f32 p; out in q's type."""
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    parts = parts or (2 if q.dtype == torch.bfloat16 else 1)
    kf = k.float().repeat_interleave(Hq // Hkv, dim=1)
    vf = v.float().repeat_interleave(Hq // Hkv, dim=1)
    block_k = 128 if d <= 128 else 64
    q_pos = torch.arange(Sq)[:, None]
    m = torch.full((B, Hq, Sq, 1), -1e30)
    l = torch.zeros((B, Hq, Sq, 1))
    acc = torch.zeros((B, Hq, Sq, d))
    for k0 in range(0, Sk, block_k):
        kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        s = _chunked_qk(q.float(), kt, torch.matmul,
                        ops.sm90_route(d)) / math.sqrt(d)
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        k_pos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        mask = torch.ones((Sq, kt.shape[2]), dtype=torch.bool)
        if causal:
            mask &= q_pos >= k_pos
        if window:
            mask &= (q_pos - k_pos) < window
        s = torch.where(mask, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        p_hi = p.to(q.dtype).float()
        pv = p_hi @ vt
        if parts == 2:
            pv = pv + (p - p_hi).to(q.dtype).float() @ vt
        acc = acc * corr + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


SM90_CASES = SWEEP + [
    (2, 8, 4, 512, 512, 256, True, 0, 50.0),    # gemma2's widths
    (1, 2, 2, 1024, 1024, 128, True, 0, 0.0),   # several 128-key tiles
]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,d,causal,window,softcap",
                         SM90_CASES)
def test_sm90_arithmetic_matches_pallas_kernel(B, Hq, Hkv, Sq, Sk, d, causal,
                                               window, softcap):
    """Split-P bf16 products stay within the bf16 tolerance of the Pallas
    kernel, elementwise."""
    x = _qkv(0, B, Hq, Hkv, Sq, Sk, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    block = 64 if Sq <= 256 else 128
    want = _jax(x, jnp.bfloat16, jax_kernel, block_q=block, block_k=block,
                interpret=True, **kw)
    got = _port(x, torch.bfloat16, fn=_sm90_emulate, **kw)
    np.testing.assert_allclose(got, want, **BF16_TOL)


def _pallas(x, dtype, **kw):
    """The Pallas kernel in interpret mode at blocks that divide Sq and Sk."""
    Sq = x[0].shape[2]
    block = 64 if Sq <= 256 and Sq % 64 == 0 else 128 if Sq % 128 == 0 \
        else Sq
    return _jax(x, DTYPES[dtype][0], jax_kernel, block_q=block,
                block_k=block, interpret=True, **kw)


SM90_F16_CASES = SM90_CASES + [
    (1, 4, 2, 130, 70, 37, True, 0, 0.0),       # own loads, ragged d
    (1, 4, 2, 200, 200, 40, True, 70, 0.0),
    (1, 4, 2, 256, 256, 72, True, 0, 30.0),     # SigLIP-so400m's head dim
]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,d,causal,window,softcap",
                         SM90_F16_CASES)
def test_sm90_f16_arithmetic_matches_pallas_kernel(B, Hq, Hkv, Sq, Sk, d,
                                                   causal, window, softcap):
    """float16: one product of P = f16(p) stays within the float16 bar of
    the Pallas kernel at float16, elementwise."""
    x = _qkv(0, B, Hq, Hkv, Sq, Sk, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = _port(x, torch.float16, fn=_sm90_emulate, **kw)
    np.testing.assert_allclose(got, _pallas(x, "float16", **kw), **F16_TOL)


def test_sm90_f16_takes_p_in_one_product():
    """Why float16 skips bfloat16's P_hi/P_lo split: on the sweep, gemma2's
    widths and S = 1024, one rounding of P stays within 0.4 of the float16
    bar of the Pallas kernel, about where the split stays."""
    worst = {1: 0.0, 2: 0.0}
    for B, Hq, Hkv, Sq, Sk, d, causal, window, softcap in SM90_CASES:
        x = _qkv(0, B, Hq, Hkv, Sq, Sk, d)
        kw = dict(causal=causal, window=window, softcap=softcap)
        want = _pallas(x, "float16", **kw)
        bar = F16_TOL["atol"] + F16_TOL["rtol"] * np.abs(want)
        for parts in worst:
            got = _port(x, torch.float16, fn=_sm90_emulate, parts=parts, **kw)
            worst[parts] = max(worst[parts], float((np.abs(got - want)
                                                    / bar).max()))
    assert worst[1] < 0.4 and worst[2] < 0.4


WIDE_CASES = [  # d > 256: S summed over slices of d, 256-column slices of O
    (1, 4, 2, 128, 128, 288, True, 0, 0.0),
    (1, 2, 2, 128, 192, 320, False, 0, 50.0),
    (1, 2, 1, 192, 192, 512, True, 64, 0.0),
]
# the 2-byte route past one cluster's reach (d > 4096): S streamed in
# 64-column chunks for every output slice
SM90_STREAM_CASES = [(1, 2, 1, 128, 128, 4100, True, 0, 0.0)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,d,causal,window,softcap",
                         WIDE_CASES + SM90_STREAM_CASES)
def test_sm90_wide_tiling_matches_pallas_kernel(B, Hq, Hkv, Sq, Sk, d,
                                                causal, window, softcap,
                                                dtype):
    x = _qkv(1, B, Hq, Hkv, Sq, Sk, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = _port(x, DTYPES[dtype][1], fn=_sm90_emulate, **kw)
    np.testing.assert_allclose(got, _pallas(x, dtype, **kw),
                               **DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("d,causal,softcap", [(1280, True, 0.0),
                                              (2304, False, 30.0)])
def test_wide_head_dims_match_pallas_kernel(d, causal, softcap, dtype):
    """d = 1280 and 2304 (chip_smoke.py's FLASH_SHAPES widths; the 2-byte
    cluster route in 5 and 9 CTAs) at small S: the plain version (the
    wrapper on CPU tensors) and the 2-byte kernel's arithmetic, S summed
    once over the CTAs' slices in rank order, against the Pallas kernel in
    interpret mode."""
    jdt, tdt, tol = DTYPES[dtype]
    x = _qkv(13, 1, 2, 1, 128, 128, d)
    kw = dict(causal=causal, softcap=softcap)
    want = _pallas(x, dtype, **kw)
    assert ops.sm90_wide_plan(d)["cluster"] == -(-d // 256)
    np.testing.assert_allclose(_port(x, tdt, **kw), want, **tol)
    np.testing.assert_allclose(_port(x, tdt, fn=_sm90_emulate, **kw), want,
                               **tol)


@pytest.mark.parametrize("d", [512, 1280, 2304, 4096])
def test_sm90_cluster_scores_are_the_same_bits_in_every_cta(d):
    """On the 2-byte cluster route every CTA sums the n partial S (each
    over its own 256 columns) in rank order 0, 1, ..., n - 1, so every CTA
    holds the same bits of S, m, l and P: held here on 2-byte inputs with
    f32 products, against the order a CTA starting from its own partial
    would take, which differs in some bits past two partials; the source
    sums from rank 0 for every CTA."""
    q, k, _ = (torch.from_numpy(a).bfloat16().float()
               for a in _qkv(14, 1, 1, 1, 128, 64, d))
    parts, n_sl, n, nslp = _cluster_partials(
        q, k, torch.matmul, ops.SLICE_COLS, ops.SM90_CLUSTER_MAX)
    assert n == n_sl == nslp == ops.sm90_wide_plan(d)["cluster"]
    every = _cluster_scores(parts, nslp)
    assert all(torch.equal(s, every[0]) for s in every)
    if n > 2:
        rotated = _cluster_scores(parts, nslp, rotated=True)
        assert any(not torch.equal(s, every[0]) for s in rotated[1:])
    src = (Path(ops.__file__).parents[2] / "csrc"
           / "flash_attention_sm90.cu").read_text()
    assert "for (int r = 0; r < n; ++r) {" in src
    assert "sc[4 * u + c] = r == 0 ? x[c] : sc[4 * u + c] + x[c];" in src


def _own_box(mem, start, rs, rows, n, lim, unit, box=None, span=None,
             whole=False):
    """csrc/flash_attention_sm90.cu's own loads in numpy: a box of ``rows``
    rows x 64 columns laid out as TMA's 128-byte swizzle lays it out, from
    the flat bytes ``mem`` (index = address), the box's first element at
    byte ``start``, rows ``rs`` bytes apart, ``n`` rows that exist, ``lim``
    bytes of a row before d; zeros elsewhere, on every fill. Every unit
    (8, 4 or 2 bytes) the same way (``own_fill_realign``): half a row (64
    bytes) at a time, the aligned 16-byte words holding its live bytes
    read at once (only those: each must hold a byte of ``span``, the
    tensor's bytes; ``load_half``), funnel-shifted by the start's offset
    into four 16-byte units, bytes past the live ones zeroed (lane off / 4
    moved to the front in place, then each out lane from lanes m and m +
    1; ``store_half``); or, ``whole`` (``own_rows_whole``, where the live
    bytes fit 10 words), a row's words read once and each half's out lane
    m taken from lanes 16 h + m + off / 4 and the next. ``box``: the
    buffer it fills (a new one, of bytes no fill may leave, if None)."""
    box = np.full(rows * 128, 0xAB, np.uint8) if box is None else box
    swz = lambda r, b: r * 128 + ((((b >> 4) ^ (r & 7)) << 4) | (b & 15))
    if whole:
        for r in range(rows):
            p = start + r * rs
            off, every = p & 15, max(0, min(lim, 128)) if r < n else 0
            nw = (off + every + 15) >> 4 if every > 0 else 0
            assert nw <= 10
            words = np.zeros(160, np.uint8)
            for j in range(nw):
                a = p - off + 16 * j
                assert span[0] < a + 16 and a < span[1], "a word off the tensor"
                words[16 * j:16 * j + 16] = mem[a:a + 16]
            L = np.concatenate([words.view(np.uint32).astype(np.uint64),
                                np.zeros(8, np.uint64)])
            q, sh = off >> 2, (off & 3) * 8
            for h in range(2):
                live = max(0, min(every - 64 * h, 64))
                for m in range(16):
                    i = 16 * h + m + q
                    x = int(((L[i + 1] << 32 | L[i]) >> sh) & 0xffffffff)
                    x = 0 if 4 * m >= live else \
                        x & 0xffff if 4 * m + 2 == live else x
                    u, b = 4 * h + m // 4, 4 * (m % 4)
                    box[swz(r, 16 * u) + b:swz(r, 16 * u) + b + 4] = \
                        np.array([x], np.uint32).view(np.uint8)
        return box
    for r in range(rows):
        for h in range(2):
            live = max(0, min(lim - 64 * h, 64)) if r < n else 0
            p = start + r * rs + 64 * h
            off = p & 15
            nw = (off + live + 15) >> 4 if live > 0 else 0
            words = np.zeros(80, np.uint8)
            for j in range(nw):
                a = p - off + 16 * j
                assert span[0] < a + 16 and a < span[1], "a word off the tensor"
                words[16 * j:16 * j + 16] = mem[a:a + 16]
            L = words.view(np.uint32).astype(np.uint64)
            q, sh = off >> 2, (off & 3) * 8
            for i in range(17):                 # lane q to the front
                L[i] = L[i + q]
            o = [int(((L[m + 1] << 32 | L[m]) >> sh) & 0xffffffff)
                 for m in range(16)]
            o = [0 if 4 * m >= live else
                 o[m] & 0xffff if 4 * m + 2 == live else o[m]
                 for m in range(16)]
            out = np.array(o, np.uint32).view(np.uint8)
            for j in range(4):
                u = 4 * h + j
                box[swz(r, 16 * u):swz(r, 16 * u) + 16] = \
                    out[16 * j:16 * j + 16]
    return box


def _unswizzle(box, rows):
    """The (rows, 64) 2-byte tile a 128-byte-swizzled box holds."""
    out = np.empty((rows, 128), np.uint8)
    for r in range(rows):
        for u in range(8):
            src = r * 128 + ((u ^ (r & 7)) << 4)
            out[r, 16 * u:16 * u + 16] = box[src:src + 16]
    return out.view(np.uint16)


# (d, unit, whole): every unit a row of d elements allows, half a row at a
# time and, where d's rows fit 10 words (d <= 73), whole rows; the rows of each test are d + 1 (2), d + 2 (4) or d + 4
# (8) elements, the base 2, 4 or 8 bytes past a 16-byte boundary
OWN_LOADS = [(d, u, whole) for d in (37, 40, 72, 100, 330)
             for u in (2, 4, 8) if (2 * d) % u == 0
             for whole in ((False, True) if d <= 73 else (False,))]


@pytest.mark.parametrize("d,unit,whole", OWN_LOADS)
def test_own_loads_fill_the_box_tma_would_fill(d, unit, whole):
    """The producer warpgroup's own loads give what TMA gives: the tile's
    elements before d, zeros past d (the padding to 64 columns) and past
    the last row, each 16-byte unit where the swizzle puts it, on a stage's
    first fill and on a later one over it (nothing of the first is left);
    the realigned loads read only words that hold a byte of the tensor; the
    kernel source holds the same swizzle and loaders."""
    stride, base = d + {2: 1, 4: 2, 8: 4}[unit], unit
    rows_n = 70
    slab = np.random.RandomState(d).randint(1, 2 ** 16, (rows_n, stride)) \
        .astype(np.uint16)
    mem = np.zeros(base + slab.nbytes + 64, np.uint8)
    mem[base:base + slab.nbytes] = slab.view(np.uint8).ravel()
    span = (base, base + slab.nbytes)

    def tma(r0, c0, rows):
        want = np.zeros((rows, 64), np.uint16)
        live = slab[r0:r0 + rows, c0:max(c0, min(d, c0 + 64))]
        want[:live.shape[0], :live.shape[1]] = live
        return want

    for c0 in range(0, -(-d // 64) * 64 + 64, 64):
        lim = 2 * (d - c0)
        for rows in (64, 128):
            fill = lambda r0, box=None: _own_box(  # noqa: E731
                mem, base + 2 * (r0 * stride + c0), 2 * stride, rows,
                rows_n - r0, lim, unit, box, span, whole)
            box = fill(0)
            np.testing.assert_array_equal(_unswizzle(box, rows),
                                          tma(0, c0, rows))
            box = fill(rows_n - 37, box)    # rows past the last
            np.testing.assert_array_equal(_unswizzle(box, rows),
                                          tma(rows_n - 37, c0, rows))
    src = (Path(ops.__file__).parents[2] / "csrc"
           / "flash_attention_sm90.cu").read_text()
    # store_half's and own_rows_whole's 16-byte stores into the swizzle
    assert src.count("st_shared4(row + ((u ^ (r & 7)) << 4), o[0], o[1], "
                     "o[2], o[3]);") == 2
    assert "__funnelshift_r(L[m], L[m + 1], sh)" in src
    assert "cp.async.ca" not in src     # one loader for every unit
    assert "if (j < nw) x = __ldg(w + j);" in src
    assert "own_fill_realign<C::kPair>(" in src
    assert "__funnelshift_r(lane_q(L, i, q), lane_q(L, i + 1, q), sh);" in src
    assert "min(2 * a.d, C::NC * kChunkBytes) <= 146" in src


def _strided(d, pad, off=0, dtype=torch.float16):
    """q, k, v as (B, S, H, d) -> (B, H, S, d) views of rows of d + pad
    elements, ``off`` elements past an aligned base."""
    flat = torch.zeros(off + 3 * 2 * 64 * 2 * (d + pad), dtype=dtype)[off:]
    return [t.view(2, 64, 2, d + pad)[..., :d].transpose(1, 2)
            for t in flat.chunk(3)]


@pytest.mark.parametrize("case,unit", [
    ("d37", 2), ("d40", 16), ("d72", 16), ("d100", 8), ("d24", 16),
    ("d64_2_bytes_off", 2), ("d64_4_bytes_off", 4), ("d64_8_bytes_off", 8),
    ("d64_rows_of_66", 4), ("float32_4_bytes_off", 4), ("float32", 16)])
def test_sm90_unit_is_tma_or_the_widest_own_load(case, unit):
    """How the kernels read q, k and v (``ops._sm90_unit``): TMA (16)
    where its rule holds for all three, else the widest own-load unit
    every base, stride and row allows; the float32 route copies k and v
    16 bytes at a time where they allow it."""
    if case.startswith("float32"):
        qkv = _strided(64, 0, 1 if "off" in case else 0, torch.float32)
    elif case.startswith("d64_") and "off" in case:
        qkv = _strided(64, 0, int(case.split("_")[1]) // 2)
    elif case == "d64_rows_of_66":
        qkv = _strided(64, 2)
    else:
        qkv = [torch.zeros(1, 2, 64, int(case[1:]), dtype=torch.float16)
               for _ in range(3)]
    assert ops._sm90_unit(*qkv) == unit
    if not case.startswith("float32"):
        assert ops._sm90_layout_ok(qkv[0]) == (unit == 16)


@pytest.mark.parametrize("n_qt,n_sl", [(1, 1), (5, 1), (4, 2), (7, 3),
                                       (65535, 1), (65537, 1), (3, 65536),
                                       (65537, 3), (200000, 2)])
def test_flash_block_is_a_bijection_onto_tiles_and_slices(n_qt, n_sl):
    """``flash_block`` (the kernels' decode of the grid) maps the blocks of
    ``flash_grid``'s y and z one to one onto (q tile, slice), the blocks
    past the end (the grid's rounding) to None, with the heaviest (last) q
    tile first; x is the batch x head. Without a cluster the slice is the
    slow index (a (n_qt, n_sl) grid's order); in clusters of c = min(n_sl,
    8) (the float32 route past d = 256, n_sl padded to a multiple of c) or
    of c = n_sl <= 16 (the 2-byte route's, ``sm90_wide_plan``) it
    is the fast one, y's extent is a multiple of c, so the cluster dims (1,
    c, 1) divide the grid, and a cluster's CTAs (c consecutive y) are
    consecutive slices of one q tile, each CTA's rank its slice % c. Past
    65,535 tiles (the old limit) the blocks at both ends and a sample
    between are checked, without computing any attention."""
    for c in sorted({1, min(n_sl, ops.CLUSTER_MAX),
                     n_sl if n_sl <= ops.SM90_CLUSTER_MAX else 1}):
        nsl = -(-n_sl // c) * c
        n = n_qt * nsl
        ny = n if n <= ops.GRID_YZ else ops.GRID_YZ - ops.GRID_YZ % c
        nz = -(-n // ny)
        assert ny <= ops.GRID_YZ and nz <= ops.GRID_YZ and ny * nz >= n
        assert ny % c == 0
        idx = (range(ny * nz) if ny * nz <= 4096 else
               [*range(2048), *range(ny * nz - 2048, ny * nz),
                *np.random.RandomState(n % 97).randint(0, ny * nz, 2048)
                .tolist()])
        seen = set()
        for i in idx:
            got = ops.flash_block(3, i % ny, i // ny, ny, n_qt, nsl, c)
            if i >= n:
                assert got is None
                continue
            want = ((3, n_qt - 1 - i % n_qt, i // n_qt) if c == 1 else
                    (3, n_qt - 1 - i // nsl, i % nsl))
            assert got == want
            seen.add(got)
        assert len(seen) == len({i for i in idx if i < n})
        if ny * nz <= 4096:
            assert len(seen) == n
        assert ops.flash_block(0, 0, 0, ny, n_qt, nsl, c) == (0, n_qt - 1, 0)
        last = n - 1
        assert ops.flash_block(0, last % ny, last // ny, ny, n_qt, nsl,
                               c) == (0, 0, nsl - 1)
        if c > 1:          # a cluster: whole, one q tile, ranks 0..c-1
            for i in [i - i % c for i in idx][:256]:
                y, z = i % ny, i // ny
                members = [ops.flash_block(0, y + r, z, ny, n_qt, nsl, c)
                           for r in range(c)]
                if members[0] is None:
                    assert all(m is None for m in members)
                    continue
                assert {m[1] for m in members} == {members[0][1]}
                assert [m[2] % c for m in members] == list(range(c))


def _f32_cta_bytes(D):
    """The float32 source's ``Cfg<D>::kSmem`` and ``Wide<D>``'s partial
    bytes and rule: (CTA bytes, one partial's bytes, two partial buffers
    fit beside the CTA's tiles in the 227 KiB a block may hold)."""
    wg = 2 if D <= 128 else 1
    nt, bq, bk = 128 * wg, 64 * wg, 32 if D <= 128 else 16
    q_bytes, k_bytes = bq * D * 4, bk * D * 4
    smem = (1 if D <= 128 else 2) * q_bytes + 6 * k_bytes + 1024
    part = nt * (bk // 2) * 4
    return smem, part, smem + 2 * part <= 227 * 1024


@pytest.mark.parametrize("cols,two", [(128, True), (256, False)])
def test_f32_cluster_partials_double_buffered_where_they_fit(cols, two):
    """The float32 cluster route keeps its partial S in two buffers of its
    own by tile parity, with one cluster barrier a tile, where they fit
    (slices of 128: 161 + 32 KiB); slices of 256 (225 KiB) keep it in K's
    hi tile, one partial's bytes at most, with two barriers a tile (the
    source's ``Wide``)."""
    from repro_torch.kernels import _build
    smem, part, fits = _f32_cta_bytes(cols)
    assert fits == two
    assert part <= (32 if cols == 128 else 16) * cols * 4   # K's hi tile
    assert smem + (2 * part if fits else 0) <= 227 * 1024
    f32 = (_build.CSRC / f"{ops.SOURCES[torch.float32]}.cu").read_text()
    assert ("static constexpr bool kTwoParts = C::kSmem + 2 * kPart <= "
            "227 * 1024;") in f32
    assert "constexpr int bytes = Wide<D>::kSmem;" in f32


def test_grid_and_slices_follow_the_kernel_sources():
    """The wrapper's grid (``flash_grid``, ``SLICE_COLS``, ``GRID_YZ``) is
    what both sources launch (their ``grid_of``): x = B Hq, the (q tile,
    slice) indices over y and z, q tiles of 128 rows (64 on the float32
    route at 128 < d <= 256); on the 2-byte route slices of 256 columns
    past d = 256, one cluster of up to ``SM90_CLUSTER_MAX`` CTAs along y
    (``sm90_wide_plan``, the source's ``route_of``; past that reach no
    cluster); on the float32 route past d = 256 slices of
    ``F32_WIDE_COLS`` columns, or twice as wide where only then
    ``CLUSTER_MAX`` of them cover d (``f32_wide_cols``, the source's
    ``wide_cols``), in
    clusters of up to ``CLUSTER_MAX`` CTAs along y (``f32_wide_plan``, the
    source's ``wide_plan``)."""
    from repro_torch.kernels import _build
    for name in set(ops.SOURCES.values()):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert "blockIdx.y + gridDim.y * blockIdx.z" in src
        assert "n_qt <= 65535 &&" not in src         # the old refusal
    two = (_build.CSRC / f"{ops.SOURCES[torch.bfloat16]}.cu").read_text()
    assert f"constexpr int kSlice = {ops.SLICE_COLS};" in two
    assert f"n_lin < {ops.GRID_YZ} ? n_lin : {ops.GRID_YZ}" in two
    f32 = (_build.CSRC / f"{ops.SOURCES[torch.float32]}.cu").read_text()
    assert f"constexpr int kWideCols = {ops.F32_WIDE_COLS};" in f32
    assert f"constexpr int kMaxCluster = {ops.CLUSTER_MAX};" in f32
    assert (f"n_lin < {ops.GRID_YZ} ? n_lin : {ops.GRID_YZ} - "
            f"{ops.GRID_YZ} % step") in f32
    assert "cudaLaunchAttributeClusterDimension" in f32
    assert ops.flash_grid(torch.bfloat16, 2, 20, 4096, 128) == (
        (40, 32, 1), 32, 1)
    assert ops.flash_grid(torch.bfloat16, 1, 8, 2048, 512) == (
        (8, 32, 1), 16, 2)
    assert ops.flash_grid(torch.float32, 1, 8, 2048, 512) == (
        (8, 64, 1), 16, 4)
    assert [ops.f32_wide_cols(d) for d in (257, 1024, 1025, 2048, 2049)] \
        == [128, 128, 256, 256, 128]
    assert ops.f32_wide_plan(512) == (4, 4, 4)
    assert ops.f32_wide_plan(1280) == (5, 5, 5)
    assert ops.f32_wide_plan(1280, 128) == (10, 8, 16)
    assert ops.f32_wide_plan(2304) == (18, 8, 24)
    assert ops.flash_cluster(torch.float32, 512) == 4
    assert ops.flash_cluster(torch.float32, 256) == 1
    assert ops.flash_cluster(torch.bfloat16, 512) == 2
    assert ops.flash_cluster(torch.float16, 2304) == 9
    assert ops.flash_cluster(torch.bfloat16, 256) == 1
    assert ops.flash_cluster(torch.bfloat16, 4097) == 1
    assert f"constexpr int kMaxCluster = {ops.SM90_CLUSTER_MAX};" in two
    assert (f"n_lin < {ops.GRID_YZ} ? n_lin : {ops.GRID_YZ} - "
            f"{ops.GRID_YZ} % step") in two
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in two
    # past 65,535 (tile, slice) indices y is a whole number of clusters
    assert ops.flash_grid(torch.bfloat16, 1, 1, 128 * 20000, 1280) == (
        (1, 65535, 2), 20000, 5)
    assert ops.flash_grid(torch.float16, 1, 1, 128 * 20000, 2304) == (
        (1, 65529, 3), 20000, 9)
    assert ops.flash_grid(torch.float16, 1, 1, 8388736, 64) == (
        (1, 65535, 2), 65537, 1)
    assert ops.flash_grid(torch.float32, 1, 1, 4194368, 256) == (
        (1, 65535, 2), 65537, 1)
    # past 65,535 (tile, slice) indices y is a whole number of clusters
    assert ops.flash_grid(torch.float32, 1, 1, 64 * 20000, 1280) == (
        (1, 65535, 2), 20000, 5)
    assert ops.flash_grid(torch.float32, 1, 1, 128 * 20000, 2304) == (
        (1, 65528, 8), 20000, 24)
    assert ops.flash_grid(torch.float32, 1, 1, 128 * 20000, 1000) == (
        (1, 65528, 3), 20000, 8)


@pytest.mark.parametrize("d,route,cluster", [
    (256, "plain", 1), (257, "cluster", 2), (512, "cluster", 2),
    (1280, "cluster", 5), (2304, "cluster", 9), (4096, "cluster", 16),
    (4097, "stream", 1), (8192, "stream", 1)])
def test_sm90_wide_plan_follows_the_kernel_source(d, route, cluster):
    """The 2-byte route past d = 256 (``sm90_wide_plan``): 256 columns a
    CTA (``SLICE_COLS``), one cluster of a CTA a slice up to
    ``SM90_CLUSTER_MAX`` slices, so S is computed once per q tile (no
    group, no padding); past that the streaming route (no cluster), as the
    source's ``route_of`` chooses; the grid then holds whole clusters of
    consecutive y, each the slices of one q tile."""
    from repro_torch.kernels import _build
    assert ops.sm90_route(d) == route
    assert ops.flash_cluster(torch.bfloat16, d) == cluster
    if d > 256:
        plan = ops.sm90_wide_plan(d)
        assert plan == {"route": route, "cols": 256, "slices": -(-d // 256),
                        "cluster": cluster}
        if route == "cluster":
            assert plan["slices"] == cluster <= ops.SM90_CLUSTER_MAX
        (gx, gy, gz), n_qt, n_sl = ops.flash_grid(torch.bfloat16, 1, 3, 1000,
                                                  d)
        assert (gx, n_qt, n_sl) == (3, 8, plan["slices"])
        assert gy % cluster == 0 and gy * gz >= n_qt * n_sl
        for y in range(0, gy, cluster):
            blocks = [ops.flash_block(0, y + r, 0, gy, n_qt, n_sl, cluster)
                      for r in range(cluster)]
            if cluster > 1:
                assert {b[1] for b in blocks} == {blocks[0][1]}
                assert [b[2] for b in blocks] == list(range(cluster))
    src = (_build.CSRC / f"{ops.SOURCES[torch.bfloat16]}.cu").read_text()
    assert ("return d <= kSlice ? kPlain : d <= kSlice * kMaxCluster ? "
            "kCluster : kStream;") in src
    assert f"constexpr int kSlice = {ops.SLICE_COLS};" in src


def test_launch_arguments_follow_the_c_entries(monkeypatch):
    """Both C entries take (q, k, v, out, strides, B, Hq, Hkv, Sq, Sk, d,
    causal, window, scale, softcap, dtype, unit, device, stream); the
    wrapper's arguments fill them in that order (dtype 0 float32, 1
    bfloat16, 2 float16; unit from ``_sm90_unit``)."""
    class Lib:
        pass
    lib = Lib()
    for name in set(ops.SOURCES.values()):
        setattr(lib, f"{name}_launch", Lib())
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "load", lambda name: lib)
    ops._launcher.cache_clear()
    try:
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1),
                            (torch.float16, 2)):
            fn = ops._launcher(dtype)
            assert len(fn.argtypes) == 19 and fn.restype is ctypes.c_int
            assert fn.argtypes[:5] == [ctypes.c_void_p] * 5
            assert fn.argtypes[13:15] == [ctypes.c_float] * 2
            assert fn.argtypes[15:18] == [ctypes.c_int] * 3
            q, k, v = _strided(37, 1, 1, dtype)
            out = torch.empty_like(q)
            strides, args = ops._launch_args(q, k, v, out, causal=False,
                                             window=5, softcap=30.0)
            assert len(args) + 2 == len(fn.argtypes)
            assert list(strides) == [s for t in (q, k, v, out)
                                     for s in t.stride()[:3]]
            assert args[5:13] == (2, 2, 2, 64, 64, 37, 0, 5)
            assert args[13] == pytest.approx(37 ** -0.5)
            assert args[14:] == (30.0, code, ops._sm90_unit(q, k, v))
    finally:
        ops._launcher.cache_clear()
    for name in set(ops.SOURCES.values()):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert re.search(r"float softcap,\s+int dtype,\s+int unit,\s+"
                         r"int device,\s+void\* stream\)", src)


# the float32 kernel's tiles (q rows, keys) by head_dim: its Cfg<D>; past
# d = 256 the CTA's at its slice width (Cfg<128> at 128 columns)
F32_TILES = {True: (128, 32), False: (64, 16)}      # d <= 128, d > 128
F32_WIDE_TILES = {128: (128, 32), 256: (64, 16)}


def _cluster_partials(qt, kt, mm, cols, cluster):
    """The wide route's partial S of each CTA of a cluster: d in slices of
    ``cols`` columns, CTA r of a cluster of n = min(slices, ``cluster``)
    summing its slices r, r + n, ... in that order (past one cluster each
    group's CTA r takes the same ones). Returns (partials by rank, slices,
    n, slices with the last group's padding)."""
    d = qt.shape[-1]
    n_sl, n, nslp = ops.f32_wide_plan(d, cols, cluster)
    parts = []
    for r in range(n):
        p = None
        for j in range(r, n_sl, n):
            c = slice(j * cols, (j + 1) * cols)
            t = mm(qt[..., c], kt[..., c].transpose(-1, -2))
            p = t if p is None else p + t
        parts.append(p)
    return parts, n_sl, n, nslp


def _cluster_scores(parts, nslp, rotated=False):
    """The scores each CTA of a cluster (by slice, padding included) holds
    after the exchange: the partials summed in rank order 0, 1, ..., n - 1
    (``rotated``: from its own rank on, the order the kernel must not
    take)."""
    n = len(parts)
    out = []
    for sl in range(nslp):
        order = ([(sl % n + i) % n for i in range(n)] if rotated
                 else range(n))
        s = None
        for r in order:
            s = parts[r].clone() if s is None else s + parts[r]
        out.append(s)
    return out


def _f32_sm90_emulate(q, k, v, *, causal=True, window=0, softcap=0.0,
                      terms=3, cols=None, cluster=ops.CLUSTER_MAX):
    """csrc/flash_attention_f32_sm90.cu's arithmetic in plain PyTorch: q
    tiles of 128 rows (64 at d > 128), each visiting the key tiles of 32
    (16) its band reaches; S = Q.K^T and O += P.V as 3xTF32 products of
    operands split once; scores in log2 units (masked -1e30, keys past Sk
    -inf); a float32 online softmax from -1e30 with exp2; out = acc /
    max(l, 1e-30). Past d = 256 (or at any d where ``cols`` is given, so
    that a small d takes several slices) the wide route: the tiles of the
    CTA at ``cols`` columns (``ops.f32_wide_cols``), each CTA's partial S
    over its slices (``_cluster_partials``), summed in rank order in every
    CTA (``_cluster_scores``; the test asserts the same bits in every
    slice), so its slices of O change no other arithmetic."""
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    wide = cols is not None or d > 256
    cols = cols or ops.f32_wide_cols(d)
    block_q, block_k = (F32_WIDE_TILES[max(cols, 128)] if wide
                        else F32_TILES[d <= 128])
    # terms=1 keeps hi.hi alone (single-pass TF32)
    mm = mm3 if terms == 3 else (lambda x, y: tf32(x) @ tf32(y))
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    out = torch.zeros((B, Hq, Sq, d))
    for q0 in range(0, Sq, block_q):
        qt = q.float()[:, :, q0:q0 + block_q]
        q_pos = torch.arange(q0, q0 + qt.shape[2])[:, None]
        k_end = min(Sk, q0 + qt.shape[2]) if causal else Sk
        k_first = (max(0, q0 - window + 1) if window else 0) \
            // block_k * block_k
        m = torch.full((B, Hq, qt.shape[2], 1), -1e30)
        l = torch.zeros((B, Hq, qt.shape[2], 1))
        acc = torch.zeros((B, Hq, qt.shape[2], d))
        for k0 in range(k_first, k_end, block_k):
            kt = kf[:, :, k0:k0 + block_k]
            vt = vf[:, :, k0:k0 + block_k]
            if wide:
                parts, _, _, nslp = _cluster_partials(qt, kt, mm, cols,
                                                      cluster)
                every = _cluster_scores(parts, nslp)
                assert all(torch.equal(x, every[0]) for x in every)
                s = every[0]
            else:
                s = mm(qt, kt.transpose(-1, -2))
            if softcap:
                s = (softcap * log2e) * torch.tanh(s * (scale / softcap))
            else:
                s = s * (scale * log2e)
            k_pos = torch.arange(k0, k0 + kt.shape[2])[None, :]
            mask = torch.ones((qt.shape[2], kt.shape[2]), dtype=torch.bool)
            if causal:
                mask &= q_pos >= k_pos
            if window:
                mask &= (q_pos - k_pos) < window
            s = torch.where(mask, s, torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + mm(p, vt)
            m = m_new
        out[:, :, q0:q0 + block_q] = acc / l.clamp_min(1e-30)
    return out


F32_SM90_CASES = SWEEP + [
    (2, 8, 4, 512, 512, 256, True, 0, 50.0),    # gemma2's widths
    (1, 2, 2, 1024, 1024, 128, True, 0, 0.0),   # several q and key tiles
    (1, 4, 2, 200, 200, 80, True, 70, 0.0),     # ragged q and key tiles
]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,d,causal,window,softcap",
                         F32_SM90_CASES)
def test_f32_sm90_arithmetic_matches_pallas_kernel(B, Hq, Hkv, Sq, Sk, d,
                                                   causal, window, softcap):
    """3xTF32 products and the log2-unit online softmax stay within the
    float32 tolerance of the Pallas kernel, elementwise."""
    x = _qkv(0, B, Hq, Hkv, Sq, Sk, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    block = 64 if Sq <= 256 and Sq % 64 == 0 else 128 if Sq % 128 == 0 \
        else Sq
    want = _jax(x, jnp.float32, jax_kernel, block_q=block, block_k=block,
                interpret=True, **kw)
    got = _port(x, torch.float32, fn=_f32_sm90_emulate, **kw)
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,d,causal,window,softcap",
                         WIDE_CASES)
def test_f32_sm90_wide_tiling_matches_pallas_kernel(B, Hq, Hkv, Sq, Sk, d,
                                                    causal, window, softcap):
    x = _qkv(1, B, Hq, Hkv, Sq, Sk, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = _port(x, torch.float32, fn=_f32_sm90_emulate, **kw)
    np.testing.assert_allclose(got, _pallas(x, "float32", **kw), **F32_TOL)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,d,causal,window,softcap,cols,"
                         "cluster", [
                             (1, 2, 1, 192, 192, 160, True, 0, 0.0, 16, 4),
                             (1, 4, 2, 128, 192, 100, False, 0, 50.0, 8, 8),
                             (1, 2, 2, 128, 128, 2304, True, 0, 0.0, None,
                              8)])
def test_f32_sm90_past_one_cluster_matches_pallas_kernel(
        B, Hq, Hkv, Sq, Sk, d, causal, window, softcap, cols, cluster):
    """Past one cluster's reach the slices go in groups of one cluster,
    each recomputing S (CTA r of a group over slices r, r + n, ...), the
    last group padded: at narrow emulated slices (160 / 16 = 10 slices in
    clusters of 4, three groups; 100 / 8 = 13 in clusters of 8) and at
    the kernel's own width (2304 / 128 = 18 in clusters of 8, three
    groups), against the Pallas kernel in interpret mode."""
    x = _qkv(11, B, Hq, Hkv, Sq, Sk, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    n_sl, n, nslp = ops.f32_wide_plan(d, cols, cluster)
    assert n_sl > n and nslp > n_sl                 # padded groups
    got = _port(x, torch.float32, fn=functools.partial(
        _f32_sm90_emulate, cols=cols, cluster=cluster), **kw)
    np.testing.assert_allclose(got, _pallas(x, "float32", **kw), **F32_TOL)


@pytest.mark.parametrize("d,cols,cluster", [(512, 128, 8), (512, 256, 8),
                                            (1024, 128, 8), (160, 16, 4)])
def test_f32_cluster_scores_are_the_same_bits_in_every_slice(d, cols,
                                                             cluster):
    """Every CTA of a cluster sums the partial S in rank order 0, 1, ...,
    n - 1, so every slice holds the same bits of S (and so of m and l);
    a CTA that began with its own partial would not: with three partials
    or more the rotated sums differ in some bits on these inputs, which is
    why the kernel fixes the order (two partials commute exactly)."""
    q, k, _ = (torch.from_numpy(a) for a in _qkv(12, 1, 1, 1, 128, 32, d))
    parts, _, n, nslp = _cluster_partials(q, k, mm3, cols, cluster)
    every = _cluster_scores(parts, nslp)
    assert len(every) == nslp and n > 1
    assert all(torch.equal(s, every[0]) for s in every)
    rotated = _cluster_scores(parts, nslp, rotated=True)
    assert torch.equal(rotated[0], every[0])
    if n > 2:           # a + b == b + a: two partials commute
        assert any(not torch.equal(s, every[0]) for s in rotated[1:])
    else:
        assert all(torch.equal(s, every[0]) for s in rotated)


def test_single_pass_tf32_misses_the_float32_bar():
    """Why every product is split: hi.hi alone (single-pass TF32) misses
    the float32 tolerance of the Pallas kernel at S=1024, d=128, where the
    three-term products pass (the case above)."""
    x = _qkv(0, 1, 2, 2, 1024, 1024, 128)
    want = _jax(x, jnp.float32, jax_kernel, block_q=128, block_k=128,
                interpret=True)
    got = _port(x, torch.float32, fn=_f32_sm90_emulate, terms=1)
    ratio = np.abs(got - want) / (F32_TOL["atol"]
                                  + F32_TOL["rtol"] * np.abs(want))
    assert ratio.max() > 5.0


def test_f32_sm90_rows_that_see_no_key():
    """Causal, a window of 32, Sk=64 < Sq=256: rows q >= 95 see no key. They
    get the mean of v over the keys of the 32-key tiles their 128-row q tile
    visited (0 where it visited none); every other row the plain version."""
    Sq, Sk, window = 256, 64, 32
    block_q, block_k = F32_TILES[True]
    x = [torch.from_numpy(a) for a in _qkv(6, 1, 2, 2, Sq, Sk, 64)]
    got = _f32_sm90_emulate(*x, window=window)
    want = attention_ref(*x, window=window)
    blind = 0
    for qp in range(Sq):
        if max(0, qp - window + 1) <= min(qp, Sk - 1):
            continue
        blind += 1
        q0 = qp // block_q * block_q
        k_end = min(Sk, q0 + block_q, Sq)
        k_first = max(0, q0 - window + 1) // block_k * block_k
        keys = x[2][:, :, k_first:max(k_first, k_end)]
        want[:, :, qp] = keys.mean(2) if keys.shape[2] else 0.0
    assert blind == Sq - (Sk + window - 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
def test_cpu_tensors_take_the_plain_version_and_launch_nothing(dtype,
                                                               monkeypatch):
    """Only a CUDA tensor reaches a kernel: on the CPU neither route's
    launcher is built and neither count moves, whatever the dtype."""
    def refuse(*_):
        raise AssertionError("a CPU tensor reached a kernel launcher")
    monkeypatch.setattr(ops, "_launcher", refuse)
    x = [torch.from_numpy(a).to(dtype) for a in _qkv(0, 1, 2, 1, 64, 64, 32)]
    fn = ops.flash_attention
    counts = (fn.launches, fn.launches_bf16, fn.launches_f16)
    got = ops.flash_attention(*x)
    assert counts == (fn.launches, fn.launches_bf16, fn.launches_f16)
    torch.testing.assert_close(got, attention_ref(*x), atol=0, rtol=0)


def test_each_dtype_has_its_own_hopper_kernel():
    """float32 goes to an sm_90a source of its own, bfloat16 and float16 to
    the 2-byte one; the wrapper derives the C entries from the source's
    name; the CUDA-core kernel of the float32 route is gone."""
    from repro_torch.kernels import _build
    assert ops.SOURCES == {torch.float32: "flash_attention_f32_sm90",
                           torch.bfloat16: "flash_attention_sm90",
                           torch.float16: "flash_attention_sm90"}
    names = set(_build.sources())
    assert set(ops.SOURCES.values()) <= names
    assert "flash_attention" not in names
    for name in ops.SOURCES.values():
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int {name}_launch(' in src
        assert f'extern "C" void {name}_config(' in src

def test_sm90_layout_rule_takes_the_models_views():
    x = torch.zeros(2, 64, 6, 128, dtype=torch.bfloat16)    # (B, S, H, d)
    assert ops._sm90_layout_ok(x.transpose(1, 2))
    assert ops._sm90_layout_ok(torch.zeros(2, 6, 64, 128,
                                           dtype=torch.bfloat16))
    # a dimension of extent 1 is never stepped, whatever its stride
    one = torch.zeros(64 * 32, dtype=torch.bfloat16)
    assert ops._sm90_layout_ok(one.as_strided((1, 1, 64, 32), (7, 3, 32, 1)))
    assert ops._sm90_unit(*(x.transpose(1, 2),) * 3) == 16


@pytest.mark.parametrize("bad", ["odd_stride", "misaligned"])
def test_sm90_layout_rule_refuses_what_tma_cannot_read(bad):
    """TMA cannot read these; the producers' own loads take them, 2 bytes
    at a time."""
    if bad == "odd_stride":     # seq stride 33 elements = 66 bytes
        t = torch.zeros(1, 2, 64, 33, dtype=torch.bfloat16)[..., :32]
    else:                       # base 2 bytes past an aligned address
        t = torch.zeros(2 * 64 * 32 + 1, dtype=torch.bfloat16)[1:] \
            .view(1, 2, 64, 32)
    assert not ops._sm90_layout_ok(t)
    assert ops._sm90_unit(t, t, t) == 2


def test_sm90_refuses_a_head_dim_off_the_wgmma_step():
    """A head dim off the wgmma step of 16 is taken: its columns to the
    next 64 are zeros (TMA's fill, or the own loads'), which add nothing
    to q.k and leave the output's padding unwritten."""
    t = torch.zeros(1, 2, 64, 24, dtype=torch.bfloat16)
    assert ops._sm90_layout_ok(t) and ops._sm90_unit(t, t, t) == 16
    x = _qkv(9, 1, 2, 2, 64, 64, 24)
    np.testing.assert_allclose(_port(x, torch.bfloat16, fn=_sm90_emulate),
                               _pallas(x, "bfloat16"), **BF16_TOL)


def test_kernel_bench_3xtf32_bound_at_the_forward_shape():
    """K2's float32 bound at the rate its kernel uses: 3 x 171.8 GFLOP at
    495 TFLOP/s, 1.041 ms at (2, 20, 4096, 128) causal (operations, not
    bytes); the bench's K2 rows carry it as ``bound_used_ms``."""
    from benchmarks_torch import kernel_bench as kb
    from repro_torch.roofline.analysis import HBM_BYTES_PER_S
    assert round(kb.flash_flops(2, 20, 4096, 128) / 1e9, 1) == 171.8
    assert abs(kb.flash_bound_3xtf32(2, 20, 20, 4096, 128) - 1.041) < 1e-3
    assert kb.flash_bytes(2, 20, 20, 4096, 128) / HBM_BYTES_PER_S * 1e3 < \
        kb.flash_bound_3xtf32(2, 20, 20, 4096, 128)
    rows = kb.bench_flash("cpu", [(1, 4, 2, 64, 32)])
    assert len(rows) == 1 and rows[0]["max_abs_err"] == 0.0
    assert rows[0]["ms"] is None and rows[0]["library_ms"] is None
    assert rows[0]["bound_used_ms"] == kb.flash_bound_3xtf32(1, 4, 2, 64, 32)
    assert rows[0]["mbytes"] == 4 * 64 * 32 * (2 * 4 + 2 * 2) / 1e6


# --- the plain attention functions of models/common.py ---------------------

def _bshd(seed, B, Sq, Sk, Hq, Hkv, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Sq, Hq, d).astype(np.float32),
            rng.randn(B, Sk, Hkv, d).astype(np.float32),
            rng.randn(B, Sk, Hkv, d).astype(np.float32))


@pytest.mark.parametrize("causal,window,softcap,offset", [
    (True, 0, 0.0, None), (True, 24, 30.0, None), (False, 0, 0.0, None),
    (True, 0, 0.0, [40, 7]), (True, 16, 50.0, [40, 7])])
def test_gqa_attention_matches_jax(causal, window, softcap, offset):
    x = _bshd(4, 2, 8 if offset else 48, 48, 4, 2, 16)
    kw = dict(causal=causal, window=window, attn_softcap=softcap)
    jkw, tkw = dict(kw), dict(kw)
    if offset:
        jkw.update(q_offset=jnp.asarray(offset), kv_len=jnp.asarray(offset)
                   + 8)
        tkw.update(q_offset=torch.tensor(offset),
                   kv_len=torch.tensor(offset) + 8)
    want = np.asarray(jcommon.gqa_attention(*map(jnp.asarray, x), **jkw))
    got = common.gqa_attention(*map(torch.from_numpy, x), **tkw).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("Sk,chunk,window", [(96, 32, 0), (100, 32, 0),
                                             (64, 64, 20)])
def test_chunked_attention_matches_jax_and_the_kernel_path(Sk, chunk, window):
    x = _bshd(5, 1, Sk, Sk, 4, 4, 16)
    want = np.asarray(jcommon.chunked_attention(
        *map(jnp.asarray, x), window=window, chunk=chunk))
    got = common.chunked_attention(*map(torch.from_numpy, x), window=window,
                                   chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    # tests/test_kernels.py::test_flash_matches_model_attention_path
    q, k, v = (torch.from_numpy(a).transpose(1, 2) for a in x)
    flash = ops.flash_attention(q, k, v, window=window).transpose(1, 2)
    np.testing.assert_allclose(flash.numpy(), got.numpy(), **F32_TOL)


def test_attention_dispatches_long_sequences_to_the_chunked_form():
    x = [torch.from_numpy(a) for a in _bshd(6, 1, 40, 40, 2, 2, 8)]
    np.testing.assert_array_equal(
        common.attention(*x, chunk_threshold=32).numpy(),
        common.chunked_attention(*x).numpy())
    np.testing.assert_array_equal(common.attention(*x).numpy(),
                                  common.gqa_attention(*x).numpy())


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_jax(masked):
    rng = np.random.RandomState(7)
    logits = (rng.randn(2, 9, 33) * 3).astype(np.float32)
    labels = rng.randint(0, 33, (2, 9)).astype(np.int32)
    mask = (rng.rand(2, 9) > 0.4) if masked else None
    want = float(jcommon.softmax_xent(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask)))
    got = float(common.softmax_xent(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask)))
    np.testing.assert_allclose(got, want, **F32_TOL)
