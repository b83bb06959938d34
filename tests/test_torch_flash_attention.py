"""Port's flash attention (plain version on the CPU) vs the JAX Pallas kernel
in interpret mode and its oracle, the port's plain attention functions vs
the JAX package's, and the wrapper's CPU routing and refusals. Emulations of
the two tensor-core kernels' arithmetic (bfloat16: csrc/flash_attention_sm90.cu;
float32, 3xTF32: csrc/flash_attention_f32_sm90.cu) are held against the
Pallas kernel too, and single-pass TF32 is shown to miss the float32 bar.
The CUDA kernels themselves are held against the plain version on the card
by chip_smoke.py."""
import math

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
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}
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
        # only the card's kernels refuse it, before any launch; the CPU
        # path computes it (test_head_dim_320_matches_pallas_kernel)
        q, k = (torch.zeros(1, 2, 8, 320) for _ in range(2))
        with pytest.raises(ValueError, match="d <= 256"):
            ops._check_kernel(q, k)
        ops._check_kernel(q[..., :256], k[..., :256])
        return
    if bad == "mixed_device":
        k = k.to("meta")
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
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


# --- the bfloat16 tensor-core kernel: its arithmetic, route and layout rule --

def _sm90_emulate(q, k, v, *, causal=True, window=0, softcap=0.0):
    """csrc/flash_attention_sm90.cu's arithmetic in plain PyTorch: bf16 q.k^T
    summed in f32, then scaled; key tiles of 128 (64 at d > 128); a float32
    online softmax from -1e30; P.V as two bf16 products, P_hi = bf16(p) and
    P_lo = bf16(p - P_hi); l summed from the f32 p; bf16 out."""
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(Hq // Hkv, dim=1)
    vf = v.float().repeat_interleave(Hq // Hkv, dim=1)
    block_k = 128 if d <= 128 else 64
    q_pos = torch.arange(Sq)[:, None]
    m = torch.full((B, Hq, Sq, 1), -1e30)
    l = torch.zeros((B, Hq, Sq, 1))
    acc = torch.zeros((B, Hq, Sq, d))
    for k0 in range(0, Sk, block_k):
        kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        s = (q.float() @ kt.transpose(-1, -2)) / math.sqrt(d)
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
        p_hi = p.bfloat16().float()
        p_lo = (p - p_hi).bfloat16().float()
        acc = acc * corr + p_hi @ vt + p_lo @ vt
        m = m_new
    return (acc / l.clamp_min(1e-30)).bfloat16()


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


# the float32 kernel's tiles (q rows, keys) by head_dim: its Cfg<D>
F32_TILES = {True: (128, 32), False: (64, 16)}      # d <= 128, d > 128


def _f32_sm90_emulate(q, k, v, *, causal=True, window=0, softcap=0.0,
                      terms=3):
    """csrc/flash_attention_f32_sm90.cu's arithmetic in plain PyTorch: q
    tiles of 128 rows (64 at d > 128), each visiting the key tiles of 32
    (16) its band reaches; S = Q.K^T and O += P.V as 3xTF32 products of
    operands split once; scores in log2 units (masked -1e30, keys past Sk
    -inf); a float32 online softmax from -1e30 with exp2; out = acc /
    max(l, 1e-30)."""
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    block_q, block_k = F32_TILES[d <= 128]
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_take_the_plain_version_and_launch_nothing(dtype,
                                                               monkeypatch):
    """Only a CUDA tensor reaches a kernel: on the CPU neither route's
    launcher is built and neither count moves, whatever the dtype."""
    def refuse(*_):
        raise AssertionError("a CPU tensor reached a kernel launcher")
    monkeypatch.setattr(ops, "_launcher", refuse)
    x = [torch.from_numpy(a).to(dtype) for a in _qkv(0, 1, 2, 1, 64, 64, 32)]
    counts = (ops.flash_attention.launches, ops.flash_attention.launches_bf16)
    got = ops.flash_attention(*x)
    assert counts == (ops.flash_attention.launches,
                      ops.flash_attention.launches_bf16)
    torch.testing.assert_close(got, attention_ref(*x), atol=0, rtol=0)


def test_each_dtype_has_its_own_hopper_kernel():
    """float32 and bfloat16 each go to an sm_90a source of their own, whose
    C entries the wrapper derives from the source's name; the CUDA-core
    kernel of the float32 route is gone."""
    from repro_torch.kernels import _build
    assert ops.SOURCES == {torch.float32: "flash_attention_f32_sm90",
                           torch.bfloat16: "flash_attention_sm90"}
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
    ops._check_sm90(*(x.transpose(1, 2),) * 3)


@pytest.mark.parametrize("bad", ["odd_stride", "misaligned"])
def test_sm90_layout_rule_refuses_what_tma_cannot_read(bad):
    if bad == "odd_stride":     # seq stride 33 elements = 66 bytes
        t = torch.zeros(1, 2, 64, 33, dtype=torch.bfloat16)[..., :32]
    else:                       # base 2 bytes past an aligned address
        t = torch.zeros(2 * 64 * 32 + 1, dtype=torch.bfloat16)[1:] \
            .view(1, 2, 64, 32)
    assert not ops._sm90_layout_ok(t)
    with pytest.raises(ValueError, match="TMA"):
        ops._check_sm90(t, t, t)


def test_sm90_refuses_a_head_dim_off_the_wgmma_step():
    t = torch.zeros(1, 2, 64, 24, dtype=torch.bfloat16)
    assert ops._sm90_layout_ok(t)
    with pytest.raises(ValueError, match="multiple of 16"):
        ops._check_sm90(t, t, t)


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
