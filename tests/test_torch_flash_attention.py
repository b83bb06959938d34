"""Port's flash attention (plain version on the CPU) vs the JAX Pallas kernel
in interpret mode and its oracle, the port's plain attention functions vs
the JAX package's, and the wrapper's CPU routing and refusals. An emulation
of the bfloat16 tensor-core kernel's arithmetic (csrc/flash_attention_sm90.cu)
is held against the Pallas kernel too. The CUDA kernels themselves are held
against the plain version on the card by chip_smoke.py."""
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
    if bad == "mixed_device":
        k = k.to("meta")
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed_dtype":
        v = v.to(torch.bfloat16)
    elif bad == "group":
        q = torch.zeros(1, 3, 64, 32)
    elif bad == "head_dim":
        q, k, v = (torch.zeros(1, 2, 8, 320) for _ in range(3))
    elif bad == "window":
        kw = dict(window=-1)
    else:
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((TypeError, ValueError)):
        ops.flash_attention(q, k, v, **kw)


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_take_the_plain_version_and_launch_nothing(dtype,
                                                               monkeypatch):
    """Only a CUDA tensor reaches a kernel: on the CPU neither route's
    launcher is built and neither count moves, whatever the dtype."""
    def refuse():
        raise AssertionError("a CPU tensor reached a kernel launcher")
    monkeypatch.setattr(ops, "_launcher", refuse)
    monkeypatch.setattr(ops, "_launcher_sm90", refuse)
    x = [torch.from_numpy(a).to(dtype) for a in _qkv(0, 1, 2, 1, 64, 64, 32)]
    counts = (ops.flash_attention.launches, ops.flash_attention.launches_sm90)
    got = ops.flash_attention(*x)
    assert counts == (ops.flash_attention.launches,
                      ops.flash_attention.launches_sm90)
    torch.testing.assert_close(got, attention_ref(*x), atol=0, rtol=0)


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
