"""Port's mLSTM scan (K3): its plain version and the wrapper's CPU branch
against the JAX Pallas kernel (interpret mode) and its oracle; the
wrapper's refusals. The CUDA kernel is held against the plain version on
the card by chip_smoke.py."""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="dev dep; pip install -r "
                    "requirements-dev.txt")

import jax.numpy as jnp
import numpy as np
from hypothesis import given, settings, strategies as st

from repro.kernels.mlstm_scan.kernel import mlstm_scan as jmlstm_scan
from repro.kernels.mlstm_scan.ref import mlstm_scan_ref as jmlstm_scan_ref
from repro_torch.kernels.mlstm_scan import ops
from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_ref

F32_TOL = dict(atol=2e-5, rtol=2e-4)     # tests/test_kernels.py:115


def _inputs(rng, B, H, S, dh, lf_lo=0.5, lf_hi=0.99, li_scale=0.5):
    q, k, v = (rng.randn(B, H, S, dh).astype(np.float32) for _ in range(3))
    lf = np.log(rng.uniform(lf_lo, lf_hi, (B, H, S))).astype(np.float32)
    li = (rng.randn(B, H, S) * li_scale).astype(np.float32)
    return q, k, v, lf, li


def _jax(x):
    return [jnp.asarray(a) for a in x]


def _torch(x):
    return [torch.from_numpy(a) for a in x]


@pytest.mark.parametrize("B,H,S,dh,chunk", [     # tests/test_kernels.py:97
    (2, 2, 64, 16, 16),
    (1, 4, 128, 32, 32),
    (1, 1, 96, 8, 96),       # single chunk
    (2, 1, 64, 16, 8),       # many small chunks
])
def test_plain_version_and_wrapper_match_the_pallas_kernel(B, H, S, dh,
                                                           chunk):
    x = _inputs(np.random.RandomState(B * 100 + S), B, H, S, dh)
    kernel = np.asarray(jmlstm_scan(*_jax(x), chunk=chunk, interpret=True))
    oracle = np.asarray(jmlstm_scan_ref(*_jax(x), chunk=8))
    before = ops.mlstm_scan.launches
    got = ops.mlstm_scan(*_torch(x), chunk=chunk)
    assert ops.mlstm_scan.launches == before          # the CPU runs no kernel
    np.testing.assert_allclose(got.numpy(), kernel, **F32_TOL)
    np.testing.assert_allclose(got.numpy(), oracle, **F32_TOL)
    # the plain version at another chunk, against the oracle at the same one
    other = 8 if chunk != 8 else 16
    np.testing.assert_allclose(mlstm_scan_ref(*_torch(x), chunk=other).numpy(),
                               np.asarray(jmlstm_scan_ref(*_jax(x),
                                                          chunk=other)),
                               **F32_TOL)


@settings(deadline=None, max_examples=6)
@given(st.integers(0, 10_000))
def test_property_against_the_pallas_kernel(seed):      # test_kernels.py:118
    x = _inputs(np.random.RandomState(seed), 1, 2, 48, 8, 0.3, 0.999, 1.0)
    kernel = np.asarray(jmlstm_scan(*_jax(x), chunk=16, interpret=True))
    got = ops.mlstm_scan(*_torch(x), chunk=16).numpy()
    np.testing.assert_allclose(got, kernel, atol=5e-5, rtol=5e-4)
    np.testing.assert_allclose(
        mlstm_scan_ref(*_torch(x), chunk=48).numpy(),
        np.asarray(jmlstm_scan_ref(*_jax(x), chunk=48)), atol=5e-5,
        rtol=5e-4)


def test_bfloat16_inputs_give_bfloat16_and_chunk_clamps_to_s():
    q, k, v, lf, li = _torch(_inputs(np.random.RandomState(5), 1, 2, 32, 16))
    out = ops.mlstm_scan(q.bfloat16(), k.bfloat16(), v.bfloat16(), lf, li,
                         chunk=128)          # chunk = min(128, S) = 32
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (1, 2, 32, 16)
    want = mlstm_scan_ref(q.bfloat16(), k.bfloat16(), v.bfloat16(), lf, li,
                          chunk=32)
    assert torch.equal(out, want)


def test_wrapper_refusals():
    q, k, v, lf, li = _torch(_inputs(np.random.RandomState(6), 1, 2, 48, 8))
    scan = ops.mlstm_scan
    with pytest.raises(ValueError, match="multiple of chunk"):
        scan(q, k, v, lf, li, chunk=32)                  # 48 % 32
    with pytest.raises(TypeError, match="not supported"):
        scan(q.half(), k.half(), v.half(), lf, li, chunk=16)
    with pytest.raises(TypeError, match="one dtype"):
        scan(q, k.bfloat16(), v, lf, li, chunk=16)
    with pytest.raises(TypeError, match="float32"):
        scan(q, k, v, lf.bfloat16(), li, chunk=16)
    with pytest.raises(ValueError, match="on meta"):
        scan(q, k.to("meta"), v, lf, li, chunk=16)
    with pytest.raises(ValueError, match="last dimension"):
        qt = q.transpose(2, 3).contiguous().transpose(2, 3)
        scan(qt, k, v, lf, li, chunk=16)
    with pytest.raises(ValueError, match=r"\(B, H, S\)"):
        scan(q, k, v, lf[:, :1], li, chunk=16)
    with pytest.raises(ValueError, match="one \\(B, H, S, dh\\)"):
        scan(q, k[:, :1], v, lf, li, chunk=16)
    big = torch.zeros(1, 1, 512, 8)
    gates = torch.zeros(1, 1, 512)
    with pytest.raises(ValueError, match=f"chunk <= {ops.MAX_CHUNK}"):
        scan(big, big, big, gates, gates, chunk=512)
    wide = torch.zeros(1, 1, 8, ops.MAX_HEAD_DIM + 8)
    gates = torch.zeros(1, 1, 8)
    with pytest.raises(ValueError, match=f"dh <= {ops.MAX_HEAD_DIM}"):
        scan(wide, wide, wide, gates, gates, chunk=8)


def test_strided_views_give_the_contiguous_result():
    """(B, S, H, dh) tensors seen as (B, H, S, dh) give what the
    contiguous ones give (the kernel reads their strides)."""
    x = _inputs(np.random.RandomState(7), 2, 3, 32, 8)
    q, k, v, lf, li = _torch(x)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    gates = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (lf, li)]
    assert not views[0].is_contiguous()
    np.testing.assert_array_equal(
        ops.mlstm_scan(*views, *gates, chunk=16).numpy(),
        ops.mlstm_scan(q, k, v, lf, li, chunk=16).numpy())


def test_kernel_bench_counts_and_cpu_rows():
    from benchmarks_torch import kernel_bench as kb
    # the xLSTM-125m layer shape: the full L x L work and what it needs
    full, needed = kb.mlstm_flops(8, 4, 2048, 384, 256)
    assert full == 4 * 8 * 4 * 2048 * 256 * 384 + 4 * 8 * 4 * 2048 * 384 ** 2
    assert round(full / 1e9, 1) == 64.4 and round(needed / 1e9, 1) == 51.6
    assert kb.mlstm_bytes(8, 4, 2048, 384) == 4 * 8 * 4 * 2048 * 384 * 4 \
        + 2 * 8 * 4 * 2048 * 4
    rows = kb.bench_mlstm("cpu", [(1, 2, 64, 16, 32)])
    assert len(rows) == 1 and rows[0]["max_abs_err"] == 0.0
    assert rows[0]["ms"] is None and rows[0]["library_ms"] is None
    want = kb.bound_ms(kb.mlstm_bytes(1, 2, 64, 16),
                       kb.mlstm_flops(1, 2, 64, 16, 32)[1], kb.F32_FLOPS_PER_S)
    assert (rows[0]["bound_ms"], rows[0]["bound_by"]) == want
    assert rows[0]["gflop"] == kb.mlstm_flops(1, 2, 64, 16, 32)[0] / 1e9
