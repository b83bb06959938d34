"""Port's mLSTM scan (K3): its plain version and the wrapper's CPU branch
against the JAX Pallas kernel (interpret mode) and its oracle; the
wrapper's refusals; a plain emulation of the sm90 kernel's arithmetic
(``_sm90_emulate``: the scalar pass, the chunk-local states and their
combine, the output pass, 3xTF32 products) against both, and the kernel's
tiling (``ops.plan``). The CUDA kernel is held against the plain version on
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
from tf32_split import mm3, tf32, tf32_read

F32_TOL = dict(atol=2e-5, rtol=2e-4)     # tests/test_kernels.py:115
BF16_TOL = dict(atol=2e-3, rtol=2e-2)    # tests/test_kernels.py:17
MMIN, NEG = -40.0, -1e30


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
    # the kernel's own limits: checked on the CUDA branch only
    with pytest.raises(ValueError, match=f"chunk <= {ops.MAX_CHUNK}"):
        ops._check_kernel(512, 8)
    with pytest.raises(ValueError, match=f"dh <= {ops.MAX_HEAD_DIM}"):
        ops._check_kernel(8, ops.MAX_HEAD_DIM + 8)
    ops._check_kernel(ops.MAX_CHUNK, ops.MAX_HEAD_DIM)


@pytest.mark.parametrize("S,dh,chunk", [(512, 8, 512), (16, 520, 8)])
def test_wrapper_matches_the_pallas_kernel_past_the_kernel_s_limits(S, dh,
                                                                    chunk):
    """Chunk 512 and dh 520, which the Pallas kernel computes and only the
    card's kernel refuses (``_check_kernel``): the CPU wrapper's plain
    version against the Pallas kernel and the oracle."""
    x = _inputs(np.random.RandomState(S + dh), 1, 2, S, dh)
    kernel = np.asarray(jmlstm_scan(*_jax(x), chunk=chunk, interpret=True))
    got = ops.mlstm_scan(*_torch(x), chunk=chunk).numpy()
    np.testing.assert_allclose(got, kernel, **F32_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jmlstm_scan_ref(*_jax(x), chunk=chunk)), **F32_TOL)


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
    assert rows[0]["device_ms"] is None
    assert rows[0]["bound_used_ms"] == kb.mlstm_bound_3xtf32(1, 2, 64, 16, 32)


def test_kernel_bench_3xtf32_bound_at_the_layer_shape():
    from benchmarks_torch import kernel_bench as kb
    # 3 x 51.6 GFLOP at 495 TFLOP/s: 0.313 ms, operations (not bytes)
    assert abs(kb.mlstm_bound_3xtf32(8, 4, 2048, 384, 256) - 0.3127) < 1e-3
    from repro_torch.roofline.analysis import HBM_BYTES_PER_S
    assert kb.mlstm_bound_3xtf32(8, 4, 2048, 384, 256) > \
        kb.mlstm_bytes(8, 4, 2048, 384) / HBM_BYTES_PER_S * 1e3


# ---- the sm90 kernel's arithmetic, in plain PyTorch -------------------------

def _sm90_emulate(q, k, v, lf, li, chunk):
    """What csrc/mlstm_scan_sm90.cu computes, pass by pass. Returns h in q's
    dtype and the scalars (m entering each chunk, the row stabilizers m_i
    and the rows' intra-chunk maxima)."""
    B, H, S, dh = q.shape
    L, nc = chunk, S // chunk
    qs = (q.float() * dh ** -0.5).reshape(B, H, nc, L, dh)
    kc = k.float().reshape(B, H, nc, L, dh)
    vc = v.float().reshape(B, H, nc, L, dh)
    lic = li.reshape(B, H, nc, L)
    # pass 1: F summed in double and rounded once; the carried m in order
    F = torch.cumsum(lf.reshape(B, H, nc, L).double(), -1).float()
    FL = F[..., -1]
    causal = torch.ones(L, L, dtype=torch.bool).tril()
    dlog = (F[..., :, None] - F[..., None, :]) + lic[..., None, :]
    lmax = torch.where(causal, dlog, torch.tensor(NEG)).amax(-1)
    g = ((FL[..., None] - F) + lic).amax(-1)
    m, ms = torch.full((B, H), MMIN), []
    for c in range(nc):
        ms.append(m)
        m = torch.clamp(torch.maximum(FL[..., c] + m, g[..., c]), min=MMIN)
    mc = torch.stack(ms, -1)                         # entering each chunk
    mnext = torch.stack(ms[1:] + [m], -1)
    Mi = torch.clamp(torch.maximum(lmax, F + mc[..., None]), min=MMIN)
    Sf = torch.exp((F + mc[..., None]) - Mi)
    wL = torch.exp(((FL[..., None] - F) + lic) - mnext[..., None])
    decay = torch.exp((FL + mc) - mnext)
    # pass 2: the state entering each chunk
    C, n, Cs, ns = torch.zeros(B, H, dh, dh), torch.zeros(B, H, dh), [], []
    for c in range(nc):
        Cs.append(C)
        ns.append(n)
        kw = kc[:, :, c] * wL[:, :, c, :, None]
        C = decay[..., c, None, None] * C + mm3(kw.transpose(-1, -2),
                                                 vc[:, :, c])
        n = decay[..., c, None] * n + kw.sum(-2)
    # pass 3: P = e^(D - m_i) (q.k^T), its row sums, q.C_prev and P.V
    hs = []
    for c in range(nc):
        s = mm3(qs[:, :, c], kc[:, :, c].transpose(-1, -2))
        w = torch.where(causal, torch.exp(dlog[:, :, c]
                                          - Mi[:, :, c, :, None]),
                        torch.tensor(0.0))
        P = w * s
        den = P.sum(-1) + (qs[:, :, c] * ns[c][:, :, None, :]).sum(-1) \
            * Sf[:, :, c]
        O = mm3(qs[:, :, c], Cs[c]) * Sf[:, :, c, :, None] \
            + mm3(P, vc[:, :, c])
        hs.append(O / torch.maximum(den.abs(), torch.exp(-Mi[:, :, c]))
                  [..., None])
    h = torch.stack(hs, 2).reshape(B, H, S, dh).to(q.dtype)
    return h, {"m": mc, "m_i": Mi, "row_max": lmax, "state_log": F
               + mc[..., None]}


@pytest.mark.parametrize("B,H,nc,dh,chunk,dtype", [
    (1, 2, 4, 16, 16, "float32"),
    (2, 1, 3, 64, 64, "float32"),
    (1, 2, 2, 96, 128, "float32"),
    (1, 1, 1, 96, 64, "float32"),       # one chunk: no state pass
    (1, 1, 2, 16, 128, "float32"),
    (2, 2, 2, 64, 16, "bfloat16"),
    (1, 2, 3, 96, 64, "bfloat16"),
    (1, 1, 1, 16, 128, "bfloat16"),
])
def test_sm90_emulation_matches_the_pallas_kernel(B, H, nc, dh, chunk,
                                                  dtype):
    S = nc * chunk
    x = _inputs(np.random.RandomState(dh * 7 + S), B, H, S, dh)
    jx, tx = _jax(x), _torch(x)
    tol = F32_TOL
    if dtype == "bfloat16":
        jx[:3] = [a.astype(jnp.bfloat16) for a in jx[:3]]
        tx[:3] = [t.bfloat16() for t in tx[:3]]
        tol = BF16_TOL
    kernel = np.asarray(jmlstm_scan(*jx, chunk=chunk, interpret=True)
                        .astype(jnp.float32))
    oracle = np.asarray(jmlstm_scan_ref(*jx, chunk=chunk)
                        .astype(jnp.float32))
    got, _ = _sm90_emulate(*tx, chunk)
    assert got.dtype == tx[0].dtype
    np.testing.assert_allclose(got.float().numpy(), kernel, **tol)
    np.testing.assert_allclose(got.float().numpy(), oracle, **tol)
    np.testing.assert_allclose(
        got.float().numpy(),
        mlstm_scan_ref(*tx, chunk=chunk).float().numpy(), **tol)


def test_sm90_emulation_where_m_reaches_its_floor():
    """lf strongly negative and li near -42: the state decays at once and
    most log weights fall under -40, so m_i and the carried m sit at the
    floor in some rows and chunks and above it in others."""
    rng = np.random.RandomState(11)
    x = list(_inputs(rng, 1, 2, 4 * 32, 16, 1e-8, 1e-6))
    x[4] = (rng.randn(1, 2, 4 * 32) * 2.0 - 42.0).astype(np.float32)
    got, sc = _sm90_emulate(*_torch(x), 32)
    assert bool((sc["m_i"] == MMIN).any()) and bool((sc["m_i"] > MMIN).any())
    assert bool((sc["m"][..., 1:] == MMIN).any())
    kernel = np.asarray(jmlstm_scan(*_jax(x), chunk=32, interpret=True))
    np.testing.assert_allclose(got.numpy(), kernel, **F32_TOL)
    np.testing.assert_allclose(got.numpy(), mlstm_scan_ref(
        *_torch(x), chunk=32).numpy(), **F32_TOL)


def test_sm90_emulation_where_the_stabilizer_switches_between_chunks():
    """Two large input gates: after the first the carried state sets m_i
    (F_i + m above every intra-chunk weight) for whole chunks, after the
    second a key of the chunk takes over again."""
    rng = np.random.RandomState(12)
    x = list(_inputs(rng, 1, 1, 4 * 64, 64, 0.9, 0.99))
    x[4][0, 0, 3] = 12.0            # chunk 0
    x[4][0, 0, 2 * 64 + 5] = 15.0   # chunk 2
    got, sc = _sm90_emulate(*_torch(x), 64)
    from_state = sc["m_i"] == sc["state_log"]
    from_rows = sc["m_i"] == sc["row_max"]
    assert bool(from_state[0, 0, 1].all())                 # chunk 1
    assert bool(from_state[0, 0, 2, :5].all())
    assert bool(from_rows[0, 0, 2, 5:].all())
    kernel = np.asarray(jmlstm_scan(*_jax(x), chunk=64, interpret=True))
    np.testing.assert_allclose(got.numpy(), kernel, **F32_TOL)
    np.testing.assert_allclose(got.numpy(), mlstm_scan_ref(
        *_torch(x), chunk=64).numpy(), **F32_TOL)


def test_tf32_split_rounds_to_nearest_and_keeps_21_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -10 + 2.0 ** -23])
    hi = tf32(x)
    assert hi.tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                           -(1.0 + 2.0 ** -10), 1.0 + 2.0 ** -10]
    r = torch.from_numpy(np.random.RandomState(3).randn(4096)
                         .astype(np.float32))
    hi = tf32(r)
    lo = tf32_read(r - hi)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((r - hi).abs() / r.abs()).max()) <= 2.0 ** -11
    assert float(((hi + lo - r).abs() / r.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("dh", [1, 8, 16, 63, 64, 65, 96, 128, 129, 256, 257,
                                384, 385, 511, 512])
@pytest.mark.parametrize("chunk", [1, 8, 16, 48, 64, 96, 128, 200, 256])
def test_plan_covers_every_accepted_shape(dh, chunk):
    p = ops.plan(4 * chunk, dh, chunk)
    assert p["nt"] in ops.OUTPUT_TILES and p["dhp"] == 64 * p["nt"] >= dh
    assert p["nt"] == 1 or 64 * ops.OUTPUT_TILES[
        ops.OUTPUT_TILES.index(p["nt"]) - 1] < dh           # the least
    assert p["dhp"] % p["bn"] == 0 and p["bn"] in (64, 96, 128)
    assert p["smem_outputs"] <= ops.MAX_SMEM
    assert p["smem_states"] <= ops.MAX_SMEM // 2             # 2 blocks an SM
    assert p["n_chunks"] == 4 and p["row_tiles"] == -(-chunk // 64)


def test_plan_at_the_layer_and_bench_shapes():
    # xLSTM-125m's mLSTM layer: B=8, H=4, S=2048, dh=384, chunk 256
    p = ops.plan(2048, 384, 256)
    assert (p["nt"], p["dhp"], p["bn"], p["n_chunks"], p["row_tiles"]) == \
        (6, 384, 96, 8, 4)
    out_blocks = p["row_tiles"] * p["n_chunks"] * 8 * 4
    assert out_blocks == 1024 and out_blocks >= 7 * 132   # blocks per SM
    assert (384 // 64) * (384 // p["bn"]) * 8 * 4 == 768  # state blocks
    # the kernel bench's shapes get more output blocks than the earlier
    # kernel's grid of (B H, dh / 64): 16 and 4
    from benchmarks_torch.kernel_bench import MLSTM_SHAPES
    for (B, H, S, dh, chunk), old in zip(MLSTM_SHAPES, (16, 4)):
        q = ops.plan(S, dh, chunk)
        assert q["row_tiles"] * q["n_chunks"] * B * H > old
        assert (q["dhp"] // 64) * (q["dhp"] // q["bn"]) * B * H >= old


def test_workspace_shapes_and_the_cpu_route():
    ws = ops.workspace(2, 3, 512, 96, 128, "cpu")
    assert [tuple(t.shape) for t in ws] == [
        (4, 6, 512), (3, 6, 5), (6, 3, 128), (6, 3, 96, 128)]
    assert ops.workspace(1, 1, 64, 16, 64, "cpu")[2:] == (None, None)
    x = _torch(_inputs(np.random.RandomState(9), 1, 1, 64, 16))
    n = ops.mlstm_scan.launches
    ops.mlstm_scan(*x, chunk=32)
    assert ops.mlstm_scan.launches == n


def test_wrapper_refuses_past_the_kernels_limits():
    """The limits of the card's kernel, through the helper the CUDA branch
    calls before any launch; a device with no kernel raises."""
    with pytest.raises(ValueError, match="dh <= 512"):
        ops._check_kernel(257, ops.MAX_HEAD_DIM + 1)
    with pytest.raises(ValueError, match="chunk <= 256"):
        ops._check_kernel(257, 8)
    gates = torch.zeros(1, 1, 514)
    long = torch.zeros(1, 1, 514, 8)
    with pytest.raises(ValueError, match="no kernel for meta"):
        m = [t.to("meta") for t in (long, long, long, gates, gates)]
        ops.mlstm_scan(*m, chunk=2)
