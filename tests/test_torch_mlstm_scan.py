"""Port's mLSTM scan (K3): its plain version and the wrapper's CPU branch
against the JAX Pallas kernel (interpret mode) and its oracle; the
wrapper's refusals; a plain emulation of the sm90 kernel's arithmetic
(``_sm90_emulate``: the scalar pass, the chunk-local states and their
combine, the output pass and its cluster form past chunk 256 or dh 512,
3xTF32 products) against both, the kernel's tiling (``ops.plan``) and
``benchmarks_torch/mlstm_variants.py``'s edits. The CUDA kernel is held
against the plain version on the card by chip_smoke.py."""
import re

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
F16_TOL = dict(atol=1e-3, rtol=2e-3)     # float16: 11 significant bits
LOW = {"bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL),
       "float16": (jnp.float16, torch.float16, F16_TOL)}
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


@pytest.mark.parametrize("B,H,S,dh,chunk", [(2, 2, 64, 16, 16),
                                             (1, 4, 128, 32, 32),
                                             (2, 1, 64, 16, 8)])
def test_float16_matches_the_pallas_kernel(B, H, S, dh, chunk):
    """float16 q, k, v (the TPU kernel takes them: float32 math, q's type
    out) through the wrapper's CPU branch, against the Pallas kernel."""
    x = _inputs(np.random.RandomState(B * 10 + S), B, H, S, dh)
    jx, tx = _jax(x), _torch(x)
    jx[:3] = [a.astype(jnp.float16) for a in jx[:3]]
    tx[:3] = [t.half() for t in tx[:3]]
    kernel = np.asarray(jmlstm_scan(*jx, chunk=chunk, interpret=True)
                        .astype(jnp.float32))
    got = ops.mlstm_scan(*tx, chunk=chunk)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(), kernel, **F16_TOL)


def test_wrapper_refusals():
    q, k, v, lf, li = _torch(_inputs(np.random.RandomState(6), 1, 2, 48, 8))
    scan = ops.mlstm_scan
    with pytest.raises(ValueError, match="multiple of chunk"):
        scan(q, k, v, lf, li, chunk=32)                  # 48 % 32
    # float64 (float16 is taken, as the TPU kernel takes it)
    with pytest.raises(TypeError, match="not supported"):
        scan(q.double(), k.double(), v.double(), lf, li, chunk=16)
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
    # the kernel's old limits (chunk 256, dh 512) are gone: past them the
    # plan slices the outputs pass, and what is still refused is a device
    # with no kernel (meta tensors: only the shapes are read)
    for S, dh, chunk in ((512, 8, 512), (16, 520, 8), (2048, 1024, 1024)):
        p = ops.plan(S, dh, chunk)
        assert p["sliced"] and p["smem_outputs"] <= ops.MAX_SMEM
        m = [torch.empty(1, 1, S, dh, device="meta")] * 3 + \
            [torch.empty(1, 1, S, device="meta")] * 2
        with pytest.raises(ValueError, match="no kernel for meta"):
            scan(*m, chunk=chunk)
    assert not ops.plan(256, ops.BLOCK_DH, ops.BLOCK_CHUNK)["sliced"]


@pytest.mark.parametrize("S,dh,chunk", [(512, 8, 512), (16, 520, 8)])
def test_wrapper_matches_the_pallas_kernel_past_the_kernel_s_limits(S, dh,
                                                                    chunk):
    """Chunk 512 and dh 520, which the Pallas kernel computes and the
    card's kernel takes by its sliced routes (``plan``'s ``sliced``): the
    CPU wrapper's plain version against the Pallas kernel and the
    oracle."""
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

def _rank_sum(parts):
    """The partials summed in the order given, as a CTA of the cluster pass
    adds the ranks' partial S it reads: ((p0 + p1) + p2) + ..."""
    total = torch.zeros_like(parts[0])
    for part in parts:
        total = total + part
    return total


def _cluster_scores(qs, kc, cluster, rotated=False):
    """S = q.k^T as each of the ``cluster`` CTAs of the cluster pass holds
    it: rank r's partial over its own columns (``ops.cluster_columns``),
    the partials summed in rank order 0, 1, ... by every CTA (or, with
    ``rotated``, from the CTA's own partial on, as a CTA that began with
    what it had would sum them). One S per CTA."""
    parts = [mm3(qs[..., a:b], kc[..., a:b].transpose(-1, -2))
             for a, b in ops.cluster_columns(qs.shape[-1], cluster)]
    return [_rank_sum(parts[r:] + parts[:r] if rotated else parts)
            for r in range(cluster)]


def _sm90_emulate(q, k, v, lf, li, chunk, keys=None, ctas=None,
                  cluster=None):
    """What csrc/mlstm_scan_sm90.cu computes, pass by pass. Returns h in q's
    dtype and the scalars (m entering each chunk, the row stabilizers m_i
    and the rows' intra-chunk maxima). With ``keys``, ``ctas`` and
    ``cluster`` the outputs pass is the cluster one
    (outputs_cluster_kernel): the ``ctas`` CTAs of a row tile split the
    output columns (``ops.cluster_columns``); the chunk's keys go in slices
    of ``keys``, each S the rank-order sum of the ``cluster`` ranks'
    partials over their own columns of q and k (``_cluster_scores``; every
    group of ``cluster`` CTAs takes the same S), P with the scalar pass's
    m_i (no rescale), its row sums added over the key slices; q.n over all
    of dh in every CTA; q.C_prev and P.V over each CTA's columns."""
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
        w = torch.where(causal, torch.exp(dlog[:, :, c]
                                          - Mi[:, :, c, :, None]),
                        torch.tensor(0.0))
        qn = (qs[:, :, c] * ns[c][:, :, None, :]).sum(-1) * Sf[:, :, c]
        if keys is None:
            s = mm3(qs[:, :, c], kc[:, :, c].transpose(-1, -2))
            P = w * s
            den = P.sum(-1) + qn
            O = mm3(qs[:, :, c], Cs[c]) * Sf[:, :, c, :, None] \
                + mm3(P, vc[:, :, c])
        else:
            cols = [slice(a, b) for a, b in ops.cluster_columns(dh, ctas)]
            O = torch.zeros(B, H, L, dh)
            for ce in cols:
                O[..., ce] = mm3(qs[:, :, c], Cs[c][..., ce]) \
                    * Sf[:, :, c, :, None]
            den = torch.zeros(B, H, L)
            for j0 in range(0, L, keys):
                kj = slice(j0, min(L, j0 + keys))
                S_ = _cluster_scores(qs[:, :, c], kc[:, :, c, kj],
                                     cluster)[0]
                P = w[..., kj] * S_
                den = den + P.sum(-1)
                for ce in cols:
                    O[..., ce] = O[..., ce] + mm3(P, vc[:, :, c, kj, ce])
            den = den + qn
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
    (2, 2, 2, 64, 16, "float16"),
    (1, 2, 3, 96, 64, "float16"),
])
def test_sm90_emulation_matches_the_pallas_kernel(B, H, nc, dh, chunk,
                                                  dtype):
    S = nc * chunk
    x = _inputs(np.random.RandomState(dh * 7 + S), B, H, S, dh)
    jx, tx = _jax(x), _torch(x)
    tol = F32_TOL
    if dtype in LOW:
        jdt, tdt, tol = LOW[dtype]
        jx[:3] = [a.astype(jdt) for a in jx[:3]]
        tx[:3] = [t.to(tdt) for t in tx[:3]]
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
    """Past the old limits (chunk 257, dh 513) the wrapper's checks pass and
    the plan takes the cluster route, the states' stride rounded up to 128
    and one CTA per 512 columns (264 and 249 columns here, 33 and 32
    units), the keys in slices of 128; the CPU path computes the shape; a
    device with no kernel still raises."""
    p = ops.plan(514, ops.BLOCK_DH + 1, 257)
    assert p["sliced"] and (p["nt"], p["dhp"], p["bn"]) == (6, 640, 128)
    assert (p["cluster"], p["ctas"], p["cols"], p["padded"]) == (2, 2, 264, 7)
    assert (p["key_slices"], p["lp"]) == (3, ops.CLUSTER_KEYS)
    assert ops.cluster_columns(513, 2) == [(0, 264), (264, 513)]
    p = ops.plan(514, 8, 257)
    assert p["sliced"] and (p["nt"], p["dhp"], p["bn"]) == (1, 64, 64)
    assert (p["cluster"], p["ctas"], p["key_slices"]) == (1, 1, 3)
    gates = torch.zeros(1, 1, 514)
    long = torch.zeros(1, 1, 514, 8)
    assert ops.mlstm_scan(long, long, long, gates, gates,
                          chunk=257).shape == long.shape
    with pytest.raises(ValueError, match="no kernel for meta"):
        m = [t.to("meta") for t in (long, long, long, gates, gates)]
        ops.mlstm_scan(*m, chunk=2)
    with pytest.raises(ValueError, match="no kernel for meta"):
        m = [t.to("meta") for t in (long, long, long, gates, gates)]
        ops.mlstm_scan(*m, chunk=257)


SLICED_CASES = [
    # B, H, nc, dh, chunk, keys, ctas, cluster, dtype
    (1, 2, 2, 16, 64, 16, 2, 2, "float32"),    # 4 key slices, 2 CTAs of 8
    (1, 1, 1, 40, 48, 16, 3, 3, "float32"),    # ragged: 16, 16, 8; one chunk
    (2, 1, 3, 24, 32, 8, 3, 3, "float32"),
    (1, 2, 2, 40, 32, 16, 5, 5, "float32"),    # five ranks of 8 columns
    (1, 2, 2, 32, 64, 32, 4, 2, "bfloat16"),   # two groups of 2 take S anew
    (1, 1, 2, 16, 48, 16, 2, 2, "float16"),
    (1, 2, 2, 24, 48, 32, 3, 3, "float16"),    # ragged key slices
]


@pytest.mark.parametrize("B,H,nc,dh,chunk,keys,ctas,cluster,dtype",
                         SLICED_CASES)
def test_sm90_sliced_outputs_match_the_pallas_kernel(B, H, nc, dh, chunk,
                                                     keys, ctas, cluster,
                                                     dtype):
    """The cluster outputs pass (``ctas`` CTAs splitting the output
    columns, S the rank-order sum of ``cluster`` ranks' partials, key
    slices of ``keys``, as the card's kernel runs past chunk 256 or dh
    512) against the Pallas kernel in interpret mode and the single-block
    emulation, at slice widths of 8-32 so that dh and chunk <= 64 take
    several CTAs and key slices."""
    S = nc * chunk
    x = _inputs(np.random.RandomState(dh * 11 + S), B, H, S, dh)
    jx, tx = _jax(x), _torch(x)
    tol = F32_TOL
    if dtype in LOW:
        jdt, tdt, tol = LOW[dtype]
        jx[:3] = [a.astype(jdt) for a in jx[:3]]
        tx[:3] = [t.to(tdt) for t in tx[:3]]
    kernel = np.asarray(jmlstm_scan(*jx, chunk=chunk, interpret=True)
                        .astype(jnp.float32))
    got, _ = _sm90_emulate(*tx, chunk, keys=keys, ctas=ctas,
                           cluster=cluster)
    whole, _ = _sm90_emulate(*tx, chunk)
    np.testing.assert_allclose(got.float().numpy(), kernel, **tol)
    np.testing.assert_allclose(got.float().numpy(), whole.float().numpy(),
                               **tol)


def test_a_long_chunk_is_one_chunk_in_key_slices():
    """The cluster route computes a chunk of 64 as one chunk (its keys in
    slices of 32, the stabilizer m_i from the scalar pass), as the Pallas
    kernel takes chunk=64, including where the floor of the denominator
    binds (m_i at -40). Splitting it into two chunks of 32 would be another
    computation: it agrees here only to rounding (m_i is the running
    maximum of the log weights either way, floored at -40), which the
    route does not rely on."""
    rng = np.random.RandomState(21)
    x = list(_inputs(rng, 1, 2, 128, 16, 1e-8, 1e-6))
    x[4] = (rng.randn(1, 2, 128) * 2.0 - 42.0).astype(np.float32)
    x[4][0, 1, 40] = 9.0             # a large input gate mid-chunk
    kernel = np.asarray(jmlstm_scan(*_jax(x), chunk=64, interpret=True))
    got, sc = _sm90_emulate(*_torch(x), 64, keys=32, ctas=2, cluster=2)
    assert bool((sc["m_i"] == MMIN).any()) and bool((sc["m_i"] > MMIN).any())
    np.testing.assert_allclose(got.numpy(), kernel, **F32_TOL)
    one = mlstm_scan_ref(*_torch(x), chunk=64).numpy()
    two = mlstm_scan_ref(*_torch(x), chunk=32).numpy()
    np.testing.assert_allclose(one, kernel, **F32_TOL)
    np.testing.assert_allclose(two, one, **F32_TOL)


@pytest.mark.parametrize("dh,cluster", [(40, 3), (64, 4), (24, 2)])
def test_cluster_scores_and_den_are_the_same_bits_in_every_cta(dh, cluster):
    """Every CTA of a cluster sums the ranks' partial S in rank order 0, 1,
    ..., n - 1, so every CTA holds the same bits of S, of P and of the
    denominator it divides by. Build-free, the kernel's exchange is pinned:
    in s_phase each CTA starts from zeros and adds the partial of rank r =
    0 .. ncl - 1 read at mapa(src, r), an order its own rank does not
    enter. That order matters: a CTA that began with its own partial (the
    rotated order) would hold other bits on these inputs with three
    partials or more (two partials commute exactly)."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "mlstm_scan_sm90.cu").read_text()
    phase = src[src.index("auto s_phase = [&](int ks, int& job) {"):]
    phase = phase[:phase.index("// P to fragment order")]
    loop = re.search(r"float S\[2\]\[2\]\[4\] = \{\};\n"
                     r"    const uint32_t src = smem_u32\(part\);\n"
                     r"    for \(int r = 0; r < ncl; \+\+r\) \{.*?\n    \}\n",
                     phase, re.S)
    assert loop, "the rank-order exchange is not in s_phase"
    body = loop.group(0)
    assert "const uint32_t at = mapa(src, (uint32_t)r);" in body
    code = re.sub(r"//[^\n]*", "", body)          # the comments aside
    assert code.count("ld_cluster4(at + ") == 1 and "rank" not in code
    assert all(f"S[m][n][{e}] += v.{c};" in body
               for e, c in enumerate("xyzw"))
    q, k, _, lf, li = _torch(_inputs(np.random.RandomState(dh), 1, 1, 64,
                                     dh))
    qs = q[0, 0] * dh ** -0.5
    F = torch.cumsum(lf[0, 0].double(), 0).float()
    w = torch.where(torch.ones(64, 64, dtype=torch.bool).tril(),
                    torch.exp((F[:, None] - F[None, :]) + li[0, 0][None, :]
                              - 1.0), torch.tensor(0.0))
    parts = [mm3(qs[:, a:b], k[0, 0][:, a:b].T)
             for a, b in ops.cluster_columns(dh, cluster)]
    every = _cluster_scores(qs, k[0, 0], cluster)
    assert len(every) == cluster > 1
    assert all(torch.equal(s, _rank_sum(parts)) for s in every)
    rotated = _cluster_scores(qs, k[0, 0], cluster, rotated=True)
    dens = [(w * s).sum(-1) for s in rotated]
    if cluster > 2:
        assert any(not torch.equal(s, every[0]) for s in rotated[1:])
        assert any(not torch.equal(d, (w * every[0]).sum(-1))
                   for d in dens[1:])
    else:
        assert all(torch.equal(s, every[0]) for s in rotated)


@pytest.mark.parametrize("dh", [1, 8, 40, 64, 65, 128])
@pytest.mark.parametrize("chunk", [257, 512, 1024])
def test_narrow_heads_take_the_64_column_instance(dh, chunk):
    """Past chunk 256 a head of 64 columns or fewer runs on the cluster
    pass's 64-column instance (nt = 1, one CTA a cluster), whose row tile's
    q, split once, fits beside the stages; wider heads take nt >= 2."""
    p = ops.plan(2 * chunk, dh, chunk)
    assert p["sliced"] and (p["cluster"], p["ctas"]) == (1, 1)
    assert p["nt"] == (1 if dh <= 64 else 2)
    assert p["smem_outputs"] == ops.cluster_smem(p["nt"]) <= ops.MAX_SMEM
    if dh <= 64:      # q's hi and lo hold all 64 columns of the row tile
        assert ops.cluster_smem(1) == 4 * (
            ops.OUT_STAGES * ops.cluster_stage(1) + 2 * ops.ROWS * 64
            + 2 * ops.ROWS * ops.CLUSTER_KEYS + 4 * ops.ROWS
            + 2 * ops.CLUSTER_KEYS + 8 * ops.ROWS + 4 * ops.ROWS)


@pytest.mark.parametrize("dh", [1280, 1288, 1536, 2048, 4096, 4100, 8192])
def test_past_dh_1280_every_cta_adds_q_c_in_fresh_accumulators(dh):
    """Past dh ``FRESH_DH`` a CTA holds 256 columns at most, so every CTA
    is an instance of ``FRESH_TILES`` n tiles or fewer, which adds each
    32-wide slice of q.C_prev in fresh accumulators (one accumulator over
    all of dh drifted past the float32 bar); up to it the plan is the
    512-column rule."""
    p = ops.plan(128, dh, 64)
    if dh <= ops.FRESH_DH:
        assert p["nt"] == 8 and p["ctas"] == -(-dh // ops.BLOCK_DH)
        return
    assert p["nt"] <= ops.FRESH_TILES and p["cols"] <= 256
    assert p["ctas"] == -(-(-(-dh // 256)) // p["cluster"]) * p["cluster"]
    assert p["cluster"] == min(-(-dh // 256), ops.MAX_CLUSTER)


def test_plan_and_the_kernel_source_agree():
    """Build-free: the wrapper's block limits, cluster size, key slice and
    cluster tiles are the source's (kMaxChunk, kMaxDh, kMaxCluster, kKeys,
    kFreshDh, kFreshNt, make_plan's rule and the cluster kernel's
    instances), the sliced kernel is gone, and past the limits the plan
    takes every dh to 8192 in clusters of ceil(dh / 512) CTAs, or past dh
    1280 ceil(dh / 256) (groups of 8 past 8), the columns shared evenly in
    8-column units, so that no CTA computes more than 7 columns past dh (at
    most 63 was the bar) and none more than 512; past dh 1280 every CTA is
    one that adds q.C_prev's slices in fresh accumulators."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "mlstm_scan_sm90.cu").read_text()
    consts = dict(re.findall(
        r"constexpr int (kMaxChunk|kMaxDh|kMaxCluster|kKeys|kFreshDh|kFreshNt)"
        r" = (\d+);", src))
    assert consts == {"kMaxChunk": str(ops.BLOCK_CHUNK),
                      "kMaxDh": str(ops.BLOCK_DH),
                      "kMaxCluster": str(ops.MAX_CLUSTER),
                      "kKeys": str(ops.CLUSTER_KEYS),
                      "kFreshDh": str(ops.FRESH_DH),
                      "kFreshNt": str(ops.FRESH_TILES)}
    inst = {int(n) for n in re.findall(r"outputs_cluster_kernel<T, (\d+)>",
                                       src)}
    assert inst == set(ops.CLUSTER_TILES)
    assert "outputs_sliced_kernel" not in src
    assert "    if constexpr (NT <= kFreshNt) {" in src
    for text in ("const int most = dh > kFreshDh ? 64 * kFreshNt : kMaxDh;",
                 "const int ctas = (dh + most - 1) / most;",
                 "p.ncl = ctas < kMaxCluster ? ctas : kMaxCluster;",
                 "p.npr = (ctas + p.ncl - 1) / p.ncl * p.ncl;",
                 "const int tiles8 = (share + kWarpsN3 - 1) / kWarpsN3;",
                 "p.nt = tiles8 == 1 ? 1 : (tiles8 + 1) / 2 * 2;",
                 "(dh + 127) / 128 * 128"):
        assert text in src
    assert "dh > kMaxDh || chunk <= 0" not in src     # the old refusal
    for dh in (1, 8, 64, 65, 256, 257, 512, 513, 520, 768, 1000, 1024, 1280,
               2047, 4096, 4097, 6000, 8192):
        for chunk in (1, 64, 256, 257, 512, 1024):
            p = ops.plan(4 * chunk, dh, chunk)
            assert p["dhp"] >= dh and p["dhp"] % p["bn"] == 0
            assert p["smem_outputs"] <= ops.MAX_SMEM
            if not p["sliced"]:
                assert p["nt"] in ops.OUTPUT_TILES and 64 * p["nt"] >= dh
                continue
            need = -(-dh // (256 if dh > 1280 else ops.BLOCK_DH))
            assert dh <= 1280 or p["nt"] <= ops.FRESH_TILES
            assert p["cluster"] == min(need, ops.MAX_CLUSTER)
            assert p["ctas"] == -(-need // p["cluster"]) * p["cluster"]
            assert p["groups"] == 1 or p["cluster"] == ops.MAX_CLUSTER
            cols = ops.cluster_columns(dh, p["ctas"])
            assert [a for a, _ in cols[1:]] == [b for _, b in cols[:-1]]
            assert cols[0][0] == 0 and cols[-1][1] == dh
            widths = [b - a for a, b in cols]
            units = [-(-w // 8) for w in widths]   # even: one unit apart
            assert max(units) - min(units) <= 1
            assert max(widths) <= p["cols"] <= ops.BLOCK_DH
            # the CTA's columns are its warps' unit tiles: the least nt
            assert p["nt"] in ops.CLUSTER_TILES
            assert 64 * (p["nt"] - 2) < p["cols"] <= 64 * p["nt"]
            # computed past dh: the last unit's ragged part only
            assert p["padded"] == 8 * -(-dh // 8) - dh <= 63
            s_cols = [b - a for a, b in ops.cluster_columns(dh,
                                                            p["cluster"])]
            assert max(s_cols) <= ops.BLOCK_DH * p["groups"]
            assert p["key_slices"] == -(-chunk // ops.CLUSTER_KEYS)


def test_mlstm_variants_edits_match_the_kernel_source(monkeypatch):
    """benchmarks_torch/mlstm_variants.py's variants of the cluster outputs
    pass still apply to csrc/mlstm_scan_sm90.cu as it is (build-free):
    each edit matches once, each variant differs from the source, a stale
    edit raises, and the plan of the 256-column variant fits the source's
    shared-memory rule."""
    from benchmarks_torch import mlstm_variants as mv
    texts = mv.variant_sources(list(mv.VARIANTS))
    assert set(texts) == {mv.SRC, *mv.VARIANTS}
    for name, text in texts.items():
        if name != mv.SRC:
            assert text != texts[mv.SRC], name
    assert set(mv.PROBES) <= set(mv.VARIANTS)
    p = mv.PLANS["k3_cols256"](2048, 1024, 256)
    assert (p["cluster"], p["ctas"], p["nt"]) == (4, 4, 4)
    assert p["smem_outputs"] == ops.cluster_smem(4) <= ops.MAX_SMEM
    monkeypatch.setitem(mv.VARIANTS, "stale", [("no such text", "")])
    with pytest.raises(ValueError, match="no longer matches"):
        mv.variant_sources(["stale"])


def test_mlstm_variants_refuses_to_run_without_a_card(monkeypatch):
    from benchmarks_torch import mlstm_variants as mv
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        mv.main([])


@pytest.mark.parametrize("S,dh,chunk", [(2048, 1024, 256), (1024, 384, 512),
                                        (512, 8, 256)])
def test_baselines_sliced_plan_is_the_774e907_rule(S, dh, chunk):
    """benchmarks_torch/baselines.py launches commit 774e907's K3 past the
    old limits with that commit's plan (column slices of 64 nt, nt 1, 4 or
    8, P tiles of up to 256 keys, its shared memory); inside them the plan
    as it is."""
    from benchmarks_torch import baselines
    p = baselines.sliced_plan(S, dh, chunk)
    if not ops.plan(S, dh, chunk)["sliced"]:
        assert p == ops.plan(S, dh, chunk)
        return
    nt = 1 if dh <= 64 else 4 if dh <= 256 else 8
    assert (p["nt"], p["lp"]) == (nt, min(-(-chunk // 64) * 64, 256))
    assert p["col_slices"] == -(-dh // (64 * nt))
    assert p["smem_outputs"] == ops.outputs_smem(64 * nt, p["lp"]) <= \
        ops.MAX_SMEM
