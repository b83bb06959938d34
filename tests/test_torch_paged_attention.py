"""Port's paged attention (plain version) vs the JAX Pallas kernel in
interpret mode, plus the wrapper's CPU routing. An emulation of the sm90
kernel's split-and-combine arithmetic (csrc/paged_attention_sm90.cu) is held
against the Pallas kernel too, beside the kernel's split choice and route
rule. The CUDA kernels themselves are held against the plain version on the
card by chip_smoke.py."""
import functools
import inspect
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.paged_attention.kernel import paged_attention as jax_kernel
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

# tests/test_kernels.py tolerances
F32_TOL = dict(atol=2e-5, rtol=2e-4)
BF16_TOL = dict(atol=2e-3, rtol=2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _inputs(seed, B, Hq, Hkv, d, page, n_slots, P, lengths=None):
    rng = np.random.RandomState(seed)
    if lengths is None:
        lengths = rng.randint(1, page * n_slots + 1, (B,))
    return dict(q=rng.randn(B, Hq, d).astype(np.float32),
                k=rng.randn(P, Hkv, page, d).astype(np.float32),
                v=rng.randn(P, Hkv, page, d).astype(np.float32),
                pt=rng.randint(0, P, (B, n_slots)).astype(np.int32),
                lengths=np.asarray(lengths, np.int32))


def _run_jax(x, jdt, softcap=0.0):
    out = jax_kernel(jnp.asarray(x["q"], jdt), jnp.asarray(x["k"], jdt),
                     jnp.asarray(x["v"], jdt), jnp.asarray(x["pt"]),
                     jnp.asarray(x["lengths"]), softcap=softcap,
                     interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _run_port(x, tdt, softcap=0.0, fn=paged_attention_ref):
    out = fn(torch.from_numpy(x["q"]).to(tdt), torch.from_numpy(x["k"]).to(tdt),
             torch.from_numpy(x["v"]).to(tdt), torch.from_numpy(x["pt"]),
             torch.from_numpy(x["lengths"]), softcap=softcap)
    return out.float().numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,Hq,Hkv,d,page,n_slots,P", [
    (2, 4, 2, 64, 16, 4, 32),
    (3, 8, 8, 32, 8, 6, 64),
    (1, 6, 2, 128, 32, 3, 16),
    (4, 2, 1, 64, 8, 8, 40),
])
def test_ref_matches_pallas_kernel(B, Hq, Hkv, d, page, n_slots, P, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x = _inputs(0, B, Hq, Hkv, d, page, n_slots, P)
    np.testing.assert_allclose(_run_port(x, tdt), _run_jax(x, jdt), **tol)


def test_ref_matches_pallas_kernel_softcap_gqa():
    x = _inputs(3, 2, 8, 4, 64, 8, 4, 12)
    np.testing.assert_allclose(_run_port(x, torch.float32, softcap=50.0),
                               _run_jax(x, jnp.float32, softcap=50.0),
                               **F32_TOL)


def test_length_zero_gives_zeros_like_the_kernel():
    """The Pallas kernel returns 0 for an empty sequence (the JAX ref.py
    returns the mean of v); the port follows the kernel."""
    x = _inputs(1, 3, 4, 2, 32, 8, 3, 16, lengths=[0, 5, 24])
    jax_out = _run_jax(x, jnp.float32)
    port = _run_port(x, torch.float32)
    assert np.all(jax_out[0] == 0.0)
    assert np.all(port[0] == 0.0)
    np.testing.assert_allclose(port, jax_out, **F32_TOL)


def test_ids_past_the_length_are_never_read():
    x = _inputs(2, 2, 4, 4, 32, 8, 5, 20, lengths=[9, 16])
    ref = _run_port(x, torch.float32)
    x["pt"][0, 2:] = -1          # slot 2 starts at 16 >= 9
    x["pt"][1, 2:] = 10 ** 6     # slot 2 starts at 16 >= 16
    np.testing.assert_array_equal(_run_port(x, torch.float32), ref)


def test_bad_id_inside_the_length_raises():
    x = _inputs(2, 1, 2, 2, 32, 8, 2, 4, lengths=[12])
    x["pt"][0, 1] = 4
    with pytest.raises(IndexError):
        _run_port(x, torch.float32)


def test_ops_routes_cpu_tensors_to_plain_path_without_counting():
    x = _inputs(4, 2, 4, 2, 64, 16, 4, 32)
    before = ops.paged_attention.launches
    for name in DTYPES:
        _, tdt, _ = DTYPES[name]
        np.testing.assert_array_equal(
            _run_port(x, tdt, fn=ops.paged_attention), _run_port(x, tdt))
    assert ops.paged_attention.launches == before


@pytest.mark.parametrize("bad", ["dtype", "mixed", "table", "group",
                                 "head_dim", "layout"])
def test_ops_rejects_what_the_kernel_does_not_take(bad):
    x = _inputs(5, 2, 4, 2, 32, 8, 3, 16)
    q, k, v = (torch.from_numpy(x[n]) for n in ("q", "k", "v"))
    pt, ln = torch.from_numpy(x["pt"]), torch.from_numpy(x["lengths"])
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed":
        k = k.to(torch.bfloat16)
    elif bad == "table":
        pt = pt.long()
    elif bad == "group":
        q = torch.zeros(2, 18, 32)
    elif bad == "head_dim":
        q, k, v = torch.zeros(2, 4, 512), torch.zeros(16, 2, 8, 512), \
            torch.zeros(16, 2, 8, 512)
    else:
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((TypeError, ValueError)):
        ops.paged_attention(q, k, v, pt, ln)


# --- the sm90 kernel (csrc/paged_attention_sm90.cu): split arithmetic, split
# choice and route ------------------------------------------------------------

def _split_emulate(q, k, v, pt, lengths, softcap=0.0, pps=1):
    """The sm90 kernel's split-and-combine arithmetic in plain PyTorch.

    Each run of ``pps`` slots is a split; a split whose run starts at or
    past the length is not live. A live split walks its pages with one max
    and one rescale per page tile (float32 m, l, acc) and stops with m = NaN
    at a page id outside [0, P). With one split the partial is the output;
    otherwise the live partials merge by the log-sum-exp rule, NaN if one is
    NaN, 0 if none is live. (The kernel's warps also split each page's keys
    and merge at the end; that changes only the order of sums.)"""
    B, Hq, d = q.shape
    P, Hkv, page, _ = k.shape
    g, n_slots = Hq // Hkv, pt.shape[1]
    n_split = -(-n_slots // pps)
    qf = q.float().reshape(B, Hkv, g, d) / math.sqrt(d)
    out = torch.zeros(B, Hkv, g, d)
    for b in range(B):
        n_keys = min(max(int(lengths[b]), 0), n_slots * page)
        n_pages = -(-n_keys // page)
        parts = []
        for s in range(-(-n_pages // pps)):                 # live splits
            m = torch.full((Hkv, g), -math.inf)
            l, acc = torch.zeros(Hkv, g), torch.zeros(Hkv, g, d)
            for slot in range(s * pps, min((s + 1) * pps, n_pages)):
                pid = int(pt[b, slot])
                if not 0 <= pid < P:
                    m = torch.full((Hkv, g), math.nan)
                    break
                t_end = min(page, n_keys - slot * page)
                sc = torch.einsum("hgd,htd->hgt", qf[b],
                                  k[pid, :, :t_end].float())
                if softcap:
                    sc = softcap * torch.tanh(sc / softcap)
                m_new = torch.maximum(m, sc.amax(-1))
                corr = torch.exp(m - m_new)
                p = torch.exp(sc - m_new[..., None])
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "hgt,htd->hgd", p, v[pid, :, :t_end].float())
                m = m_new
            parts.append((acc, m, l))
        if not parts:
            continue                                        # length 0: 0
        if n_split == 1:
            acc, m, l = parts[0]
            out[b] = torch.where(torch.isnan(m)[..., None], math.nan,
                                 acc / l.clamp_min(1e-30)[..., None])
            continue
        ms = torch.stack([m for _, m, _ in parts])
        M = ms.amax(0)
        w = torch.exp(ms - M)
        L = (torch.stack([l for _, _, l in parts]) * w).sum(0)
        A = (torch.stack([a for a, _, _ in parts]) * w[..., None]).sum(0)
        out[b] = torch.where(torch.isnan(ms).any(0)[..., None], math.nan,
                             A / L.clamp_min(1e-30)[..., None])
    return out.reshape(B, Hq, d).to(q.dtype)


SPLIT_CASES = {
    # name: (B, Hq, Hkv, d, page, n_slots, P, lengths, pps, dtype, softcap)
    "split_1_page": (3, 4, 2, 64, 8, 6, 32, None, 1, "float32", 0.0),
    "split_2_pages": (3, 4, 2, 64, 8, 6, 32, None, 2, "float32", 0.0),
    "split_3_pages": (3, 4, 2, 64, 8, 6, 32, None, 3, "float32", 0.0),
    "one_split": (3, 4, 2, 64, 8, 6, 32, None, 6, "float32", 0.0),
    "length_0": (3, 4, 2, 32, 8, 6, 32, [0, 13, 48], 2, "float32", 0.0),
    "ends_on_split_boundary": (3, 4, 2, 32, 8, 6, 32, [16, 32, 33], 2,
                               "float32", 0.0),
    "empty_trailing_splits": (3, 4, 2, 32, 8, 8, 32, [5, 9, 17], 2,
                              "float32", 0.0),
    "gqa4_bf16_softcap": (2, 8, 2, 64, 16, 5, 24, None, 2, "bfloat16", 30.0),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_arithmetic_matches_pallas_kernel(case):
    B, Hq, Hkv, d, page, n_slots, P, lengths, pps, dtype, cap = \
        SPLIT_CASES[case]
    jdt, tdt, tol = DTYPES[dtype]
    x = _inputs(7, B, Hq, Hkv, d, page, n_slots, P, lengths)
    got = _run_port(x, tdt, softcap=cap,
                    fn=functools.partial(_split_emulate, pps=pps))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _run_jax(x, jdt, softcap=cap), **tol)
    if lengths is not None and 0 in lengths:
        assert np.all(got[lengths.index(0)] == 0.0)


@pytest.mark.parametrize("pps", [1, 2, 4])
def test_split_arithmetic_bad_id_gives_nan_on_its_sequence_only(pps):
    x = _inputs(8, 3, 4, 2, 32, 8, 4, 16, lengths=[30, 25, 7])
    want = _run_port(x, torch.float32)
    x["pt"][1, 2] = 16           # slot 2 starts at 16 < 25
    x["pt"][2, 3] = -5           # past the length of 7: never read
    got = _run_port(x, torch.float32,
                    fn=functools.partial(_split_emulate, pps=pps))
    assert np.isnan(got[1]).all()
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], **F32_TOL)


def test_pages_per_split_never_takes_lengths():
    assert list(inspect.signature(ops._pages_per_split).parameters) == \
        ["B", "Hkv", "n_slots", "n_sm"]


@pytest.mark.parametrize("B,Hkv,n_slots,n_sm", [
    (1, 1, 1, 132), (1, 2, 37, 132), (8, 2, 8, 132), (32, 4, 16, 132),
    (32, 20, 36, 132), (32, 20, 18, 132), (3, 5, 1000, 132),
    (64, 8, 100, 132), (5, 1, 7, 16)])
def test_pages_per_split_covers_the_slots(B, Hkv, n_slots, n_sm):
    pps = ops._pages_per_split(B, Hkv, n_slots, n_sm)
    n_split = -(-n_slots // pps)
    assert 1 <= pps <= n_slots
    assert (n_split - 1) * pps < n_slots <= n_split * pps
    if B * Hkv >= ops.SPLIT_BLOCKS_PER_SM * n_sm:
        assert n_split == 1          # the pairs already fill the card
    else:                        # within the rounding of pps, the target
        assert 2 * B * Hkv * n_split >= min(ops.SPLIT_BLOCKS_PER_SM * n_sm,
                                            B * Hkv * n_slots)


def test_pages_per_split_at_the_main_path_shapes():
    # serving: B=32 sequences x 20 kv heads fill 132 SMs: one split
    assert ops._pages_per_split(32, 20, 36, 132) == 36
    # kernel bench: 16 and 128 (sequence, kv head) pairs are split
    assert ops._pages_per_split(8, 2, 8, 132) == 1
    assert ops._pages_per_split(32, 4, 16, 132) == 4


def _pool(P, Hkv, page, d, dtype=torch.float32):
    return torch.zeros(P, Hkv, page, d, dtype=dtype)


@pytest.mark.parametrize("shape,dtype", [
    ((2048, 20, 16, 128), torch.float32),     # serving (Qwen1.5-4B pools)
    ((128, 2, 64, 128), torch.float32),       # kernel bench
    ((1024, 4, 16, 64), torch.float32),       # kernel bench
    ((64, 4, 16, 256), torch.bfloat16),       # gemma2 widths
    ((32, 2, 16, 80), torch.float32),
    ((16, 2, 8, 16), torch.float32),
    ((16, 2, 8, 32), torch.bfloat16),
])
def test_sm90_route_takes_the_main_path_and_test_shapes(shape, dtype):
    k = _pool(*shape, dtype=dtype)
    assert ops._sm90_ok(k, k.clone())


@pytest.mark.parametrize("bad", ["misaligned", "row_off_16_bytes",
                                 "bf16_row_off_16_bytes", "page_keys",
                                 "page_bytes"])
def test_other_shapes_keep_the_simt_route(bad):
    if bad == "misaligned":      # base 4 bytes past an aligned address
        k = torch.zeros(8 * 2 * 16 * 32 + 1)[1:].view(8, 2, 16, 32)
    elif bad == "row_off_16_bytes":
        k = _pool(8, 2, 16, 6)                    # 24-byte rows
    elif bad == "bf16_row_off_16_bytes":
        k = _pool(8, 2, 16, 12, torch.bfloat16)   # 24-byte rows
    elif bad == "page_keys":
        k = _pool(2, 1, ops.SM90_MAX_PAGE * 2, 4)
    else:
        k = _pool(2, 1, 64, 256)                  # 64 KiB pages
    assert not ops._sm90_ok(k, _pool(*k.shape, dtype=k.dtype))


def test_serve_pools_take_the_sm90_route_at_every_layer():
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.serving import paged_lm
    cfg = reduced(get_config("qwen1.5-4b"))
    pools = paged_lm.init_pools(cfg, 12, 16, device="cpu")
    assert all(ops._sm90_ok(pools["k"][li].float(), pools["v"][li].float())
               for li in range(cfg.n_layers))


def test_cpu_tensors_reach_no_launcher_and_move_no_count(monkeypatch):
    def refuse():
        raise AssertionError("a CPU tensor reached a kernel launcher")
    monkeypatch.setattr(ops, "_launcher", refuse)
    monkeypatch.setattr(ops, "_launcher_sm90", refuse)
    x = _inputs(6, 2, 4, 2, 64, 16, 4, 32)
    counts = (ops.paged_attention.launches,
              ops.paged_attention.launches_sm90)
    got = _run_port(x, torch.float32, fn=ops.paged_attention)
    assert counts == (ops.paged_attention.launches,
                      ops.paged_attention.launches_sm90)
    np.testing.assert_array_equal(got, _run_port(x, torch.float32))


def test_paged_call_time_refuses_to_run_without_a_card(monkeypatch):
    from benchmarks_torch import paged_call_time
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        paged_call_time.main([])
