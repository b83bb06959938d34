"""Port's paged attention (plain version and the public wrapper on CPU
tensors) vs the JAX Pallas kernel in interpret mode, at every group size,
head dim, page size and pool alignment the kernel must take, plus the
wrapper's CPU routing. An emulation of the sm90 kernel's group tiles,
stages and split-and-combine arithmetic (csrc/paged_attention_sm90.cu) is
held against the Pallas kernel too, beside the kernel's split choice, tile
rows (against the kernel source's launch switch) and how the pools are
staged. The CUDA kernel itself is held against the plain
version on the card by chip_smoke.py."""
import functools
import inspect
import math
import re
from pathlib import Path

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


def _off(t, elts):
    """t's values in a tensor whose base lies ``elts`` elements past an
    aligned address (a pool off 16-byte alignment)."""
    flat = torch.empty(t.numel() + elts, dtype=t.dtype)
    return flat[elts:].view(t.shape).copy_(t)


def _run_jax(x, jdt, softcap=0.0):
    out = jax_kernel(jnp.asarray(x["q"], jdt), jnp.asarray(x["k"], jdt),
                     jnp.asarray(x["v"], jdt), jnp.asarray(x["pt"]),
                     jnp.asarray(x["lengths"]), softcap=softcap,
                     interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _run_port(x, tdt, softcap=0.0, fn=paged_attention_ref, off=0):
    k, v = (torch.from_numpy(x[n]).to(tdt) for n in ("k", "v"))
    if off:
        k, v = _off(k, off), _off(v, off)
    out = fn(torch.from_numpy(x["q"]).to(tdt), k, v,
             torch.from_numpy(x["pt"]), torch.from_numpy(x["lengths"]),
             softcap=softcap)
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


@pytest.mark.parametrize("bad", ["dtype", "mixed", "table", "layout"])
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
    else:
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((TypeError, ValueError)):
        ops.paged_attention(q, k, v, pt, ln)


# --- every shape the Pallas kernel takes: groups above 8, MQA, head dims
# above 256, large pages, narrow rows, pools off alignment --------------------

def _wrapper_vs_pallas(x, dtype, softcap=0.0, off=0):
    """The public wrapper on CPU tensors against the Pallas kernel."""
    jdt, tdt, tol = DTYPES[dtype]
    got = _run_port(x, tdt, softcap=softcap, fn=ops.paged_attention, off=off)
    np.testing.assert_allclose(got, _run_jax(x, jdt, softcap=softcap), **tol)
    return got


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("g,Hkv", [(g, Hkv) for g in (9, 12, 16, 48, 71)
                                   for Hkv in (1, 4, 8)])
def test_wrapper_matches_pallas_at_large_groups(g, Hkv, dtype):
    x = _inputs(10, 2, g * Hkv, Hkv, 16, 8, 3, 12, lengths=[0, 19])
    got = _wrapper_vs_pallas(x, dtype, softcap=30.0)
    assert np.all(got[0] == 0.0)                 # length 0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("page", [16, 512])
@pytest.mark.parametrize("d", [64, 128, 320, 512])
def test_wrapper_matches_pallas_at_head_dims_and_pages(d, page, dtype):
    x = _inputs(11, 2, 4, 2, d, page, 2, 6, lengths=[0, page + 7])
    got = _wrapper_vs_pallas(x, dtype, softcap=50.0)
    assert np.all(got[0] == 0.0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["rows_of_24_bytes", "pages_of_64_KiB",
                                  "pools_4_bytes_off"])
def test_wrapper_matches_pallas_at_narrow_rows_big_pages_misaligned(case,
                                                                   dtype):
    elt = 4 if dtype == "float32" else 2
    off = 0
    if case == "rows_of_24_bytes":
        x = _inputs(12, 3, 18, 2, 24 // elt, 16, 4, 16, lengths=[0, 37, 64])
    elif case == "pages_of_64_KiB":
        x = _inputs(12, 2, 4, 2, 256, 65536 // (256 * elt), 2, 6,
                    lengths=[100, 190])
    else:
        x = _inputs(12, 3, 4, 2, 32, 16, 4, 16, lengths=[20, 64, 41])
        off = 4 // elt
    _wrapper_vs_pallas(x, dtype, softcap=30.0, off=off)


@pytest.mark.parametrize("Hq,Hkv,d,page", [(71, 1, 16, 8), (4, 2, 512, 16),
                                           (8, 2, 32, 512)])
def test_wrapper_raises_at_a_bad_id_inside_the_length(Hq, Hkv, d, page):
    """The plain version's convention (the kernel's NaN is held by the
    split emulation below and by chip_smoke.py on the card)."""
    x = _inputs(13, 2, Hq, Hkv, d, page, 3, 6, lengths=[page + 1, 2])
    x["pt"][0, 1] = 6
    x["pt"][1, 2] = -1                           # past the length of 2
    with pytest.raises(IndexError):
        _run_port(x, torch.float32, fn=ops.paged_attention)


def test_head_dim_limit_is_the_kernel_s_alone():
    """``_check_kernel``, which only the CUDA branch calls, refuses a head
    dim past ``KERNEL_MAX_HEAD_DIM``; the CPU path computes it."""
    ops._check_kernel(ops.KERNEL_MAX_HEAD_DIM)
    with pytest.raises(ValueError, match="head_dim <= 2048"):
        ops._check_kernel(ops.KERNEL_MAX_HEAD_DIM + 1)
    x = _inputs(14, 1, 2, 1, ops.KERNEL_MAX_HEAD_DIM + 8, 4, 2, 4,
                lengths=[6])
    _wrapper_vs_pallas(x, "float32")


# --- the sm90 kernel (csrc/paged_attention_sm90.cu): group tiles, stages,
# split arithmetic, split choice, tile rows, staging -------------------------

def _keys_per_stage(page, d, elt):
    """Keys of K (and of V) in one ring stage of the kernel: a whole page
    up to 32 KiB, else as many rows (padded to 16 bytes) as fit 32 KiB (the
    source's make_plan)."""
    return min(page, 32768 // (-(-d * elt // 16) * 16))


def _split_emulate(q, k, v, pt, lengths, softcap=0.0, pps=1):
    """The sm90 kernel's tile, stage and split-and-combine arithmetic in
    plain PyTorch.

    The g query rows of a kv head run in group tiles of ``ops.tile_rows``
    rows, the last one partial where that does not divide g; each tile is
    a block of its own. Each run of ``pps`` slots is a split; a split whose
    run starts at or past the length is not live. A live split walks the
    live keys of its pages in ring stages of ``_keys_per_stage`` keys with
    one max and one rescale per stage (float32 m, l, acc) and stops with m
    = NaN at a page id outside [0, P). With one split the partial is the
    output; otherwise the live partials merge by the log-sum-exp rule, NaN
    if one is NaN, 0 if none is live. (The kernel's warps also split each
    stage's keys and merge at the end; that changes only the order of
    sums.)"""
    B, Hq, d = q.shape
    P, Hkv, page, _ = k.shape
    g, n_slots = Hq // Hkv, pt.shape[1]
    rows = ops.tile_rows(g, d, q.element_size())
    R = _keys_per_stage(page, d, q.element_size())
    n_split = -(-n_slots // pps)
    qf = q.float().reshape(B, Hkv, g, d) / math.sqrt(d)
    out = torch.zeros(B, Hkv, g, d)
    for b in range(B):
        n_keys = min(max(int(lengths[b]), 0), n_slots * page)
        n_pages = -(-n_keys // page)
        for t0 in range(0, g, rows):                        # group tiles
            tile = slice(t0, min(g, t0 + rows))
            G = tile.stop - t0
            parts = []
            for s in range(-(-n_pages // pps)):             # live splits
                m = torch.full((Hkv, G), -math.inf)
                l, acc = torch.zeros(Hkv, G), torch.zeros(Hkv, G, d)
                for slot in range(s * pps, min((s + 1) * pps, n_pages)):
                    pid = int(pt[b, slot])
                    if not 0 <= pid < P:
                        m = torch.full((Hkv, G), math.nan)
                        break
                    t_end = min(page, n_keys - slot * page)
                    for r0 in range(0, t_end, R):           # ring stages
                        keys = slice(r0, min(t_end, r0 + R))
                        sc = torch.einsum("hgd,htd->hgt", qf[b, :, tile],
                                          k[pid, :, keys].float())
                        if softcap:
                            sc = softcap * torch.tanh(sc / softcap)
                        m_new = torch.maximum(m, sc.amax(-1))
                        corr = torch.exp(m - m_new)
                        p = torch.exp(sc - m_new[..., None])
                        l = l * corr + p.sum(-1)
                        acc = acc * corr[..., None] + torch.einsum(
                            "hgt,htd->hgd", p, v[pid, :, keys].float())
                        m = m_new
                parts.append((acc, m, l))
            if not parts:
                continue                                    # length 0: 0
            if n_split == 1:
                acc, m, l = parts[0]
                out[b, :, tile] = torch.where(
                    torch.isnan(m)[..., None], math.nan,
                    acc / l.clamp_min(1e-30)[..., None])
                continue
            ms = torch.stack([m for _, m, _ in parts])
            M = ms.amax(0)
            w = torch.exp(ms - M)
            L = (torch.stack([l for _, _, l in parts]) * w).sum(0)
            A = (torch.stack([a for a, _, _ in parts]) * w[..., None]).sum(0)
            out[b, :, tile] = torch.where(
                torch.isnan(ms).any(0)[..., None], math.nan,
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
    # group tiles: 8 + 1 rows (a partial last tile); MQA g=71, nine tiles,
    # the last of 7; g=12 at d=320, three tiles of 4
    "tiles_g9_partial_last": (3, 18, 2, 32, 8, 6, 32, None, 2, "float32",
                              0.0),
    "tiles_mqa_g71_bf16_softcap": (2, 71, 1, 16, 8, 4, 16, [0, 27], 2,
                                   "bfloat16", 30.0),
    "tiles_g12_d320": (2, 24, 2, 320, 8, 4, 16, [29, 17], 1, "float32",
                       0.0),
    # pages staged in pieces: 64 keys a stage of a 512-key page; d=2048
    # bf16, 8 keys a stage and a tile of 1 row
    "stages_page_512": (2, 4, 2, 128, 512, 2, 8, [70, 1000], 1, "float32",
                        0.0),
    "stages_d2048_bf16": (1, 4, 1, 2048, 16, 3, 8, [37], 2, "bfloat16",
                          0.0),
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


@pytest.mark.parametrize("pps", [1, 2])
def test_split_arithmetic_bad_id_gives_nan_in_every_tile(pps):
    x = _inputs(9, 3, 18, 1, 32, 8, 4, 16, lengths=[30, 25, 7])
    want = _run_port(x, torch.float32)
    x["pt"][1, 2] = 16           # slot 2 starts at 16 < 25
    got = _run_port(x, torch.float32,
                    fn=functools.partial(_split_emulate, pps=pps))
    assert np.isnan(got[1]).all()            # all 18 rows, three tiles
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], **F32_TOL)


@pytest.mark.parametrize("g,d,elt,rows", [
    (1, 128, 4, 1), (3, 80, 4, 4), (4, 128, 4, 4), (8, 256, 4, 8),
    (8, 256, 2, 8), (9, 128, 4, 8), (12, 128, 4, 8), (16, 128, 2, 8),
    (48, 128, 4, 8), (71, 64, 4, 8), (2, 512, 4, 2), (2, 512, 2, 2),
    (8, 320, 4, 4), (8, 320, 2, 4), (8, 576, 4, 2), (9, 1024, 4, 2),
    (9, 1024, 2, 2), (9, 2048, 4, 1), (9, 2048, 2, 1), (6, 6, 4, 8)])
def test_tile_rows_fit_a_lane_and_cover_the_group(g, d, elt, rows):
    assert ops.tile_rows(g, d, elt) == rows
    vec, nv = 16 // elt, -(-d * elt // 16)
    nvl = 1 << max(0, -(-nv // 32) - 1).bit_length()   # vectors a lane
    assert rows * nvl * vec <= ops.MAX_LANE_FLOATS
    assert rows == ops.MAX_TILE_ROWS or rows >= g or \
        2 * rows * nvl * vec > ops.MAX_LANE_FLOATS
    tiles = -(-g // rows)
    assert (tiles - 1) * rows < g <= tiles * rows


_SM90_SRC = (Path(ops.__file__).resolve().parents[2] / "csrc"
             / "paged_attention_sm90.cu")


def _source_plan():
    """The kernel source's tile limits and, per element size, the (G, NVL)
    pairs its launch switch instantiates (``PA_CASE(G, NVL)``)."""
    src = _SM90_SRC.read_text()
    consts = {name: int(v) for name, v in re.findall(
        r"constexpr int (kMaxRows|kMaxLaneFloats) = (\d+);", src)}
    f32, bf16 = src.split("switch (G * 100 + pl.nvl)")[1:3]
    pairs = {elt: {(int(a), int(b)) for a, b in
                   re.findall(r"PA_CASE\((\d+), (\d+)\)", part)}
             for elt, part in ((4, f32), (2, bf16.split("}")[0]))}
    return consts, pairs


def _pick_nvl(G, vec, nv):
    """The source's pick_nvl: vectors per lane for G rows."""
    nvl = 4
    while nvl > 1 and G * nvl * vec > 32:
        nvl //= 2
    while nvl * 32 < nv:
        nvl *= 2
    return nvl


def test_tile_rows_and_the_kernel_source_agree():
    """Build-free: the wrapper's tile limits are the source's, and every
    (rows, vectors per lane) pair that a head dim up to the card's limit
    and any group size give has an instance in the launch switch; one
    past that head dim breaks the source's lane rule in float32."""
    consts, pairs = _source_plan()
    assert consts == {"kMaxRows": ops.MAX_TILE_ROWS,
                      "kMaxLaneFloats": ops.MAX_LANE_FLOATS}
    for elt in (4, 2):
        vec, seen = 16 // elt, set()
        for d in range(1, ops.KERNEL_MAX_HEAD_DIM + 1):
            nv = -(-d * elt // 16)
            lane = 1 << max(0, -(-nv // 32) - 1).bit_length()
            for g in (1, 2, 3, 4, 5, 8, 9, 71):
                G = ops.tile_rows(g, d, elt)
                assert G * lane * vec <= ops.MAX_LANE_FLOATS   # make_plan
                seen.add((G, _pick_nvl(G, vec, nv)))
        assert seen == pairs[elt], elt
    nv = -(-(ops.KERNEL_MAX_HEAD_DIM + 1) * 4 // 16)
    assert (1 << (-(-nv // 32) - 1).bit_length()) * 4 > ops.MAX_LANE_FLOATS


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
    # Qwen3-235B-A22B's 64/4 heads at B=32: 4 kv heads x 2 tiles of 8
    assert ops._pages_per_split(32, 4 * 2, 36, 132) == 12


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
    """The main path's and the tests' pools are staged by bulk copies."""
    k = _pool(*shape, dtype=dtype)
    assert ops._bulk_copies(k, k.clone())


@pytest.mark.parametrize("case,bulk", [
    ("misaligned", False), ("row_off_16_bytes", False),
    ("bf16_row_off_16_bytes", False), ("bf16_base_2_bytes_off", False),
    ("bf16_rows_of_14_bytes", False), ("page_keys", True),
    ("page_bytes", True)])
def test_other_pools_take_the_producer_warp_s_loads(case, bulk):
    """Pools a bulk copy cannot read are staged by the producer warp's
    2-byte loads; pages over 256 keys or 32 KiB are still bulk copies, a
    stage holding part of a page."""
    if case == "misaligned":      # base 4 bytes past an aligned address
        k = _off(_pool(8, 2, 16, 32), 1)
    elif case == "row_off_16_bytes":
        k = _pool(8, 2, 16, 6)                    # 24-byte rows
    elif case == "bf16_row_off_16_bytes":
        k = _pool(8, 2, 16, 12, torch.bfloat16)   # 24-byte rows
    elif case == "bf16_base_2_bytes_off":
        k = _off(_pool(8, 2, 16, 32, torch.bfloat16), 1)
    elif case == "bf16_rows_of_14_bytes":
        k = _pool(8, 2, 16, 7, torch.bfloat16)
    elif case == "page_keys":
        k = _pool(2, 1, 512, 4)
    else:
        k = _pool(2, 1, 64, 256)                  # 64 KiB pages
    assert ops._bulk_copies(k, k) == bulk
    # one pool a bulk copy cannot read is enough
    assert ops._bulk_copies(_pool(*k.shape, dtype=k.dtype), k) == bulk


def test_serve_pools_take_the_sm90_route_at_every_layer():
    """The serve path's pools are staged by bulk copies at every layer."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.serving import paged_lm
    cfg = reduced(get_config("qwen1.5-4b"))
    pools = paged_lm.init_pools(cfg, 12, 16, device="cpu")
    assert all(ops._bulk_copies(pools["k"][li].float(),
                                pools["v"][li].float())
               for li in range(cfg.n_layers))


def test_cpu_tensors_reach_no_launcher_and_move_no_count(monkeypatch):
    def refuse():
        raise AssertionError("a CPU tensor reached a kernel launcher")
    monkeypatch.setattr(ops, "_launcher_sm90", refuse)
    for x in (_inputs(6, 2, 4, 2, 64, 16, 4, 32),
              _inputs(6, 2, 71, 1, 32, 8, 3, 12)):      # g = 71
        count = ops.paged_attention.launches
        got = _run_port(x, torch.float32, fn=ops.paged_attention)
        assert ops.paged_attention.launches == count
        np.testing.assert_array_equal(got, _run_port(x, torch.float32))


def test_paged_call_time_refuses_to_run_without_a_card(monkeypatch):
    from benchmarks_torch import paged_call_time
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        paged_call_time.main([])
