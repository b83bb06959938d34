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
from tf32_split import mm3

from repro.kernels.paged_attention.kernel import paged_attention as jax_kernel
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

# tests/test_kernels.py tolerances
F32_TOL = dict(atol=2e-5, rtol=2e-4)
BF16_TOL = dict(atol=2e-3, rtol=2e-2)
F16_TOL = dict(atol=1e-3, rtol=2e-3)    # float16: 11 significant bits
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL),
          "float16": (jnp.float16, torch.float16, F16_TOL)}


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
    if bad == "dtype":      # float64 (float16 is taken, as the TPU's is)
        q, k, v = q.double(), k.double(), v.double()
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
    """No head dim is refused any more: past 2048 (where a row no longer
    fits a lane group's registers) the card's kernel takes the wide route,
    in slices of ``WIDE_COLS`` columns, and the CPU path computes the same
    shape; what a CUDA-less device still gets is a refusal to launch."""
    for elt in (4, 2):
        assert not ops.wide_route(2048, elt) and ops.wide_route(2049, elt)
        assert ops.n_slices(2048, elt) == 1
        assert ops.n_slices(2056, elt) == 2
        assert ops.n_slices(16384, elt) == 8
        assert ops.tile_rows(8, 2056, elt) == 8
        assert ops.tile_rows(3, 16384, elt) == 4
    x = _inputs(14, 1, 2, 1, 2048 + 8, 4, 2, 4, lengths=[6])
    _wrapper_vs_pallas(x, "float32")
    meta = {n: torch.from_numpy(a).to("meta") for n, a in x.items()}
    with pytest.raises(ValueError, match="no kernel for meta"):
        ops.paged_attention(meta["q"], meta["k"], meta["v"], meta["pt"],
                            meta["lengths"])


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
    "gqa4_f16_softcap": (2, 8, 2, 64, 16, 5, 24, None, 2, "float16", 30.0),
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
    "tiles_g16_f16_length_0": (2, 32, 2, 128, 16, 4, 16, [0, 50], 2,
                               "float16", 0.0),
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
    (rows, vectors per lane) pair that a head dim of the register route
    and any group size give has an instance in the launch switch; the
    first head dim past it breaks the source's lane rule at one row (its
    ``wide_route``), and the wide route has an instance for every tile of
    rows ``tile_rows`` gives there, with the source's slice width."""
    consts, pairs = _source_plan()
    assert consts == {"kMaxRows": ops.MAX_TILE_ROWS,
                      "kMaxLaneFloats": ops.MAX_LANE_FLOATS}
    src = _SM90_SRC.read_text()
    assert f"constexpr int kWideCols = {ops.WIDE_COLS};" in src
    assert f"constexpr int kMaxCluster = {ops.CLUSTER_MAX};" in src
    wide_g = {int(g) for g in re.findall(r"case (\d+): err = launch_wide",
                                         src)}
    for elt in (4, 2):
        vec, seen = 16 // elt, set()
        d = 1
        while not ops.wide_route(d, elt):
            nv = -(-d * elt // 16)
            lane = 1 << max(0, -(-nv // 32) - 1).bit_length()
            for g in (1, 2, 3, 4, 5, 8, 9, 71):
                G = ops.tile_rows(g, d, elt)
                assert G * lane * vec <= ops.MAX_LANE_FLOATS   # make_plan
                seen.add((G, _pick_nvl(G, vec, nv)))
            d += 1
        assert seen == pairs[elt], elt
        assert d == 2049                     # the register route's last: 2048
        nv = -(-d * elt // 16)
        assert (1 << (-(-nv // 32) - 1).bit_length()) * vec \
            > ops.MAX_LANE_FLOATS
        for dw in (d, 4096, 16384, 65536 + 3):
            assert {ops.tile_rows(g, dw, elt)
                    for g in (1, 2, 3, 4, 5, 8, 9, 71)} == wide_g
    # every block index of the attention kernels lies in the grid's x; only
    # the combine kernel's y cuts a row's columns (at most 65,535 chunks)
    body, combine = src.split("paged_attention_sm90_combine(", 1)
    combine = combine.split("// ---- the mma route", 1)[0]
    assert "blockIdx.y" not in body and "blockIdx.z" not in src
    assert src.count("blockIdx.y") == combine.count("blockIdx.y") == 1
    assert src.count("65535") == 2 and "chunks < 65535 ? chunks : 65535" in src


# --- the wide route (d > 2048 on the card): output slices, scores streamed
# over the full d, keys in chunks --------------------------------------------

LOG2E = 1.4426950408889634


def _wide_partials(qt, kr, cols, cluster):
    """The wide route's partial scores of each CTA of a cluster, for the
    tile's q rows qt (G, d) and a chunk's K rows kr (keys, d): d in slices
    of ``cols`` columns, CTA r of a cluster of n = min(slices, ``cluster``)
    summing slices r, r + n, ... in that order (past one cluster each
    group's CTA r takes the same ones). Returns (partials by rank, slices
    with the last group's padding)."""
    d = qt.shape[-1]
    n_sl = -(-d // cols)
    n = min(n_sl, cluster)
    parts = []
    for r in range(n):
        p = None
        for s in range(r, n_sl, n):
            c = slice(s * cols, (s + 1) * cols)
            t = qt[:, c] @ kr[:, c].T
            p = t if p is None else p + t
        parts.append(p)
    return parts, -(-n_sl // n) * n


def _wide_scores(parts, n_slp, rotated=False):
    """The scores each CTA (by slice, padding included) holds after the
    exchange: the partials summed in rank order 0, 1, ..., n - 1
    (``rotated``: from its own rank on, which the kernel must not do)."""
    n = len(parts)
    out = []
    for sl in range(n_slp):
        order = ([(sl % n + i) % n for i in range(n)] if rotated
                 else range(n))
        x = None
        for r in order:
            x = parts[r].clone() if x is None else x + parts[r]
        out.append(x)
    return out


def _wide_emulate(q, k, v, pt, lengths, softcap=0.0, pps=1,
                  cols=ops.WIDE_COLS, keys=32, cluster=ops.CLUSTER_MAX):
    """What the sm90 kernel's wide route computes, block by block: per
    (sequence, kv head, group tile of ``tile_rows``, split of ``pps``
    slots) a cluster of CTAs, one per slice of ``cols`` columns (at most
    ``cluster``; past that in groups, the last padded), walking the split's
    live keys in chunks of ``keys``: each CTA's partial scores over its
    slices (``_wide_partials``), the scores summed in rank order in every
    CTA (``_wide_scores``: the same bits in every slice, asserted), scaled
    to log2 units, the softcap in log2 units, the chunk's max and the
    running max and sum, p.V over the CTA's own slice. A bad id inside
    the length gives NaN; the splits merge by the combine kernel's
    log-sum-exp rule. ``cols`` and ``keys`` are arguments so that a small
    d takes several slices and a short sequence several chunks."""
    B, Hq, d = q.shape
    P, Hkv, page, _ = k.shape
    g = Hq // Hkv
    rows = ops.tile_rows(g, max(d, 2049), q.element_size())
    n_slots = pt.shape[1]
    n_split = -(-n_slots // pps)
    n_sl = -(-d // cols)
    scale = LOG2E / math.sqrt(d)
    cap_in = math.log(2) / softcap if softcap else 0.0
    qf = q.float().reshape(B, Hkv, g, d)
    out = torch.zeros(B, Hkv, g, d)
    for b in range(B):
        n_keys = min(max(int(lengths[b]), 0), n_slots * page)
        for h in range(Hkv):
            for t0 in range(0, g, rows):
                qt = qf[b, h, t0:t0 + rows]                 # (G, d)
                parts = []
                for s in range(n_split):
                    k0, k1 = s * pps * page, min(n_keys, (s + 1) * pps * page)
                    if k1 <= k0:
                        continue                            # not live
                    acc = torch.zeros(len(qt), d)
                    m = torch.full((len(qt),), -math.inf)
                    l = torch.zeros(len(qt))
                    for c0 in range(k0, k1, keys):
                        pos = range(c0, min(k1, c0 + keys))
                        ids = [int(pt[b, p // page]) for p in pos]
                        if any(not 0 <= i < P for i in ids):
                            m = l = torch.full((len(qt),), math.nan)
                            break
                        kr = torch.stack([k[i, h, p % page].float()
                                          for i, p in zip(ids, pos)])
                        vr = torch.stack([v[i, h, p % page].float()
                                          for i, p in zip(ids, pos)])
                        every = _wide_scores(*_wide_partials(qt, kr, cols,
                                                             cluster))
                        # every slice holds the same bits: one m and l
                        assert all(torch.equal(x, every[0]) for x in every)
                        x = every[0] * scale
                        if cap_in:
                            x = torch.tanh(x * cap_in) / cap_in
                        m_new = torch.maximum(m, x.amax(-1))
                        corr = torch.exp2(m - m_new)
                        p_ = torch.exp2(x - m_new[:, None])
                        l = l * corr + p_.sum(-1)
                        for sl in range(n_sl):             # each CTA's slice
                            c = slice(sl * cols, min(d, (sl + 1) * cols))
                            acc[:, c] = acc[:, c] * corr[:, None] + \
                                p_ @ vr[:, c]
                        m = m_new
                    parts.append((acc, m, l))
                if not parts:
                    continue                                # length 0: 0
                M = torch.stack([m for _, m, _ in parts]).amax(0)
                L = sum(l * torch.exp2(m - M) for _, m, l in parts)
                A = sum(a * torch.exp2(m - M)[:, None] for a, m, _ in parts)
                out[b, h, t0:t0 + rows] = A / L.clamp_min(1e-30)[:, None]
    return out.reshape(B, Hq, d).to(q.dtype)


WIDE_CASES = {
    # name: (B, Hq, Hkv, d, page, n_slots, P, lengths, pps, cols, keys,
    #        dtype, softcap, cluster)
    "g1_three_slices": (2, 2, 2, 40, 8, 4, 16, None, 4, 16, 8, "float32",
                        0.0, 8),
    "g8_two_slices_chunks": (2, 8, 1, 32, 8, 5, 16, [37, 19], 5, 16, 8,
                             "float32", 0.0, 8),
    "g8_softcap_split": (2, 16, 2, 48, 8, 6, 24, [40, 13], 2, 16, 8,
                         "float32", 30.0, 8),
    "g3_partial_tile_bf16": (2, 6, 2, 64, 16, 3, 12, None, 1, 16, 32,
                             "bfloat16", 0.0, 8),
    "g8_f16_length_0_split": (3, 8, 1, 24, 8, 4, 16, [0, 29, 8], 1, 8, 8,
                              "float16", 30.0, 8),
    "slice_wider_than_d": (2, 4, 2, 24, 8, 4, 16, None, 2, 2048, 32,
                           "float32", 0.0, 8),
    # past one cluster's reach: 80 / 16 = 5 slices in clusters of 2 (three
    # groups, the last padded); 56 / 8 = 7 in clusters of 3, bf16 softcap
    "two_groups_g8_f32": (2, 8, 1, 80, 8, 5, 16, [37, 19], 2, 16, 8,
                          "float32", 0.0, 2),
    "three_groups_g3_bf16_softcap": (2, 6, 2, 56, 16, 3, 12, None, 1, 8, 32,
                                     "bfloat16", 30.0, 3),
}


@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_wide_route_arithmetic_matches_pallas_kernel(case):
    """The wide route's tiling (slices of ``cols`` columns in clusters of
    CTAs, the partial scores summed in rank order, keys in chunks, splits
    merged) against the Pallas kernel in interpret mode, at slice widths
    of 8 and 16 so that d <= 80 runs in several slices, and past one
    cluster's reach (clusters of 2 and 3, slices in padded groups)."""
    (B, Hq, Hkv, d, page, n_slots, P, lengths, pps, cols, keys, dtype,
     cap, cluster) = WIDE_CASES[case]
    jdt, tdt, tol = DTYPES[dtype]
    x = _inputs(17, B, Hq, Hkv, d, page, n_slots, P, lengths)
    got = _run_port(x, tdt, softcap=cap, fn=functools.partial(
        _wide_emulate, pps=pps, cols=cols, keys=keys, cluster=cluster))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _run_jax(x, jdt, softcap=cap), **tol)
    if lengths is not None and 0 in lengths:
        assert np.all(got[lengths.index(0)] == 0.0)


@pytest.mark.parametrize("d,cols,cluster", [(16384, 2048, 8),
                                            (18432, 2048, 8), (80, 16, 2),
                                            (56, 8, 3)])
def test_wide_scores_are_the_same_bits_in_every_slice(d, cols, cluster):
    """Every CTA of a cluster sums the partial scores in rank order 0, 1,
    ..., n - 1, so every slice holds the same bits of the scores (and so of
    m and l; slice 0 alone writes them to the workspace). A CTA that began
    with its own partial would not: with three partials or more the
    rotated sums differ in some bits on these inputs, which is why the
    kernel fixes the order (two partials commute exactly)."""
    rng = np.random.RandomState(20)
    qt = torch.from_numpy(rng.randn(8, d).astype(np.float32))
    kr = torch.from_numpy(rng.randn(32, d).astype(np.float32))
    parts, n_slp = _wide_partials(qt, kr, cols, cluster)
    assert len(parts) > 1 and n_slp % len(parts) == 0
    every = _wide_scores(parts, n_slp)
    assert all(torch.equal(x, every[0]) for x in every)
    rotated = _wide_scores(parts, n_slp, rotated=True)
    assert torch.equal(rotated[0], every[0])
    if len(parts) > 2:           # a + b == b + a: two partials commute
        assert any(not torch.equal(x, every[0]) for x in rotated[1:])
    else:
        assert all(torch.equal(x, every[0]) for x in rotated)


@pytest.mark.parametrize("pps", [1, 4])
def test_wide_route_bad_id_gives_nan_on_its_sequence_only(pps):
    x = _inputs(18, 3, 8, 2, 32, 8, 4, 16, lengths=[30, 25, 7])
    want = _run_port(x, torch.float32)
    x["pt"][1, 2] = 16           # slot 2 starts at 16 < 25
    x["pt"][2, 3] = -5           # past the length of 7: never read
    got = _run_port(x, torch.float32, fn=functools.partial(
        _wide_emulate, pps=pps, cols=16, keys=8))
    assert np.isnan(got[1]).all()
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], **F32_TOL)


# --- the mma route (g >= 8 at d <= 256 on the card): row tiles of up to 64
# rows, warps as row groups x key groups, the products on the tensor cores --

def _tc_product(a, b, dtype):
    """a @ b as the route's tensor cores take it: 2-byte operands (exact in
    float32, so a float32 product summed in float32) or 3xTF32."""
    if dtype == torch.float32:
        return mm3(a, b)
    return a.float() @ b.float()


def _mma_emulate(q, k, v, pt, lengths, softcap=0.0, pps=1):
    """What the sm90 kernel's mma route computes, block by block: per
    (sequence, kv head, row tile of ``ops.mma_tile_rows`` rows, split of
    ``pps`` slots) the tile's rows held by ``ops.mma_row_groups`` row groups
    of 16 x MW rows (rows past g zero); the split's live keys in ring stages
    of ``_keys_per_stage`` keys, cut into units of 16 keys, unit n of the
    block (counted across stages) going to key group n mod (4 / row
    groups). Per warp and unit: S = q.K^T in the input type's products
    (3xTF32 in float32), the scale log2(e) / sqrt(d) after the product, the
    softcap in log2 units, keys past the stage's live rows to -inf, the
    online softmax in log2 units; P.V with P rounded once (float16), as
    P_hi + P_lo (bfloat16) or 3xTF32 (float32). Then the row group's warps
    merge (a warp that saw no key skipped), a bad id gives NaN, and the
    splits combine by the log-sum-exp rule."""
    B, Hq, d = q.shape
    P, Hkv, page, _ = k.shape
    g, n_slots = Hq // Hkv, pt.shape[1]
    elt, dt = q.element_size(), q.dtype
    TR = ops.mma_tile_rows(g)
    _, MW = ops.mma_shape(TR, d)
    WR = 16 * MW
    R = _keys_per_stage(page, d, elt)
    scale = LOG2E / math.sqrt(d)
    cap_in = math.log(2) / softcap if softcap else 0.0
    n_split = -(-n_slots // pps)
    out = torch.zeros(B, Hq, d)
    for b in range(B):
        n_keys = min(max(int(lengths[b]), 0), n_slots * page)
        for h in range(Hkv):
            for t0 in range(0, g, TR):
                rows = min(TR, g - t0)
                n_rg = ops.mma_row_groups(rows, MW)
                n_kg = 4 // n_rg
                qt = torch.zeros(n_rg * WR, d, dtype=dt)
                qt[:rows] = q[b, h * g + t0:h * g + t0 + rows]
                parts = []
                for s in range(n_split):
                    k0 = s * pps * page
                    k1 = min(n_keys, (s + 1) * pps * page)
                    if k1 <= k0:
                        continue                            # not live
                    # warps [row group][key group]: m, l, acc
                    m = torch.full((n_kg, n_rg * WR), -math.inf)
                    l = torch.zeros(n_kg, n_rg * WR)
                    acc = torch.zeros(n_kg, n_rg * WR, d)
                    bad, u = False, 0
                    for slot in range(s * pps, -(-k1 // page)):
                        pid = int(pt[b, slot])
                        if not 0 <= pid < P:
                            bad = True
                            break
                        t_end = min(page, n_keys - slot * page)
                        for r0 in range(0, t_end, R):       # ring stages
                            nr = min(R, t_end - r0)
                            nu = -(-nr // 16)
                            for j in range(nu):             # units
                                kg = (u + j) % n_kg
                                keys = slice(r0 + 16 * j,
                                             r0 + min(nr, 16 * j + 16))
                                kk = k[pid, h, keys]
                                x = _tc_product(qt, kk.T, dt) * scale
                                if cap_in:
                                    x = torch.tanh(x * cap_in) / cap_in
                                m_new = torch.maximum(m[kg], x.amax(-1))
                                corr = torch.exp2(m[kg] - m_new)
                                p_ = torch.exp2(x - m_new[:, None])
                                vv = v[pid, h, keys]
                                if dt == torch.float16:
                                    pv = _tc_product(p_.half(), vv, dt)
                                elif dt == torch.bfloat16:
                                    hi = p_.bfloat16()
                                    lo = (p_ - hi.float()).bfloat16()
                                    pv = (_tc_product(lo, vv, dt)
                                          + _tc_product(hi, vv, dt))
                                else:
                                    pv = _tc_product(p_, vv, dt)
                                l[kg] = l[kg] * corr + p_.sum(-1)
                                acc[kg] = acc[kg] * corr[:, None] + pv
                                m[kg] = m_new
                            u += nu
                    if bad:
                        parts.append((None, None, None))
                        continue
                    # the row group's warps merge
                    M = m.amax(0)
                    w = torch.where(m == -math.inf, 0.0, torch.exp2(m - M))
                    parts.append(((acc * w[..., None]).sum(0)[:rows],
                                  M[:rows], (l * w).sum(0)[:rows]))
                rows_out = slice(h * g + t0, h * g + t0 + rows)
                if not parts:
                    continue                                # length 0: 0
                if any(a is None for a, _, _ in parts):
                    out[b, rows_out] = math.nan
                    continue
                M = torch.stack([m_ for _, m_, _ in parts]).amax(0)
                L = sum(l_ * torch.exp2(m_ - M) for _, m_, l_ in parts)
                A = sum(a * torch.exp2(m_ - M)[:, None] for a, m_, _ in parts)
                out[b, rows_out] = A / L.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


MMA_CASES = {
    # name: (B, Hq, Hkv, d, page, n_slots, P, lengths, pps, softcap)
    "g12": (2, 24, 2, 128, 16, 4, 16, [0, 53], 1, 0.0),
    "g16_softcap": (2, 16, 1, 128, 16, 4, 12, [37, 64], 2, 30.0),
    "g48": (2, 48, 1, 128, 16, 3, 8, [45, 9], 1, 0.0),
    "g71_d64": (2, 71, 1, 64, 16, 3, 8, [0, 41], 2, 0.0),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(MMA_CASES))
def test_mma_route_arithmetic_matches_pallas_kernel(case, dtype):
    """The mma route's tiling and products (``_mma_emulate``) against the
    Pallas kernel in interpret mode at g = 12 (two kv heads), 16 (softcap),
    48 (one tile of two row groups of 32) and 71 (d = 64: tiles of 64 and 7
    rows), with a length of 0, several splits and partial units; each
    type's bar (tests/test_kernels.py's, and 11 significant bits for
    float16)."""
    B, Hq, Hkv, d, page, n_slots, P, lengths, pps, cap = MMA_CASES[case]
    jdt, tdt, tol = DTYPES[dtype]
    assert ops.mma_route(Hq // Hkv, d, 4 if dtype == "float32" else 2)
    x = _inputs(20, B, Hq, Hkv, d, page, n_slots, P, lengths)
    got = _run_port(x, tdt, softcap=cap, fn=functools.partial(
        _mma_emulate, pps=pps))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _run_jax(x, jdt, softcap=cap), **tol)
    if 0 in lengths:
        assert np.all(got[lengths.index(0)] == 0.0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mma_route_takes_g8(dtype):
    """qwen1.5-110b's group (g = 8) runs on the mma route: a row tile of 16
    rows, 8 of them padding, pages of 8 keys (half units); g = 7 stays on
    the register route."""
    jdt, tdt, tol = DTYPES[dtype]
    elt = 4 if dtype == "float32" else 2
    assert ops.mma_route(8, 128, elt) and not ops.mma_route(7, 128, elt)
    assert ops.group_tile_rows(8, 128, elt) == 16
    assert ops.group_tile_rows(7, 128, elt) == ops.tile_rows(7, 128, elt)
    x = _inputs(21, 2, 16, 2, 128, 8, 4, 16, lengths=[30, 11])
    got = _run_port(x, tdt, fn=functools.partial(_mma_emulate, pps=2))
    np.testing.assert_allclose(got, _run_jax(x, jdt), **tol)


@pytest.mark.parametrize("pps", [1, 2])
def test_mma_route_bad_id_gives_nan_on_its_sequence_only(pps):
    """A page id outside [0, P) inside sequence 1's length: NaN in all of its
    rows (both row tiles of g = 71), the other sequences as the plain
    version; an id past sequence 2's length is never read."""
    x = _inputs(22, 3, 71, 1, 32, 8, 4, 16, lengths=[30, 25, 7])
    want = _run_port(x, torch.float32)
    x["pt"][1, 2] = 16           # slot 2 starts at 16 < 25
    x["pt"][2, 3] = -5           # past the length of 7: never read
    got = _run_port(x, torch.float32,
                    fn=functools.partial(_mma_emulate, pps=pps))
    assert np.isnan(got[1]).all()
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], **F32_TOL)


def test_mma_route_and_the_kernel_source_agree():
    """Build-free: the wrapper's mma rule is the source's (its constants and
    its route line), ``group_tile_rows`` gives the C entry a tile over
    ``MAX_TILE_ROWS`` exactly on the mma route (the entry's route switch),
    every tile covers g in whole m16 tiles, and the (head dims, m16 tiles a
    warp) pairs that every g and d <= 256 give are the source's launch
    switch's ``MMA_CASE`` instances."""
    src = _SM90_SRC.read_text()
    consts = {n: int(v) for n, v in re.findall(
        r"constexpr int (kMmaMinGroup|kMmaMaxD|kMmaMaxRows) = (\d+);", src)}
    assert consts == {"kMmaMinGroup": ops.MMA_MIN_GROUP,
                      "kMmaMaxD": ops.MMA_MAX_D,
                      "kMmaMaxRows": ops.MMA_MAX_ROWS}
    assert ("return elt > 0 && g >= kMmaMinGroup && d >= 1 && d <= kMmaMaxD;"
            in src)
    assert "const bool mma = tile_rows > kMaxRows;" in src
    cases = {(int(a), int(b)) for a, b in re.findall(
        r"MMA_CASE\((\d+), (\d+)\)", src)}
    seen = set()
    for elt in (4, 2):
        for d in (*range(1, 260, 3), 64, 128, 256, 257):
            for g in (*range(1, 80), 128):
                rows = ops.group_tile_rows(g, d, elt)
                if not ops.mma_route(g, d, elt):
                    assert rows == ops.tile_rows(g, d, elt)
                    assert rows <= ops.MAX_TILE_ROWS
                    assert d > ops.MMA_MAX_D or g < ops.MMA_MIN_GROUP
                    continue
                assert rows == ops.mma_tile_rows(g) > ops.MAX_TILE_ROWS
                assert rows % 16 == 0 and rows <= ops.MMA_MAX_ROWS
                tiles = -(-g // rows)
                assert (tiles - 1) * rows < g <= tiles * rows
                dinst, mw = ops.mma_shape(rows, d)
                assert d <= dinst and mw * dinst <= 256
                seen.add((dinst, mw))
                for t in range(tiles):   # every tile's row groups: 4 warps
                    n_rg = ops.mma_row_groups(min(rows, g - t * rows), mw)
                    assert n_rg in (1, 2, 4)
                    assert n_rg * 16 * mw >= min(rows, g - t * rows)
    assert seen == cases


@pytest.mark.parametrize("n_tiles,n_sl,n_split,Hkv,B", [
    (1, 1, 1, 1, 1), (3, 1, 2, 4, 5), (2, 3, 2, 2, 3), (9, 1, 1, 1, 2),
    (1, 1, 1, 1, 65543), (1, 1, 1, 65539, 1), (2, 8, 3, 2, 2),
    (1, 1, 4, 3, 65536 + 7), (2, 16, 3, 1, 2), (3, 4, 2, 2, 3)])
def test_paged_block_is_a_bijection_onto_the_kernel_s_blocks(
        n_tiles, n_sl, n_split, Hkv, B):
    """``paged_block`` (the kernel's decode of the grid's x index) maps the
    blocks one to one onto (b, kv head, tile, slice, split), slices
    fastest, then tiles, splits, kv heads and sequences; grids past 65,535
    sequences or kv heads (the old y and z limits) are checked at both ends
    and on a sample between, without computing any attention. On the wide
    route the cluster (n, 1, 1) divides the grid: where n_sl is
    ``wide_plan``'s padded slice count of some d (2-8, or 16 for d =
    18,432's 9 slices in two groups of 8), n divides it, and each cluster's
    CTAs are consecutive slices of one (b, kv head, tile, split), its rank
    the slice % n."""
    n = n_tiles * n_sl * n_split * Hkv * B
    xs = (range(n) if n <= 4096 else
          [*range(2048), *range(n - 2048, n),
           *np.random.RandomState(n % 89).randint(0, n, 2048).tolist()])
    seen = set()
    for x in xs:
        b, h, tile, sl, split = got = ops.paged_block(x, n_tiles, n_sl,
                                                      n_split, Hkv)
        assert 0 <= b < B and 0 <= h < Hkv and 0 <= tile < n_tiles
        assert 0 <= sl < n_sl and 0 <= split < n_split
        assert x == sl + n_sl * (tile + n_tiles * (split + n_split *
                                                   (h + Hkv * b)))
        seen.add(got)
    assert len(seen) == len(set(xs))
    assert ops.paged_block(n - 1, n_tiles, n_sl, n_split, Hkv) == (
        B - 1, Hkv - 1, n_tiles - 1, n_sl - 1, n_split - 1)
    # the cluster of the wide route whose padded slices are n_sl
    for d in range(2049, 2048 * 17, 2048):
        n_real, cl, n_slp = ops.wide_plan(d)
        if n_slp != n_sl:
            continue
        assert n_sl % cl == 0 and n % cl == 0 and n_real <= n_slp
        for x0 in [x - x % cl for x in xs][:512]:
            members = [ops.paged_block(x0 + r, n_tiles, n_sl, n_split, Hkv)
                       for r in range(cl)]
            assert {m[:3] + m[4:] for m in members} == {members[0][:3]
                                                        + members[0][4:]}
            assert [m[3] % cl for m in members] == list(range(cl))


def test_plain_version_at_65543_sequences_matches_the_jax_reference():
    """K1's plain version (the card's yardstick) at more sequences than a
    grid dimension of 65,535 holds, d = 4, one kv head of g = 2, pages of
    4, against ``repro.kernels.paged_attention.ref`` (interpret mode is
    far too slow at this B; every length >= 1, where the two agree)."""
    from repro.kernels.paged_attention.ref import paged_attention_ref as jref
    B = 65536 + 7
    x = _inputs(19, B, 2, 1, 4, 4, 2, 64)
    x["lengths"] = np.maximum(x["lengths"], 1)
    got = _run_port(x, torch.float32, fn=ops.paged_attention)
    want = np.asarray(jref(jnp.asarray(x["q"]), jnp.asarray(x["k"]),
                           jnp.asarray(x["v"]), jnp.asarray(x["pt"]),
                           jnp.asarray(x["lengths"])))
    assert got.shape == (B, 2, 4)
    np.testing.assert_allclose(got, want, **F32_TOL)


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
    ((2048, 20, 16, 128), torch.float16),     # the serving shape in f16
])
def test_sm90_route_takes_the_main_path_and_test_shapes(shape, dtype):
    """The main path's and the tests' pools are staged by bulk copies."""
    k = _pool(*shape, dtype=dtype)
    assert ops._bulk_copies(k, k.clone())


@pytest.mark.parametrize("case,bulk", [
    ("misaligned", False), ("row_off_16_bytes", False),
    ("bf16_row_off_16_bytes", False), ("bf16_base_2_bytes_off", False),
    ("bf16_rows_of_14_bytes", False), ("f16_base_2_bytes_off", False),
    ("page_keys", True), ("page_bytes", True)])
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
    elif case == "f16_base_2_bytes_off":
        k = _off(_pool(8, 2, 16, 32, torch.float16), 1)
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


def test_paged_variants_edits_match_the_kernel_source(monkeypatch):
    """benchmarks_torch/paged_variants.py's variants of the mma route still
    apply to the kernel source as it is (build-free): each edit matches,
    each variant differs from the source, and a stale edit raises."""
    from benchmarks_torch import paged_variants
    texts = paged_variants.variant_sources(list(paged_variants.VARIANTS))
    assert set(texts) == {"source", *paged_variants.VARIANTS}
    for name in paged_variants.VARIANTS:
        assert texts[name] != texts["source"], name
    monkeypatch.setitem(paged_variants.VARIANTS, "stale",
                        [("no such text", "")])
    with pytest.raises(ValueError, match="no longer matches"):
        paged_variants.variant_sources(["stale"])


def test_paged_variants_refuses_to_run_without_a_card(monkeypatch):
    from benchmarks_torch import paged_variants
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        paged_variants.main([])


def test_wide_variants_edits_match_the_kernel_sources(monkeypatch):
    """benchmarks_torch/wide_variants.py's variants of the cluster routes
    (K2's float32 and 2-byte routes past d = 256, K1's wide route and its
    combine grid) and of K2's 2-byte own loads still apply to the kernel
    sources as they are (build-free): each edit matches, each variant
    differs from its source, and a stale edit raises."""
    from benchmarks_torch import wide_variants
    texts = wide_variants.variant_sources(list(wide_variants.VARIANTS))
    assert set(texts) == {"flash_attention_f32_sm90", "flash_attention_sm90",
                          "paged_attention_sm90", *wide_variants.VARIANTS}
    for name, (src, text) in texts.items():
        if name in wide_variants.VARIANTS:
            assert text != texts[src][1], name
    monkeypatch.setitem(wide_variants.VARIANTS, "stale",
                        ("paged_attention_sm90", [("no such text", "")]))
    with pytest.raises(ValueError, match="no longer matches"):
        wide_variants.variant_sources(["stale"])


def test_wide_variants_refuses_to_run_without_a_card(monkeypatch):
    from benchmarks_torch import wide_variants
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        wide_variants.main([])
