"""Port's paged attention (plain version) vs the JAX Pallas kernel in
interpret mode, plus the wrapper's CPU routing. The CUDA kernel itself is
held against the plain version on the card by chip_smoke.py."""
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
