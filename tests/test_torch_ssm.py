"""Port's Mamba layer (``repro_torch/models/ssm.py``) against
``repro.models.ssm`` from the same inputs: the selective scan with a
ragged tail and a nonzero initial state, its chunk invariance, the causal
conv with a carried state, and ``mamba_mix`` (prefill from a state, and
its S == 1 decode branch against the prefill of the same tokens).
Tolerance: the f32 bar of tests/test_kernels.py (atol=2e-5, rtol=2e-4):
the port's in-chunk scan is log-depth doubling, the reference's
``associative_scan`` another tree over the same combine."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import reduced as jreduced
from repro.configs.registry import get_config as jget_config
from repro.models import ssm as jssm
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.models import ssm
from repro_torch.models.common import params_from_numpy

TOL = dict(atol=2e-5, rtol=2e-4)


def _scan_inputs(B, S, di, N, seed=0, h0_scale=1.0):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    u, Bc, Cc = f(B, S, di), f(B, S, N), f(B, S, N)
    dt = np.log1p(np.exp(f(B, S, di) - 1.0)).astype(np.float32)  # softplus
    A = -np.exp(0.5 * f(di, N)).astype(np.float32)
    h0 = (h0_scale * f(B, di, N)).astype(np.float32)
    return u, dt, A, Bc, Cc, h0


@pytest.mark.parametrize("S,chunk", [(64, 16), (50, 16), (37, 256),
                                     (300, 256), (5, 4)])
def test_selective_scan_matches_reference(S, chunk):
    """Ragged tails (50, 37, 300, 5), several chunks, a nonzero h0."""
    x = _scan_inputs(2, S, 6, 4, seed=S)
    jy, jh = jssm.selective_scan(*map(jnp.asarray, x), chunk=chunk)
    y, h = ssm.selective_scan(*map(torch.from_numpy, x), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)


def test_selective_scan_is_chunk_invariant():
    x = [torch.from_numpy(a) for a in _scan_inputs(2, 200, 5, 3, seed=9)]
    y0, h0 = ssm.selective_scan(*x, chunk=256)
    for chunk in (1, 7, 16, 64, 128):
        y, h = ssm.selective_scan(*x, chunk=chunk)
        np.testing.assert_allclose(y.numpy(), y0.numpy(), **TOL)
        np.testing.assert_allclose(h.numpy(), h0.numpy(), **TOL)


def test_inclusive_scan_equals_a_loop_over_time():
    rng = np.random.RandomState(1)
    a = torch.from_numpy(rng.rand(2, 37, 3).astype(np.float32))
    b = torch.from_numpy(rng.randn(2, 37, 3).astype(np.float32))
    ac, bc = ssm._inclusive_scan(a, b)
    pa, pb = a[:, 0], b[:, 0]
    for t in range(1, 37):
        pa, pb = a[:, t] * pa, a[:, t] * pb + b[:, t]
        np.testing.assert_allclose(ac[:, t].numpy(), pa.numpy(), **TOL)
        np.testing.assert_allclose(bc[:, t].numpy(), pb.numpy(), **TOL)


def test_causal_conv_matches_reference_with_state():
    rng = np.random.RandomState(2)
    x, w, st = (rng.randn(*s).astype(np.float32)
                for s in ((2, 9, 6), (4, 6), (2, 3, 6)))
    for state in (None, st):
        jy, jst = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                    None if state is None
                                    else jnp.asarray(state))
        y, nst = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                  None if state is None
                                  else torch.from_numpy(state))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(nst.numpy(), np.asarray(jst), **TOL)


def _mamba(seed=0):
    jcfg = jreduced(jget_config("hymba-1.5b"))
    cfg = reduced(get_config("hymba-1.5b"))
    rng = np.random.RandomState(seed)
    # the init's scales (std 1 / sqrt(fan_in); ones and zeros), perturbed
    base = {"normal": lambda d: rng.randn(*d.shape) / np.sqrt(d.shape[0]),
            "ones": lambda d: np.ones(d.shape), "zeros": lambda d: 0.0}
    p = {k: (base[d.init](d) + 0.05 * rng.randn(*d.shape)).astype(np.float32)
         for k, d in jssm.mamba_defs(jcfg).items()}
    return jcfg, cfg, {k: jnp.asarray(v) for k, v in p.items()}, \
        params_from_numpy(p, "cpu")


def test_mamba_mix_matches_reference_from_a_state():
    jcfg, cfg, jp, p = _mamba()
    di, N, W = ssm.d_inner(cfg), cfg.ssm_state, cfg.conv_width
    rng = np.random.RandomState(3)
    h = rng.randn(2, 40, cfg.d_model).astype(np.float32)
    st = (rng.randn(2, di, N).astype(np.float32),
          rng.randn(2, W - 1, di).astype(np.float32))
    for state in (None, st):
        jy, (jh, jc) = jssm.mamba_mix(
            jp, jcfg, jnp.asarray(h),
            None if state is None else tuple(map(jnp.asarray, state)))
        y, (th, tc) = ssm.mamba_mix(
            p, cfg, torch.from_numpy(h),
            None if state is None else tuple(map(torch.from_numpy, state)))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def test_mamba_mix_decode_equals_prefill():
    """S == 1 steps from the prefill's state give the outputs and state of
    the prefill over the whole sequence, in the port and the reference."""
    jcfg, cfg, jp, p = _mamba(seed=1)
    di, N, W = ssm.d_inner(cfg), cfg.ssm_state, cfg.conv_width
    h = np.random.RandomState(4).randn(2, 12, cfg.d_model).astype(np.float32)
    zero = (np.zeros((2, di, N), np.float32),
            np.zeros((2, W - 1, di), np.float32))
    full, (hf, cf) = ssm.mamba_mix(p, cfg, torch.from_numpy(h),
                                   tuple(map(torch.from_numpy, zero)))
    y, state = ssm.mamba_mix(p, cfg, torch.from_numpy(h[:, :8]),
                             tuple(map(torch.from_numpy, zero)))
    jy, jstate = jssm.mamba_mix(jp, jcfg, jnp.asarray(h[:, :8]),
                                tuple(map(jnp.asarray, zero)))
    steps, jsteps = [y], [np.asarray(jy)]
    for t in range(8, 12):
        y, state = ssm.mamba_mix(p, cfg, torch.from_numpy(h[:, t:t + 1]),
                                 state)
        jy, jstate = jssm.mamba_mix(jp, jcfg, jnp.asarray(h[:, t:t + 1]),
                                    jstate)
        steps.append(y)
        jsteps.append(np.asarray(jy))
    got = torch.cat(steps, dim=1).numpy()
    np.testing.assert_allclose(got, full.numpy(), **TOL)
    np.testing.assert_allclose(got, np.concatenate(jsteps, 1), **TOL)
    np.testing.assert_allclose(state[0].numpy(), hf.numpy(), **TOL)
    np.testing.assert_allclose(state[1].numpy(), cf.numpy(), **TOL)
    np.testing.assert_allclose(state[0].numpy(), np.asarray(jstate[0]), **TOL)
