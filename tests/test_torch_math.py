"""Port math (bit tricks, EASU/RCAS resolve) against the JAX package.

The bit tricks are integer arithmetic and must be bit-equal.  The resolve
functions run the same float32 ops in the same order on the same planes,
but XLA on the CPU may fuse and reassociate, so they agree within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsr_tpu.core import easu_math as jmath
from fsr_tpu.reference import scalar as jref

from fsr_tpu_torch.core import approx as tapprox
from fsr_tpu_torch.core import easu_math as tmath

TOL = 1e-6


def _edge_values():
    rng = np.random.default_rng(0)
    vals = [
        rng.uniform(0, 1, 512),
        rng.uniform(0, 1e6, 256),
        np.exp(rng.uniform(-80, 80, 256)),
        [0.0, 1e-45, 1e-40, 1.17e-38, 1e30, 3.4e38, 1.0, 0.5, 2.0],
        [-0.0, -1.0, -1e30, np.inf, -np.inf],
    ]
    return np.concatenate([np.asarray(v, np.float64) for v in vals]).astype(np.float32)


@pytest.mark.parametrize("name", ["prx_lo_rcp", "prx_med_rcp", "prx_lo_rsq", "prx_lo_sqrt"])
def test_bit_tricks_bit_equal_to_oracle(name):
    x = _edge_values()
    with np.errstate(over="ignore", invalid="ignore"):
        want = getattr(jref, name + "_f32")(x)
    got = getattr(tapprox, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), np.asarray(want, np.float32).view(np.uint32))


def test_bit_tricks_reject_other_dtypes():
    with pytest.raises(TypeError):
        tapprox.prx_lo_rcp(torch.ones(3, dtype=torch.float64))


def _planes(rng, n, shape=(3, 9, 17)):
    return [rng.uniform(0, 1, shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("fast", [False, True])
def test_texel_response_matches(fast):
    rng = np.random.default_rng(1)
    ls = _planes(rng, 5, (13, 21))
    ls[2][0, :4] = ls[1][0, :4]  # flat neighbourhoods: zero gradients
    ls[3][0, :4] = ls[1][0, :4]
    want = jmath.easu_texel_response(*(jnp.asarray(v) for v in ls), fast=fast)
    got = tmath.easu_texel_response(*(torch.from_numpy(v) for v in ls), fast=fast)
    assert len(got) == len(want) == (3 if fast else 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)


def _taps(rng, shape=(3, 9, 17)):
    return {k: rng.uniform(0, 1, shape).astype(np.float32) for k in jmath.TAP_OFFSETS}


def _ppxy(rng, shape=(9, 17)):
    return (rng.uniform(0, 1, (1, shape[1])).astype(np.float32),
            rng.uniform(0, 1, (shape[0], 1)).astype(np.float32))


@pytest.mark.parametrize("fast,with_quad_g", [(False, False), (True, False), (True, True)])
def test_easu_resolve_f32_matches(fast, with_quad_g):
    rng = np.random.default_rng(2)
    taps = _taps(rng)
    ppx, ppy = _ppxy(rng)
    jq = tq = None
    if with_quad_g:
        lum = {k: v[2] * 0.5 + (v[0] * 0.5 + v[1]) for k, v in taps.items()}
        jq = {q: jmath.easu_texel_response(*(jnp.asarray(lum[n]) for n in names), fast=True)
              for q, names in jmath.EASU_QUADS}
        tq = {q: tmath.easu_texel_response(*(torch.from_numpy(lum[n]) for n in names), fast=True)
              for q, names in tmath.EASU_QUADS}
    want = jmath.easu_resolve({k: jnp.asarray(v) for k, v in taps.items()},
                              jnp.asarray(ppx), jnp.asarray(ppy), fast=fast, quad_g=jq)
    got = tmath.easu_resolve({k: torch.from_numpy(v) for k, v in taps.items()},
                             torch.from_numpy(ppx), torch.from_numpy(ppy), fast=fast, quad_g=tq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_easu_resolve_bf16_accumulation_matches():
    """bf16 colour accumulation with a float32 direction stage (the ops
    path's mixed mode).  Both sides round every op to bf16, but XLA may keep
    excess precision inside a fusion, so the agreement is statistical: most
    pixels equal, the rest within a couple of bf16 ulps."""
    rng = np.random.default_rng(3)
    taps = _taps(rng, (3, 24, 32))
    ppx, ppy = _ppxy(rng, (24, 32))
    want = np.asarray(jmath.easu_resolve(
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in taps.items()}, jnp.asarray(ppx), jnp.asarray(ppy),
        dtype=jnp.bfloat16, dir_dtype=jnp.float32).astype(jnp.float32))
    got = tmath.easu_resolve(
        {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in taps.items()},
        torch.from_numpy(ppx), torch.from_numpy(ppy),
        dtype=torch.bfloat16, dir_dtype=torch.float32).float().numpy()
    d = np.abs(got - want)
    assert np.median(d) <= 2.0 ** -9
    assert np.percentile(d, 99) <= 2.0 ** -6
    assert d.max() <= 0.1


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("denoise", [False, True])
def test_rcas_resolve_matches(fast, denoise):
    rng = np.random.default_rng(4)
    cross = _planes(rng, 5)
    sharp = np.float32(np.exp2(-0.25))
    want = jmath.rcas_resolve(*(jnp.asarray(v) for v in cross), sharp, denoise=denoise, fast=fast)
    got = tmath.rcas_resolve(*(torch.from_numpy(v) for v in cross), float(sharp), denoise=denoise, fast=fast)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("fast", [False, True])
def test_rcas_isolated_bright_pixel_planes(fast):
    """A single 0.5 texel on black, sharpness 0: mx4 == 0 at the centre,
    the limiter's 0 * inf NaN branch (exact form) or its select (fast
    form).  Finite on both sides, and equal."""
    img = np.zeros((3, 9, 9), np.float32)
    img[:, 4, 4] = 0.5

    def shifted(dy, dx):
        r = np.clip(np.arange(9) + dy, 0, 8)
        c = np.clip(np.arange(9) + dx, 0, 8)
        return img[:, r[:, None], c[None, :]]

    cross = [shifted(-1, 0), shifted(0, -1), img, shifted(0, 1), shifted(1, 0)]
    want = np.asarray(jmath.rcas_resolve(*(jnp.asarray(v) for v in cross), 1.0, fast=fast))
    got = tmath.rcas_resolve(*(torch.from_numpy(v) for v in cross), 1.0, fast=fast).numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_nan_semantics_helpers():
    a = torch.tensor([np.nan, 1.0, -2.0, 0.5, np.inf])
    b = torch.tensor([3.0, np.nan, -1.0, 0.7, 0.0])
    got = tmath._nan_drop_max(a, b).numpy()
    want = np.asarray(jmath._nan_drop_max(jnp.asarray(a.numpy()), jnp.asarray(b.numpy())))
    np.testing.assert_array_equal(got, want)
    s = torch.tensor([np.nan, -1.0, 0.25, 7.0])
    np.testing.assert_array_equal(tmath._sat(s).numpy(), np.asarray(jmath._sat(jnp.asarray(s.numpy()))))
