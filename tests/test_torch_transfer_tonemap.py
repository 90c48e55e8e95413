"""The port's colour transfer functions, tonemappers and the approx extras
(``p_sin``/``p_cos``, ``fis_*``) against the JAX package's, on the CPU.
Mirrors tests/test_transfer_tonemap.py and tests/test_approx.py:74,86.

Limits: each port function against its JAX counterpart on the same float32
inputs within 2e-6 absolute and 2e-6 relative (``pow``/``sqrt`` may round
differently by an ulp in torch and XLA); the bit tricks and the selects
bit-equal; the spec checks of the JAX tests as they are there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsr_tpu.core import approx as japprox
from fsr_tpu.core import tonemap as jtonemap
from fsr_tpu.core import transfer as jtransfer

from fsr_tpu_torch.core import approx, tonemap, transfer

ATOL, RTOL = 2e-6, 2e-6


@pytest.fixture
def lin():
    return np.random.default_rng(0).uniform(0, 1, (4096,)).astype(np.float32)


def _both(name, x, module=(transfer, jtransfer), *args):
    """The port's and JAX's ``name`` on the same numpy input, as numpy."""
    got = getattr(module[0], name)(torch.from_numpy(x), *args).numpy()
    want = np.asarray(getattr(module[1], name)(jnp.asarray(x), *args))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=name)
    return got


def _srgb_ref(x):
    return np.where(x <= 0.0031308, x * 12.92, 1.055 * x ** (1 / 2.4) - 0.055)


def test_srgb_roundtrip_and_spec(lin):
    enc = _both("to_srgb", lin)
    np.testing.assert_allclose(enc, _srgb_ref(lin), atol=2e-6)
    back = _both("from_srgb", enc)
    np.testing.assert_allclose(back, lin, atol=3e-6)


def test_709_roundtrip(lin):
    enc = _both("to_709", lin)
    back = _both("from_709", enc)
    np.testing.assert_allclose(back, lin, atol=1e-5)


def test_pq_roundtrip():
    x = np.geomspace(1e-4, 1.0, 512, dtype=np.float32)
    enc = _both("to_pq", x)
    back = _both("from_pq", enc)
    np.testing.assert_allclose(back, x, rtol=2e-3)


def test_two_three_gamma(lin):
    np.testing.assert_allclose(_both("from_two", _both("to_two", lin)), lin, atol=1e-6)
    np.testing.assert_allclose(_both("from_three", _both("to_three", lin)), lin, atol=1e-5)
    np.testing.assert_allclose(
        _both("from_gamma", _both("to_gamma", lin, (transfer, jtransfer), 1 / 2.2), (transfer, jtransfer), 2.2),
        lin, atol=1e-5)


def test_pq_approximations():
    # The bit tricks approximate 4th/8th roots (PQ ~ x^(1/8)): the lo forms
    # bit-equal to JAX's, each against the true root as the JAX test holds it.
    x = np.linspace(0.01, 1.0, 256, dtype=np.float32)
    for name in ("prx_lo_gamma2_to_pq", "prx_lo_linear_to_pq"):
        got = getattr(transfer, name)(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      np.asarray(getattr(jtransfer, name)(jnp.asarray(x))).view(np.uint32))
    np.testing.assert_allclose(_both("prx_lo_gamma2_to_pq", x), x ** 0.25, rtol=0.045)
    med4 = _both("prx_med_gamma2_to_pq", x)
    np.testing.assert_allclose(med4, x ** 0.25, rtol=3e-3)
    np.testing.assert_allclose(_both("prx_lo_linear_to_pq", x), x ** 0.125, rtol=0.05)
    np.testing.assert_allclose(_both("prx_med_linear_to_pq", x), x ** 0.125, rtol=8e-3)
    np.testing.assert_allclose(_both("prx_pq_to_gamma2", med4), x, rtol=1.5e-2)
    np.testing.assert_allclose(_both("prx_pq_to_linear", x), x ** 8, rtol=1e-6)


@pytest.mark.parametrize("name", ["amd", "dx11dsk", "reinhard", "uncharted2", "aces", "none"])
def test_tonemappers_basic(name):
    hdr = np.random.default_rng(0).uniform(0, 8.0, (3, 16, 16)).astype(np.float32)
    out = tonemap.tonemap(torch.from_numpy(hdr), exposure=1.0, tonemapper=name).numpy()
    want = np.asarray(jtonemap.tonemap(jnp.asarray(hdr), exposure=1.0, tonemapper=name))
    np.testing.assert_allclose(out, want, atol=ATOL, rtol=RTOL)
    assert out.shape == (3, 16, 16)
    assert np.isfinite(out).all()
    if name != "none":
        assert out.min() >= -1e-6 and out.max() <= 1.0 + 1e-6
        ramp = np.linspace(0.01, 8.0, 64, dtype=np.float32)[None, None, :].repeat(3, 0)
        r = tonemap.tonemap(torch.from_numpy(ramp), tonemapper=name).numpy()[0, 0]
        assert (np.diff(r) >= -1e-4).all()


def test_tonemap_pass_hdr10():
    hdr = np.random.default_rng(0).uniform(0, 4.0, (3, 16, 16)).astype(np.float32)
    out = tonemap.tonemap_pass(torch.from_numpy(hdr), tonemapper="aces", hdr10_dither_frame=2).numpy()
    # Quantized to the 10-bit gamma-2.0 lattice, at JAX's codes.
    lat = np.round(out * 1023.0) / 1023.0
    np.testing.assert_allclose(out, lat, atol=1e-6)
    want = np.asarray(jtonemap.tonemap_pass(jnp.asarray(hdr), tonemapper="aces", hdr10_dither_frame=2))
    np.testing.assert_array_equal(np.round(out * 1023.0), np.round(want * 1023.0))


def test_unknown_tonemapper():
    with pytest.raises(ValueError):
        tonemap.tonemap(torch.zeros((3, 4, 4)), tonemapper="bogus")


def test_parabolic_sin_cos():
    # {-1..1} represents {0..2pi}; output {-1/4..1/4} represents {-1..1}.
    x = np.linspace(-1.0, 1.0, 257, dtype=np.float32)
    got = _both("p_sin", x, (approx, japprox)) * 4.0
    assert np.max(np.abs(got - (-np.sin(np.pi * x)))) < 0.06
    gc = _both("p_cos", x, (approx, japprox)) * 4.0
    assert np.max(np.abs(gc - (-np.cos(np.pi * x)))) < 0.06


def test_fis_sortable_roundtrip():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-1e6, 1e6, 4096), [0.0, -0.0, 1.0, -1.0, 3.4e38, -3.4e38]]).astype(np.float32)
    u = approx.fis_to_u32(torch.from_numpy(x))
    assert u.dtype == torch.int64 and int(u.min()) >= 0 and int(u.max()) < 2 ** 32
    np.testing.assert_array_equal(u.numpy(), np.asarray(japprox.fis_to_u32(jnp.asarray(x))).astype(np.int64))
    back = approx.fis_from_u32(u).numpy()
    np.testing.assert_array_equal(back.view(np.uint32), x.view(np.uint32))
    # The uint32 codes of JAX decode too, and sorting the codes sorts the floats.
    jback = approx.fis_from_u32(torch.from_numpy(np.asarray(japprox.fis_to_u32(jnp.asarray(x))).astype(np.int64)))
    np.testing.assert_array_equal(jback.numpy().view(np.uint32), x.view(np.uint32))
    order_f = np.argsort(x, kind="stable")
    order_u = np.argsort(u.numpy(), kind="stable")
    np.testing.assert_array_equal(x[order_f], x[order_u])
