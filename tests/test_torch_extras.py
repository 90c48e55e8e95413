"""The port's SRTM / LFGA / TEPD twins (``fsr_tpu_torch.ops.extras``), its
numpy copies (oracle refs, byte codecs, blue noise) and ``Epilogue``'s
validation, on the CPU against the JAX package.

Tolerances: the float32 twins run the same float32 ops in the same order as
``fsr_tpu.ops.extras`` (XLA may fuse): within 1e-6 abs of it and of the
oracle refs; ``srtm_inv`` within 3e-5 relative (it divides by 1 - max3, so
its absolute error grows with the output).  The TEPD quantize output is a
code, compared by the share of pixels at another code (a one-ulp
difference in the dither threshold is a knife edge).  The numpy copies are
bit-equal to their originals.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsr_tpu.kernels import epilogue as jepilogue
from fsr_tpu.ops import extras as jx
from fsr_tpu.reference import scalar as jref
from fsr_tpu.utils import image as jimage
from fsr_tpu.utils import noise as jnoise

from fsr_tpu_torch.kernels import epilogue as tepilogue
from fsr_tpu_torch.ops import extras as tx
from fsr_tpu_torch.reference import scalar as tref
from fsr_tpu_torch.utils import image as timage
from fsr_tpu_torch.utils import noise as tnoise

F32_TOL = 1e-6
INV_RTOL = 3e-5


def _img(seed, shape, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_srtm_matches_jax_and_oracle():
    hdr = _img(0, (2, 3, 24, 40), 0.0, 16.0)
    got = tx.srtm(_t(hdr)).numpy()
    np.testing.assert_allclose(got, np.asarray(jx.srtm(jnp.asarray(hdr))), atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(got[1], jref.srtm_ref(hdr[1]), atol=F32_TOL, rtol=0)


def test_srtm_inv_matches_jax_and_oracle():
    x = _img(1, (3, 24, 40))
    x[:, 0, :4] = 1.0  # the 1/32768 guard at max3 == 1
    got = tx.srtm_inv(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jx.srtm_inv(jnp.asarray(x))), atol=0, rtol=INV_RTOL)
    np.testing.assert_allclose(got, jref.srtm_inv_ref(x), atol=0, rtol=INV_RTOL)
    # srtm_inv undoes srtm on {0..1}-tonemapped HDR values.
    hdr = _img(2, (3, 16, 16), 0.0, 8.0)
    np.testing.assert_allclose(tx.srtm_inv(tx.srtm(_t(hdr))).numpy(), hdr, atol=0, rtol=INV_RTOL)


def test_lfga_matches_jax_and_oracle():
    x = _img(3, (3, 24, 40))
    g = _img(4, (3, 24, 40), -0.5, 0.5)
    got = tx.lfga(_t(x), _t(g), 0.3).numpy()
    np.testing.assert_allclose(got, np.asarray(jx.lfga(jnp.asarray(x), jnp.asarray(g), 0.3)), atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(got, jref.lfga_ref(x, g, 0.3), atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("frame,origin", [(0, (0, 0)), (7, (0, 0)), (3, (5, 17))])
def test_tepd_dither_matches_jax_and_oracle(frame, origin):
    got = tx.tepd_dither((48, 300), frame, origin=origin).numpy()
    np.testing.assert_array_equal(got, np.asarray(jx.tepd_dither((48, 300), frame, origin=origin)))
    if origin == (0, 0):
        np.testing.assert_array_equal(got, jref.tepd_dither_ref(48, 300, frame))
    assert got.min() >= 0.0 and got.max() < 1.0


@pytest.mark.parametrize("pages,frame,origin", [(1, 0, (0, 0)), (4, 6, (0, 0)), (3, 2, (9, 70))])
def test_texture_dither_matches_jax(pages, frame, origin):
    tex = _img(5, (pages, 32, 48)) if pages > 1 else _img(5, (32, 48))
    got = tx.texture_dither((70, 100), frame, _t(tex), origin=origin).numpy()
    want = np.asarray(jx.texture_dither((70, 100), frame, jnp.asarray(tex), origin=origin))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [8, 10])
def test_tepd_quantize_matches_jax_and_oracle(bits):
    x = _img(6, (2, 3, 40, 64))
    dit = jref.tepd_dither_ref(40, 64, 5)
    got = tx.tepd_quantize(_t(x), _t(dit), bits=bits).numpy()
    want = np.asarray(jx.tepd_quantize(jnp.asarray(x), jnp.asarray(dit), bits=bits))
    oracle = np.stack([jref.tepd_quantize_ref(x[i], dit, bits=bits) for i in range(2)])
    step = 1.0 / (255.0 if bits == 8 else 1023.0)
    for other in (want, oracle):
        d = np.abs(got - other)
        assert (d > F32_TOL).mean() <= 1e-3 and d.max() <= step * (1 + 1e-5)
    with pytest.raises(ValueError):
        tx.tepd_quantize(_t(x), _t(dit), bits=9)


def test_oracle_copies_bit_equal():
    hdr = _img(7, (3, 20, 30), 0.0, 8.0)
    x = _img(8, (3, 20, 30))
    g = _img(9, (3, 20, 30), -0.5, 0.5)
    dit = jref.tepd_dither_ref(20, 30, 2)
    pairs = [
        (tref.srtm_ref(hdr), jref.srtm_ref(hdr)),
        (tref.srtm_inv_ref(x), jref.srtm_inv_ref(x)),
        (tref.lfga_ref(x, g, 0.25), jref.lfga_ref(x, g, 0.25)),
        (tref.tepd_dither_ref(20, 30, 2), dit),
        (tref.tepd_quantize_ref(x, dit, 8), jref.tepd_quantize_ref(x, dit, 8)),
        (tref.tepd_quantize_ref(x, dit, 10), jref.tepd_quantize_ref(x, dit, 10)),
    ]
    for got, want in pairs:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_codec_copies_bit_equal():
    x = _img(10, (3, 17, 33), -0.2, 1.2)
    x[0, 0, :3] = (np.nan, np.inf, -np.inf)
    for name in ("to_uint8", "to_uint10"):
        got, want = getattr(timage, name)(x), getattr(jimage, name)(x)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    b8 = (np.arange(256, dtype=np.uint8)).reshape(16, 16)
    b10 = np.arange(1024, dtype=np.uint16).reshape(32, 32)
    np.testing.assert_array_equal(timage.from_uint8(b8), jimage.from_uint8(b8))
    np.testing.assert_array_equal(timage.from_uint10(b10), jimage.from_uint10(b10))


def test_noise_copies_bit_equal():
    np.testing.assert_array_equal(tnoise.blue_noise((16, 16), seed=3), jnoise.blue_noise((16, 16), seed=3))
    np.testing.assert_array_equal(
        tnoise.temporal_blue_noise(2, (8, 16), seed=1), jnoise.temporal_blue_noise(2, (8, 16), seed=1))


def test_unorm_encodes_match_codecs_and_jax():
    x = _img(11, (3, 17, 33), -0.2, 1.2)
    x[0, 0, :2] = (np.inf, -np.inf)
    np.testing.assert_array_equal(tepilogue.encode_unorm8(_t(x)).numpy(), jimage.to_uint8(x))
    np.testing.assert_array_equal(tepilogue.encode_unorm10(_t(x)).numpy(), jimage.to_uint10(x))
    np.testing.assert_array_equal(tepilogue.encode_unorm8(_t(x)).numpy(),
                                  np.asarray(jepilogue.encode_unorm8(jnp.asarray(x))))
    x[1, 1, 1] = np.nan  # NaN encodes as 0, as to_uint8's nan_to_num does
    assert tepilogue.encode_unorm8(_t(x))[1, 1, 1] == 0
    b8 = _t((np.arange(256, dtype=np.uint8)).reshape(1, 16, 16))
    np.testing.assert_array_equal(tepilogue.decode(b8).numpy(), jimage.from_uint8(b8.numpy()))


def test_epilogue_validation():
    E = tepilogue.Epilogue
    with pytest.raises(ValueError):
        E(transform="nope")
    with pytest.raises(ValueError):
        E(dither_bits=9)
    with pytest.raises(ValueError):
        E(transform="srtm_inv", dither_bits=10)
    with pytest.raises(ValueError):
        E(dither_texture=True)
    assert E().is_noop
    assert not E(transform="gamma2").is_noop
    for kw in (dict(transform="gamma2"), dict(grain_amount=0.3), dict(dither_bits=10),
               dict(dither_bits=8, dither_texture=True)):
        t, j = E(**kw), jepilogue.Epilogue(**kw)
        assert (t.needs_grain, t.needs_frame, t.needs_dither_tex, t.is_noop) == (
            j.needs_grain, j.needs_frame, j.needs_dither_tex, j.is_noop)


def test_bind_checks_operands():
    E = tepilogue.Epilogue
    assert tepilogue.bind(None, (8, 8)) is None and tepilogue.bind(E(), (8, 8)) is None
    with pytest.raises(ValueError, match="requires grain"):
        tepilogue.bind(E(grain_amount=0.2), (8, 8))
    with pytest.raises(ValueError, match="grain must be"):
        tepilogue.bind(E(grain_amount=0.2), (8, 8), grain=torch.zeros(3, 8, 9))
    with pytest.raises(ValueError, match="requires dither_page"):
        tepilogue.bind(E(dither_bits=8, dither_texture=True), (8, 8))
    with pytest.raises(TypeError):
        tepilogue.bind(object(), (8, 8))
    args = tepilogue.bind(E(dither_bits=10, grain_amount=0.5), (8, 8), frame=-1,
                          grain=np.zeros((3, 8, 8), np.float64))
    assert args.grain.dtype == torch.float32 and args.frame == -1
    st = tepilogue.c_params(args)
    assert (st.frame, st.dither_bits, st.transform) == ((1 << 32) - 1, 10, 0)
    assert abs(st.grain_amount - 0.5) == 0 and st.page is None
    assert (tepilogue.c_params(None).dither_bits, tepilogue.c_params(None).grain) == (0, None)
