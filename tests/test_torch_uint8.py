"""Byte I/O on the port's kernels and API, on the CPU (tests/test_uint8.py's
cases; its RGBA case is in test_torch_rgba.py).

Contract: a uint8 input decodes v * float32(1/255) (from_uint8); a uint8
output encodes floor(sat(v)*255 + 0.5) and a uint16 output the 10-bit codes
floor(sat(v)*1023 + 0.5) of the float32 result (to_uint8 / to_uint10).  The
kernels decode at their loads and encode at their store; their plain
versions (what the CPU wrappers run) must be bit-identical to decode ->
float path -> encode, and so must the torch path.  Dithered display codes
are held to the JAX chain on the same float result: at most 4 codes off, by
one (the knife-edge rule of tests/test_uint8.py); against the JAX package's
own paths, whose float results sit within 2e-6 of the port's, at most 0.1%
of the codes, by one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fsr_tpu
import fsr_tpu_torch
from fsr_tpu.ops import extras as jx
from fsr_tpu.utils import image as im

from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import easu_gather as tgather
from fsr_tpu_torch.kernels import fused as tfused
from fsr_tpu_torch.kernels import rcas as trcas
from fsr_tpu_torch.kernels.epilogue import Epilogue

K1_HW = ((40, 144), (80, 288))
K2_HW = ((48, 160), (72, 240))  # 1.5x
CODE_SHARE = 1e-3


def _con(in_hw, out_hw):
    return EasuConstants.create((in_hw[1], in_hw[0]), None, (out_hw[1], out_hw[0]))


def _img8(seed, shape):
    return (np.random.default_rng(seed).uniform(0, 1, shape) * 255).astype(np.uint8)


def _kernel(name, img, out_dtype=None, **kw):
    """K1 (``upscale_fused``) or K2 (``easu_gather``) on the CPU: their
    plain versions."""
    in_hw, out_hw = K1_HW if name == "K1" else K2_HW
    x = torch.from_numpy(np.ascontiguousarray(img))
    fn = tfused.upscale_fused if name == "K1" else tgather.easu_gather
    return fn(x, out_hw, _con(in_hw, out_hw), RcasConstants(0.25), True, False, torch.float32,
              out_dtype=out_dtype, **kw).numpy()


def _codes_close(got, want, share):
    d = np.abs(got.astype(int) - want.astype(int))
    assert got.dtype == want.dtype
    assert (d > 0).mean() <= share and d.max() <= 1, f"{(d > 0).sum()} codes off, max {d.max()}"


@pytest.mark.parametrize("name", ["K1", "K2"])
def test_kernel_u8_in_matches_decoded(name):
    img8 = _img8(0, (3, *(K1_HW if name == "K1" else K2_HW)[0]))
    np.testing.assert_array_equal(_kernel(name, img8), _kernel(name, im.from_uint8(img8)))


def test_torch_path_u8_in_matches_decoded():
    img8 = _img8(1, (2, 3, 24, 40))
    got = fsr_tpu_torch.upscale(torch.from_numpy(img8), scale=1.5, impl="torch")
    want = fsr_tpu_torch.upscale(torch.from_numpy(im.from_uint8(img8)), scale=1.5, impl="torch")
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("name", ["K1", "K2"])
@pytest.mark.parametrize("out", ["uint8", "uint16"])
def test_kernel_out_codes(name, out):
    img = im.from_uint8(_img8(2, (3, *(K1_HW if name == "K1" else K2_HW)[0])))
    got = _kernel(name, img, out_dtype=getattr(torch, out))
    encode = im.to_uint8 if out == "uint8" else im.to_uint10
    want = encode(_kernel(name, img))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_kernel_u8_in_bf16_storage_decodes_unrounded():
    """A decoded byte is never rounded to the storage type: with bf16
    storage and uint8 codes out, K1 equals its f32 result's codes."""
    img8 = _img8(3, (3, *K1_HW[0]))
    in_hw, out_hw = K1_HW
    got = tfused.upscale_fused(torch.from_numpy(img8), out_hw, _con(in_hw, out_hw), RcasConstants(0.25),
                               True, False, torch.bfloat16, out_dtype=torch.uint8).numpy()
    np.testing.assert_array_equal(got, im.to_uint8(_kernel("K1", img8)))


@pytest.mark.parametrize("name,bits,out", [("K1", 8, "uint8"), ("K1", 10, "uint16"), ("K2", 8, "uint8")])
def test_kernel_dithered_display_codes(name, bits, out):
    img8 = _img8(4, (3, *(K1_HW if name == "K1" else K2_HW)[0]))
    base = _kernel(name, img8)
    encode = im.to_uint8 if out == "uint8" else im.to_uint10
    want = encode(np.asarray(jx.tepd_quantize(jnp.asarray(base), jx.tepd_dither(base.shape[-2:], 1), bits=bits)))
    got = _kernel(name, img8, out_dtype=getattr(torch, out), epilogue=Epilogue(dither_bits=bits), frame=1)
    d = np.abs(got.astype(int) - want.astype(int))
    assert (d > 0).sum() <= 4 and d.max() <= 1  # knife-edge dither flips


def test_kernel_u8_batched_with_epilogue():
    """Batch + epilogue + u8 codes together: grain and dither are shared
    across the batch; per-frame results must match single calls."""
    imgs8 = _img8(5, (2, 3, *K1_HW[0]))
    grain = np.random.default_rng(6).uniform(-0.5, 0.5, (3, *K1_HW[1])).astype(np.float32)
    kw = dict(out_dtype=torch.uint8, epilogue=Epilogue(grain_amount=0.2, dither_bits=8), frame=3,
              grain=torch.from_numpy(grain))
    got = _kernel("K1", imgs8, **kw)
    for i in range(2):
        np.testing.assert_array_equal(got[i], _kernel("K1", imgs8[i], **kw))


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_api_u8_round_trip(impl):
    img8 = _img8(7, (3, 32, 48))
    got = fsr_tpu_torch.upscale(torch.from_numpy(img8), scale=2.0, impl=impl, out_dtype=torch.uint8).numpy()
    assert got.dtype == np.uint8
    ref = fsr_tpu_torch.upscale(torch.from_numpy(im.from_uint8(img8)), scale=2.0, impl=impl).numpy()
    np.testing.assert_array_equal(got, im.to_uint8(ref))
    jax_codes = np.asarray(fsr_tpu.upscale(jnp.asarray(img8), scale=2.0, impl="xla", out_dtype=jnp.uint8))
    _codes_close(got, jax_codes, CODE_SHARE)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_pipeline_u8_display_codes(impl):
    in_hw, out_hw = K1_HW
    img8 = _img8(8, (3, *in_hw))
    pipe = fsr_tpu_torch.UpscalePipeline(out_hw, dither_bits=8, out_dtype=torch.uint8, impl=impl)
    out = pipe(torch.from_numpy(img8), frame=2).numpy()
    assert out.dtype == np.uint8 and out.shape == (3, *out_hw)
    # decode -> upscale -> dither -> encode, on the same path
    x = fsr_tpu_torch.upscale(torch.from_numpy(im.from_uint8(img8)), out_size=out_hw, impl=impl)
    x = jx.tepd_quantize(jnp.asarray(x.numpy()), jx.tepd_dither(out_hw, 2), bits=8)
    _codes_close(out, im.to_uint8(np.asarray(x)), 4 / out.size)
    jpipe = fsr_tpu.UpscalePipeline(out_hw, dither_bits=8, out_dtype=jnp.uint8)
    _codes_close(out, np.asarray(jpipe(jnp.asarray(img8), frame=2)), CODE_SHARE)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_pipeline_u16_display_codes(impl):
    in_hw, out_hw = K1_HW
    img8 = _img8(9, (3, *in_hw))
    pipe = fsr_tpu_torch.UpscalePipeline(out_hw, dither_bits=10, out_dtype=torch.uint16, impl=impl)
    out = pipe(torch.from_numpy(img8), frame=2).numpy()
    assert out.dtype == np.uint16 and out.shape == (3, *out_hw)
    jpipe = fsr_tpu.UpscalePipeline(out_hw, dither_bits=10, out_dtype=jnp.uint16)
    _codes_close(out, np.asarray(jpipe(jnp.asarray(img8), frame=2)), CODE_SHARE)


def test_pipeline_u8_validation():
    with pytest.raises(ValueError):
        fsr_tpu_torch.UpscalePipeline((64, 128), dither_bits=10, out_dtype=torch.uint8)
    with pytest.raises(ValueError):
        fsr_tpu_torch.UpscalePipeline((64, 128), hdr_srtm=True, hdr_out=True, out_dtype=torch.uint8)


def test_out_dtype_guards():
    img = np.random.default_rng(10).uniform(0, 1, (3, *K1_HW[0])).astype(np.float32)
    in_hw, out_hw = K1_HW
    x = torch.from_numpy(img)
    with pytest.raises(ValueError):
        tfused.upscale_fused(x, out_hw, _con(in_hw, out_hw), RcasConstants(0.25), True, False,
                             torch.bfloat16, out_dtype=torch.float32)
    with pytest.raises(ValueError):
        fsr_tpu_torch.upscale(x, scale=2.0, compute_dtype=torch.bfloat16, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="10-bit"):
        fsr_tpu_torch.upscale(x, scale=2.0, epilogue=Epilogue(dither_bits=10), out_dtype=torch.uint8)


def test_uint16_input_raises_value_error():
    # The JAX package takes byte images only; a uint16 image is an error.
    x = torch.zeros((3, 8, 8), dtype=torch.uint16)
    for impl in ("torch", "kernel"):
        with pytest.raises(ValueError, match="uint8"):
            fsr_tpu_torch.upscale(x, scale=2.0, impl=impl)
        with pytest.raises(ValueError, match="uint8"):
            fsr_tpu_torch.sharpen(x, impl=impl)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_sharpen_u8_round_trip(impl, compute_dtype):
    """Byte in, byte out: decode -> float32 RCAS -> encode, whatever
    compute_dtype says (as fsr_tpu.sharpen forces float32 for bytes)."""
    img8 = _img8(11, (2, 3, 64, 96))
    cd = getattr(torch, compute_dtype) if compute_dtype else None
    got = fsr_tpu_torch.sharpen(torch.from_numpy(img8), impl=impl, compute_dtype=cd).numpy()
    assert got.dtype == np.uint8
    ref = trcas.rcas_fused_reference(torch.from_numpy(im.from_uint8(img8)), RcasConstants(0.25)).numpy()
    if impl == "kernel":
        np.testing.assert_array_equal(got, im.to_uint8(ref))
    jax_codes = np.asarray(fsr_tpu.sharpen(jnp.asarray(img8), impl="xla"))
    _codes_close(got, jax_codes, CODE_SHARE)


def test_sharpen_u8_short_image_and_rgba():
    """No 8-bit block granule here: a short byte image takes the kernel
    path too, and byte alpha rides along verbatim."""
    img8 = _img8(12, (4, 16, 64))
    got = fsr_tpu_torch.sharpen(torch.from_numpy(img8), impl="kernel").numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got[3], img8[3])
    want = im.to_uint8(trcas.rcas_fused_reference(torch.from_numpy(im.from_uint8(img8[:3])),
                                                  RcasConstants(0.25)).numpy())
    np.testing.assert_array_equal(got[:3], want)
