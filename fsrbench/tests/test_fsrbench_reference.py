"""The frozen reference against the oracle it was copied from
(``fsr_tpu/reference/scalar.py``, the JAX package's NumPy oracle): bit-equal
in float32 on small frames.  Only this test imports the JAX package."""

import numpy as np
import pytest
import torch

from fsr_tpu.core.constants import EasuConstants, RcasConstants
from fsr_tpu.reference import scalar as oracle
from fsr_tpu.utils.image import from_uint8, to_uint8
from fsrbench.reference import fsr1

SIZES = [((16, 24), (32, 48)), ((18, 26), (27, 39)), ((20, 30), (34, 51)), ((9, 13), (18, 26)),
         ((24, 40), (36, 60))]


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("in_hw, out_hw", SIZES)
def test_easu_and_constants_bit_equal(in_hw, out_hw):
    rng = np.random.default_rng(sum(in_hw) + sum(out_hw))
    img = rng.uniform(0, 1, (3, *in_hw)).astype(np.float32)
    img[:, :4, :4] = 0.5  # a flat patch: zero gradients, the zero-protect path
    con = EasuConstants.create((in_hw[1], in_hw[0]), (in_hw[1], in_hw[0]), (out_hw[1], out_hw[0]))
    np.testing.assert_array_equal(_bits(fsr1.easu(torch.from_numpy(img), out_hw).numpy()),
                                  _bits(oracle.easu_ref(img, out_hw, con)))
    (sx, sy), (ox, oy) = fsr1.easu_constants(in_hw, out_hw)
    assert (sx, sy) == tuple(float(v) for v in con.scale) and (ox, oy) == tuple(float(v) for v in con.offset)


@pytest.mark.parametrize("denoise", [False, True])
@pytest.mark.parametrize("stops", [0.0, 0.25, 1.0])
def test_rcas_bit_equal(denoise, stops):
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 1, (3, 21, 33)).astype(np.float32)
    img[:, 5, 5] = 1.0   # an isolated bright pixel: the limiters' 0 * inf
    img[:, 10:13, 10:13] = 0.0
    assert fsr1.rcas_sharpness(stops) == float(RcasConstants(stops).sharpness)
    got = fsr1.rcas(torch.from_numpy(img), fsr1.rcas_sharpness(stops), denoise).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(oracle.rcas_ref(img, RcasConstants(stops), denoise=denoise)))


def test_bytes_decode_and_encode_as_the_package_does():
    codes = torch.arange(256, dtype=torch.uint8).reshape(1, 16, 16)
    np.testing.assert_array_equal(_bits(fsr1.decode_unorm8(codes).numpy()), _bits(from_uint8(codes.numpy())))
    x = np.concatenate([np.linspace(-0.5, 1.5, 4001), [np.nan]]).astype(np.float32)
    want = to_uint8(np.nan_to_num(np.clip(x, 0.0, 1.0)))
    np.testing.assert_array_equal(fsr1.encode_unorm8(torch.from_numpy(x)).numpy(), want)


def test_frame_bit_equal_to_the_oracle_chain():
    rng = np.random.default_rng(3)
    src = rng.integers(0, 256, (3, 20, 28), dtype=np.uint8)
    con = EasuConstants.create((28, 20), (28, 20), (56, 40))
    want = to_uint8(oracle.rcas_ref(oracle.easu_ref(from_uint8(src), (40, 56), con), RcasConstants(0.25)))
    np.testing.assert_array_equal(fsr1.upscale_frame(torch.from_numpy(src), (40, 56), 0.25).numpy(), want)


def test_bfloat16_control_runs_in_bfloat16():
    img = torch.rand((3, 8, 12), generator=torch.Generator().manual_seed(1))
    assert fsr1.easu(img, (16, 24), torch.bfloat16).dtype == torch.bfloat16
