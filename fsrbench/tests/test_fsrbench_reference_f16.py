"""The float16 reference (``reference/fsr1_f16.py``) against the float32 one
it builds on: in float32 its steps are ``fsr1``'s bit for bit, so it
differs from ``fsr1`` only where it rounds to half; its half bit trick
against NumPy over every positive half; the control in bfloat16."""

import numpy as np
import pytest
import torch

from fsrbench.reference import fsr1, fsr1_f16

SIZES = [((16, 24), (32, 48)), ((18, 26), (27, 39)), ((9, 13), (18, 26)), ((24, 40), (36, 60))]
CFG = {"sharpness_stops": 0.25, "apply_rcas": True, "denoise": False}


def _src(seed, hw):
    return torch.randint(0, 256, (3, *hw), dtype=torch.uint8, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("denoise", [False, True])
@pytest.mark.parametrize("in_hw, out_hw", SIZES)
def test_float32_steps_are_fsr1s(in_hw, out_hw, denoise):
    src = _src(sum(in_hw), in_hw)
    want = fsr1.upscale_frame(src, out_hw, 0.25, True, denoise, dtype=torch.float32)
    got = fsr1_f16.upscale_frame(src, out_hw, 0.25, True, denoise, dtype=torch.float32)
    assert torch.equal(got, want)
    img = fsr1.decode_unorm8(src)
    assert torch.equal(fsr1_f16.easu(img, out_hw, torch.float32).view(torch.int32),
                       fsr1.easu(img, out_hw, torch.float32).view(torch.int32))


def test_half_medium_reciprocal_over_every_positive_half():
    """``APrxMedRcpH1``: 0x778D less the bits, then b * (-b * a + 2), each
    operation rounded to half, as NumPy's float16 rounds it (beyond the
    trick's domain both read NaN, whose sign bit may differ)."""
    bits = np.arange(1, 0x7C00, dtype=np.uint16)
    a = bits.view(np.float16)
    b = (np.uint16(0x778D) - bits).view(np.float16)
    with np.errstate(over="ignore", invalid="ignore"):
        want = b * (-b * a + np.float16(2.0))
    got = fsr1_f16.prx_med_rcp_h(torch.from_numpy(a.copy())).numpy()
    finite = np.isfinite(want)
    np.testing.assert_array_equal(got[finite].view(np.uint16), want[finite].view(np.uint16))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


def test_the_half_path_differs_from_float32_and_the_control_runs_in_bfloat16():
    src = _src(3, (32, 48))
    cfg = dict(CFG, out_size=[64, 96])
    half = fsr1_f16.expected({"src": src}, cfg)
    assert half.dtype == torch.uint8 and half.shape == (3, 64, 96)
    assert not torch.equal(half, fsr1.expected({"src": src}, cfg))
    assert fsr1_f16.easu(fsr1.decode_unorm8(src), (64, 96), torch.bfloat16).dtype == torch.bfloat16
    assert not torch.equal(fsr1_f16.expected({"src": src}, cfg, torch.bfloat16), half)
