"""Port kernel modules (K4 edge_pad, K1 fused EASU+RCAS, dispatch) on the
CPU, where they run their plain versions, against the JAX kernels.

The JAX fused kernel runs in Pallas interpret mode, which is slow, so the
three interpret-mode calls are made once per module and shared.  Other
cases compare against the JAX XLA path, as the JAX package's own fused
tests do.  Tolerances: f32 within 6e-5 (the JAX package's fused-vs-XLA
bound, tests/test_pallas_fused.py); bf16 storage by median and p99, and
max-abs within one bf16 ulp below 1 (2**-8): the math is f32 on both
sides, so only rounding-boundary flips differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsr_tpu.core.constants import EasuConstants as JEasu
from fsr_tpu.core.constants import RcasConstants as JRcas
from fsr_tpu.kernels import dispatch as jdispatch
from fsr_tpu.kernels import fused as jfused
from fsr_tpu.kernels import pad as jpad
from fsr_tpu.ops import easu as jeasu
from fsr_tpu.ops import rcas as jrcas

from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import _build
from fsr_tpu_torch.kernels import dispatch as tdispatch
from fsr_tpu_torch.kernels import fused as tfused
from fsr_tpu_torch.kernels import pad as tpad

F32_TOL = 6e-5
BF16_MAX = 2.0 ** -8


def _cons(in_hw, out_hw, viewport=None, offset=(0, 0)):
    vp = viewport or in_hw
    args = ((vp[1], vp[0]), (in_hw[1], in_hw[0]), (out_hw[1], out_hw[0]), (offset[1], offset[0]))
    return JEasu.create(*args), EasuConstants.create(*args)


def _img(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


# Shared interpret-mode runs of the JAX fused kernel: (name -> (inputs, output)).
INTERPRET_CASES = {
    "f32": dict(seed=0, in_hw=(67, 131), out_hw=(134, 262), dt="float32", denoise=False, stops=0.25),
    "bf16": dict(seed=1, in_hw=(64, 384), out_hw=(128, 768), dt="bfloat16", denoise=False, stops=0.25),
    "denoise": dict(seed=2, in_hw=(48, 144), out_hw=(96, 288), dt="float32", denoise=True, stops=0.5),
}


@pytest.fixture(scope="module")
def jax_fused():
    jfused.INTERPRET = True
    try:
        runs = {}
        for name, c in INTERPRET_CASES.items():
            img = _img(c["seed"], (3, *c["in_hw"]))
            jc, _ = _cons(c["in_hw"], c["out_hw"])
            out = jdispatch.upscale_fused(
                jnp.asarray(img), c["out_hw"], jc, JRcas(c["stops"]), apply_rcas=True,
                denoise=c["denoise"], compute_dtype=jnp.dtype(c["dt"]))
            runs[name] = (img, np.asarray(out.astype(jnp.float32)), out.dtype)
        return runs
    finally:
        jfused.INTERPRET = False


def _port_fused(name, fn):
    c = INTERPRET_CASES[name]
    img = _img(c["seed"], (3, *c["in_hw"]))
    _, tc = _cons(c["in_hw"], c["out_hw"])
    dt = getattr(torch, c["dt"])
    return fn(torch.from_numpy(img), c["out_hw"], tc, RcasConstants(c["stops"]), True, c["denoise"], dt)


@pytest.mark.parametrize("name", ["f32", "denoise"])
@pytest.mark.parametrize("via", ["reference", "dispatch"])
def test_fused_f32_matches_jax_kernel(jax_fused, name, via):
    fn = tfused.upscale_fused_reference if via == "reference" else tdispatch.upscale_fused
    got = _port_fused(name, fn)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jax_fused[name][1], atol=F32_TOL, rtol=0)


def test_fused_bf16_matches_jax_kernel(jax_fused):
    got = _port_fused("bf16", tfused.upscale_fused_reference)
    assert got.dtype == torch.bfloat16 and jax_fused["bf16"][2] == jnp.bfloat16
    d = np.abs(got.float().numpy() - jax_fused["bf16"][1])
    assert np.median(d) <= 1.0 / 1250.0
    assert np.percentile(d, 99) <= 1.25 / 255.0
    assert d.max() <= BF16_MAX


def _xla(img, out_hw, jc, stops, apply_rcas=True, denoise=False):
    out = jeasu.easu(jnp.asarray(img), out_hw, jc)
    if apply_rcas:
        out = jrcas.rcas(out, JRcas(stops), denoise=denoise)
    return np.asarray(out)


XLA_CASES = [
    # name, image, out_hw, constants kwargs, sharpness stops, apply_rcas
    ("easu-only", _img(3, (3, 48, 144)), (96, 288), {}, 0.25, False),
    ("4x", _img(4, (3, 32, 64)), (128, 256), {}, 0.25, True),
    ("rows 2x cols 1x", _img(5, (3, 40, 72)), (80, 72), {}, 0.25, True),
    ("batch", _img(6, (2, 2, 3, 20, 36)), (40, 72), {}, 0.25, True),
]


def _bright():
    img = np.zeros((3, 32, 130), np.float32)
    img[:, 16, 60] = 0.5
    return img


HAZARD_CASES = [
    # The RCAS limiter's NaN-drop branch (mx4 == 0 under a lone bright texel).
    ("isolated bright pixel", _bright(), (64, 260), {}, 0.0, True),
    # A DRS viewport inside a larger container, at an integer offset.
    ("DRS input_offset", _img(7, (3, 67, 131)), (120, 256),
     dict(viewport=(60, 128), offset=(3, 2)), 0.25, True),
    # Zero direction everywhere: the normalisation's zero-protect.
    ("all-black frame", np.zeros((3, 32, 64), np.float32), (64, 128), {}, 0.25, True),
]


@pytest.mark.parametrize("case", XLA_CASES + HAZARD_CASES, ids=lambda c: c[0] if isinstance(c, tuple) else None)
def test_fused_reference_matches_jax_xla(case):
    _, img, out_hw, kw, stops, apply_rcas = case
    jc, tc = _cons(img.shape[-2:], out_hw, **kw)
    assert tfused.supported(img.shape, out_hw, tc, torch.float32)
    got = tfused.upscale_fused_reference(
        torch.from_numpy(img), out_hw, tc, RcasConstants(stops), apply_rcas, False, torch.float32).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _xla(img, out_hw, jc, stops, apply_rcas), atol=F32_TOL, rtol=0)


PAD_CASES = [
    # Kernel-path shapes of the JAX pad (8 | h, 128 | w) and ragged ones.
    ((3, 136, 256), (3, 5, 3, 61), "float32", "float32"),
    ((3, 136, 256), (3, 5, 3, 61), "float32", "bfloat16"),
    ((3, 136, 256), (3, 5, 3, 61), "bfloat16", "bfloat16"),
    ((2, 3, 144, 128), (2, 7, 1, 40), "float32", "bfloat16"),
    ((3, 67, 131), (3, 5, 2, 7), "float32", "float32"),
    ((2, 3, 7, 9), (4, 4, 4, 4), "bfloat16", "float32"),
]


@pytest.mark.parametrize("shape,pads,src_dt,dt", PAD_CASES)
def test_edge_pad_reference_bit_equal_to_jax(monkeypatch, shape, pads, src_dt, dt):
    monkeypatch.setattr(jpad, "INTERPRET", True)
    x = jnp.asarray(_img(8, shape)).astype(jnp.dtype(src_dt))
    want = np.asarray(jpad.edge_pad(x, pads, jnp.dtype(dt)).astype(jnp.float32))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, src_dt))
    got = tpad.edge_pad_reference(xt, pads, getattr(torch, dt))
    assert got.dtype == getattr(torch, dt)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_cpu_calls_count_no_launches_and_build_nothing():
    """On CPU tensors the wrappers take their plain versions, launch
    nothing and never reach the compiler (the modules import without nvcc)."""
    n4, n1 = tpad.edge_pad.launches, tfused.upscale_padded.launches
    x = torch.from_numpy(_img(9, (3, 20, 36)))
    _, tc = _cons((20, 36), (40, 72))
    out = tdispatch.upscale_fused(x, (40, 72), tc, RcasConstants(0.25), True, False, torch.float32)
    assert out.shape == (3, 40, 72)
    assert (tpad.edge_pad.launches, tfused.upscale_padded.launches) == (n4, n1)
    assert _build.library.cache_info().currsize == 0


def test_dispatch_raises_on_unsupported_ratio():
    # 1.5x has no integer phase structure: K1 refuses it and K2 takes it.
    x = torch.from_numpy(_img(10, (3, 72, 128)))
    jc, tc = _cons((72, 128), (108, 192))
    assert not tfused.supported(x.shape, (108, 192), tc, torch.float32)
    assert not jfused.supported((3, 72, 128), (108, 192), jc, jnp.float32)
    assert tdispatch.supported(x, (108, 192), tc, torch.float32)
    # A downscale is outside both kernels (the EASU 1x-4x contract).
    _, tc_dn = _cons((72, 128), (54, 96))
    assert not tdispatch.supported(x, (54, 96), tc_dn, torch.float32)
    with pytest.raises(NotImplementedError, match="impl='torch'"):
        tdispatch.upscale_fused(x, (54, 96), tc_dn, RcasConstants(0.25), True, False, torch.float32)


def test_supported_gating_matches_jax():
    for in_hw, out_hw in [((540, 960), (1080, 1920)), ((32, 64), (128, 256)), ((64, 128), (128, 128))]:
        jc, tc = _cons(in_hw, out_hw)
        for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            assert tfused.supported((3, *in_hw), out_hw, tc, tdt) == jfused.supported(
                (3, *in_hw), out_hw, jc, jdt)
        assert not tfused.supported((3, *in_hw), out_hw, tc, torch.float16)
        # RGBA takes the same gate (alpha is resolved in the same launch).
        assert tfused.supported((4, *in_hw), out_hw, tc, torch.float32) == jfused.supported(
            (4, *in_hw), out_hw, jc, jnp.float32)
