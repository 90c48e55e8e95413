"""``fsr_tpu_torch.UpscalePipeline`` on the CPU against ``fsr_tpu.UpscalePipeline``
(which runs its XLA path on the CPU).

``impl="torch"`` runs the same float32 ops as the JAX XLA path; ``impl="kernel"``
runs the kernels' plain versions (K4 + K1, or K2), whose fast forms sit up
to ~1.5e-6 from the XLA ops.  Limits (tests/test_torch_epilogue.py): no
dither within 2e-6 abs and 3e-5 relative, an HDR (srtm_inv) output compared
after the forward tonemap; dithered outputs at most 2e-4 of the values at
another step, each within 2.05 steps.  The pipeline's uint8/uint16 display
codes are in tests/test_torch_uint8.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fsr_tpu
import fsr_tpu_torch
from fsr_tpu.ops import extras as jx

from fsr_tpu_torch.core.constants import EasuConstants
from fsr_tpu_torch.kernels import easu_gather as tgather
from fsr_tpu_torch.kernels import fused as tfused
from fsr_tpu_torch.kernels import pad as tpad
from fsr_tpu_torch.ops import extras as tx
from fsr_tpu_torch.utils import noise

ATOL, RTOL = 2e-6, 3e-5
FLIP_SHARE = 2e-4
IN_HW, OUT_HW = (40, 144), (80, 288)


def _rand(seed, shape, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _run_both(kw, img, call_kw=None, **port_kw):
    """The JAX pipeline and the port's, each on its own arrays; numpy out."""
    call_kw = call_kw or {}
    jpipe = fsr_tpu.UpscalePipeline(OUT_HW, **kw)
    want = jpipe(jnp.asarray(img), **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                      for k, v in call_kw.items()})
    tkw = {k: (getattr(torch, str(np.dtype(v))) if k in ("out_dtype", "compute_dtype") else v)
           for k, v in kw.items()}
    pipe = fsr_tpu_torch.UpscalePipeline(OUT_HW, **tkw, **port_kw)
    got = pipe(torch.from_numpy(img), **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                                         for k, v in call_kw.items()})
    return got, np.asarray(want.astype(jnp.float32)) if want.dtype == jnp.bfloat16 else np.asarray(want)


def _con(in_hw, out_hw):
    return EasuConstants.create((in_hw[1], in_hw[0]), None, (out_hw[1], out_hw[0]))


def _check_dither(got, want, bits):
    d = np.abs(got - want)
    step = 1.0 / (255.0 if bits == 8 else 1023.0)
    assert (d > ATOL).mean() <= FLIP_SHARE, f"{(d > ATOL).sum()} dither mismatches"
    assert d.max() <= 2.05 * step


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_hdr_grain_dither10_matches_jax(impl):
    img = _rand(0, (3, *IN_HW), 0.0, 4.0)
    grain = _rand(1, (3, *OUT_HW), -0.5, 0.5)
    got, want = _run_both(dict(hdr_srtm=True, grain_amount=0.3, dither_bits=10), img,
                          dict(grain=grain, frame=5), impl=impl)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _check_dither(got.numpy(), want, 10)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_hdr_out_round_trip_matches_jax(impl):
    img = _rand(2, (3, *IN_HW), 0.0, 8.0)
    got, want = _run_both(dict(hdr_srtm=True, hdr_out=True), img, impl=impl)
    # the HDR output compared after the forward tonemap (module docstring)
    np.testing.assert_allclose(tx.srtm(got).numpy(), tx.srtm(torch.from_numpy(np.array(want))).numpy(),
                               atol=ATOL, rtol=RTOL)
    # and SRTM^-1 undoes the prologue's tonemap up to the filter itself
    x = fsr_tpu_torch.upscale(tx.srtm(torch.from_numpy(img)), out_size=OUT_HW, impl=impl)
    np.testing.assert_allclose(got.numpy(), tx.srtm_inv(x).numpy(), atol=0, rtol=RTOL)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_gamma2_grain_matches_jax(impl):
    img = _rand(3, (3, *IN_HW))
    grain = _rand(4, (3, *OUT_HW), -0.5, 0.5)
    got, want = _run_both(dict(gamma2_out=True, grain_amount=0.25), img, dict(grain=grain), impl=impl)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
@pytest.mark.parametrize("page_shape", [(4, 128, 128), (64, 64)])
def test_texture_dither_pages_match_jax(impl, page_shape):
    """Multi-page temporal blue noise (the page chosen by frame) and a
    64 x 64 page: the JAX package runs the latter as an XLA after-pass, the
    port fuses any page shape into the kernel."""
    img = _rand(5, (3, *IN_HW))
    tex = _rand(6, page_shape)
    got, want = _run_both(dict(dither_bits=10, dither_texture=tex), img, dict(frame=6), impl=impl)
    _check_dither(got.numpy(), want, 10)


def test_blue_noise_texture_runs_fused():
    """A generated temporal blue-noise texture through the kernel path."""
    img = _rand(7, (3, *IN_HW))
    tex = noise.temporal_blue_noise(2, (16, 16), seed=0)
    got, want = _run_both(dict(dither_bits=8, dither_texture=tex), img, dict(frame=3), impl="kernel")
    _check_dither(got.numpy(), want, 8)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_bf16_dither10_takes_the_after_pass(impl):
    """bf16 storage cannot hold 10-bit codes: the dither runs after the
    upscale, on float32 of the bf16 result, as the JAX package's XLA
    after-pass does (its bf16 base differs from the port's by bf16 rounding,
    which the quantize turns into whole steps: the after-pass is held to the
    JAX after-pass on the same base)."""
    img = _rand(8, (3, *IN_HW))
    pipe = fsr_tpu_torch.UpscalePipeline(OUT_HW, dither_bits=10, compute_dtype=torch.bfloat16, impl=impl)
    got = pipe(torch.from_numpy(img), frame=4)
    assert got.dtype == torch.float32
    base = fsr_tpu_torch.upscale(torch.from_numpy(img), out_size=OUT_HW, impl=impl,
                                 compute_dtype=torch.bfloat16).float()
    np.testing.assert_array_equal(got.numpy(), tx.tepd_quantize(base, tx.tepd_dither(OUT_HW, 4), bits=10).numpy())
    want = jx.tepd_quantize(jnp.asarray(base.numpy()), jx.tepd_dither(OUT_HW, 4), bits=10)
    _check_dither(got.numpy(), np.asarray(want), 10)
    jpipe = fsr_tpu.UpscalePipeline(OUT_HW, dither_bits=10, compute_dtype=jnp.bfloat16)
    assert jpipe(jnp.asarray(img), frame=4).dtype == jnp.float32  # the JAX pipeline's after-pass too


def test_batch_at_a_drs_ratio_runs_k2():
    """A batch of 2 at a DRS-style ratio (K2's plain version on the CPU),
    with grain and 8-bit dither into uint8 codes."""
    imgs = _rand(9, (2, 3, 40, 72))
    out_hw = (67, 121)
    grain = _rand(10, (3, *out_hw), -0.5, 0.5)
    pipe = fsr_tpu_torch.UpscalePipeline(out_hw, grain_amount=0.2, dither_bits=8, out_dtype=torch.uint8,
                                         impl="kernel")
    assert not tfused.supported((2, 3, 40, 72), out_hw, _con((40, 72), out_hw), torch.float32)
    got = pipe(torch.from_numpy(imgs), grain=torch.from_numpy(grain), frame=7).numpy()
    assert got.shape == (2, 3, *out_hw) and got.dtype == np.uint8
    jpipe = fsr_tpu.UpscalePipeline(out_hw, grain_amount=0.2, dither_bits=8, out_dtype=jnp.uint8)
    want = np.asarray(jpipe(jnp.asarray(imgs), grain=jnp.asarray(grain), frame=7))
    d = np.abs(got.astype(int) - want.astype(int))
    assert (d > 0).mean() <= 1e-3 and d.max() <= 1
    for i in range(2):
        np.testing.assert_array_equal(got[i], pipe(torch.from_numpy(imgs[i]), grain=torch.from_numpy(grain),
                                                   frame=7).numpy())


def test_cpu_pipeline_launches_nothing():
    counts = (tpad.edge_pad.launches, tfused.upscale_padded.launches, tgather.easu_gather.launches)
    pipe = fsr_tpu_torch.UpscalePipeline(OUT_HW, hdr_srtm=True, dither_bits=10, impl="auto")
    assert pipe(torch.from_numpy(_rand(11, (3, *IN_HW)))).shape == (3, *OUT_HW)
    assert (tpad.edge_pad.launches, tfused.upscale_padded.launches, tgather.easu_gather.launches) == counts


CONSTRUCTOR_ERRORS = [
    ("hdr_out without hdr_srtm", dict(hdr_out=True)),
    ("hdr_out and gamma2_out", dict(hdr_srtm=True, hdr_out=True, gamma2_out=True)),
    ("hdr_out and dither", dict(hdr_srtm=True, hdr_out=True, dither_bits=8)),
    ("integer HDR output", dict(hdr_srtm=True, hdr_out=True, out_dtype=torch.uint16)),
    ("uint8 10-bit codes", dict(dither_bits=10, out_dtype=torch.uint8)),
    ("bad impl", dict(impl="pallas")),
]


@pytest.mark.parametrize("case", CONSTRUCTOR_ERRORS, ids=lambda c: c[0])
def test_constructor_value_errors(case):
    with pytest.raises(ValueError):
        fsr_tpu_torch.UpscalePipeline(OUT_HW, **case[1])


def test_bad_epilogue_raises():
    x = torch.from_numpy(_rand(12, (3, *IN_HW)))
    with pytest.raises(TypeError):
        fsr_tpu_torch.upscale(x, out_size=OUT_HW, epilogue=object())
    with pytest.raises(ValueError, match="requires grain"):
        fsr_tpu_torch.upscale(x, out_size=OUT_HW, epilogue=fsr_tpu_torch.Epilogue(grain_amount=0.3))
    with pytest.raises(ValueError, match="grain="):
        fsr_tpu_torch.upscale(x, out_size=OUT_HW, grain_planar=torch.zeros(4, 3, 40, 144))
    with pytest.raises(ValueError, match="prologue"):
        fsr_tpu_torch.upscale(x, out_size=OUT_HW, prologue="pq")
