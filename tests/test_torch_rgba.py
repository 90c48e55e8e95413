"""RGBA on the port (K1, K2 and their plain versions, the epilogue,
``upscale``, ``UpscalePipeline``) on the CPU, against the JAX package.

Alpha is bilinear with the colour's coordinate mapping, never sharpened,
tonemapped or touched by the epilogue, and stored by the colour's rule.
Limits: the RGB of an RGBA call is bit-equal to the 3-channel call of the
same function; float32 alpha is bit-equal to the numpy oracle's
``bilinear_ref``, whose unfused op order the CUDA kernels follow
(``bilinear_alpha`` in csrc/fsr_pixel.cuh), and within 1e-7 (one float32
ulp below 1, the JAX kernels' own bound in tests/test_pallas_fused.py) of
``fsr_tpu.ops.easu.bilinear``, whose two lerps XLA contracts into FMAs on
the CPU (``test_xla_bilinear_is_the_fma_form``).  Against the JAX kernels
in interpret mode, RGB within the interpret bounds of
tests/test_torch_kernels.py and test_torch_gather.py.  Byte and 10-bit
alpha codes equal the encode of the oracle's bilinear exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fsr_tpu
import fsr_tpu_torch
from fsr_tpu.core.constants import EasuConstants as JEasu
from fsr_tpu.core.constants import RcasConstants as JRcas
from fsr_tpu.kernels import easu_gather as jgather
from fsr_tpu.kernels import fused as jfused
from fsr_tpu.ops import easu as jeasu
from fsr_tpu.reference import scalar as jref

from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import easu_gather as tgather
from fsr_tpu_torch.kernels import fused as tfused
from fsr_tpu_torch.kernels.epilogue import Epilogue
from fsr_tpu_torch.utils import image as im

ALPHA_XLA = 2.0 ** -22  # four float32 ulps in [0.5, 1): the FMA lerps' drift
K1_INTERPRET = 6e-5
K2_INTERPRET = 5e-4
F32_TOL = 2e-6
KERNEL_TOL = 6e-5


def _img(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _cons(in_hw, out_hw, viewport=None, offset=(0, 0)):
    vp = viewport or in_hw
    args = ((vp[1], vp[0]), (in_hw[1], in_hw[0]), (out_hw[1], out_hw[0]), (offset[1], offset[0]))
    return JEasu.create(*args), EasuConstants.create(*args)


def _call(kname, img, out_hw, tc, **kw):
    """K1's or K2's plain version (what the CPU wrappers run) on RGB or RGBA."""
    rcas, denoise, dt = kw.pop("rcas", True), kw.pop("denoise", False), kw.pop("dt", torch.float32)
    fn = tfused.upscale_fused if kname == "K1" else tgather.easu_gather
    assert (tfused if kname == "K1" else tgather).supported(tuple(img.shape), out_hw, tc, dt)
    return fn(img, out_hw, tc, RcasConstants(0.25), rcas, denoise, dt, **kw)


CASES = [
    # id, kernel, input (h, w), output (h, w), call kwargs, (viewport, offset)
    ("K1 2x", "K1", (40, 144), (80, 288), {}, None),
    ("K1 2x denoise", "K1", (40, 144), (80, 288), dict(denoise=True), None),
    ("K1 easu only", "K1", (40, 128), (80, 256), dict(rcas=False), None),
    ("K1 4x", "K1", (16, 32), (64, 128), {}, None),
    ("K1 rows 2x cols 1x", "K1", (20, 36), (40, 36), {}, None),
    ("K1 srtm prologue", "K1", (40, 144), (80, 288), dict(prologue="srtm"), None),
    ("K1 DRS offset", "K1", (67, 131), (120, 256), {}, ((60, 128), (3, 2))),
    ("K2 1.5x", "K2", (72, 192), (108, 288), {}, None),
    ("K2 ~1.7x", "K2", (64, 160), (108, 272), {}, None),
    ("K2 ~1.3x easu only", "K2", (84, 168), (108, 216), dict(rcas=False), None),
    ("K2 native 1x", "K2", (30, 44), (30, 44), {}, None),
    ("K2 DRS 1.5x offset", "K2", (40, 72), (54, 96), dict(denoise=True), ((36, 64), (2, 4))),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_plain_versions_resolve_alpha(case):
    """RGB bit-equal to the 3-channel call; alpha bit-equal to the oracle's
    bilinear (the clamp of the K4 pad and of K2's clipped tables is the
    CLAMP of bilinear_ref), within one ulp of the XLA bilinear."""
    _, kname, in_hw, out_hw, kw, drs = case
    img = _img(0, (2, 4, *in_hw))
    jc, tc = _cons(in_hw, out_hw, *(drs or ()))
    got = _call(kname, torch.from_numpy(img), out_hw, tc, **dict(kw))
    rgb = _call(kname, torch.from_numpy(img[:, :3].copy()), out_hw, tc, **dict(kw))
    assert got.shape == (2, 4, *out_hw) and got.dtype == torch.float32
    torch.testing.assert_close(got[:, :3], rgb, atol=0, rtol=0)
    want = np.stack([jref.bilinear_ref(img[n, 3:4], out_hw, jc) for n in range(2)])
    np.testing.assert_array_equal(got[:, 3:4].numpy(), want)
    xla = np.asarray(jeasu.bilinear(jnp.asarray(img[:, 3:4]), out_hw, jc))
    np.testing.assert_allclose(got[:, 3:4].numpy(), xla, atol=ALPHA_XLA, rtol=0)


def test_xla_bilinear_is_the_fma_form():
    """The XLA bilinear on the CPU differs from the oracle's because each
    lerp a + (b - a) * p is one FMA there: modelled in float64 (the product
    of two float32 values is exact), it matches XLA bit for bit."""
    in_hw, out_hw = (40, 144), (80, 288)
    img = _img(1, (1, *in_hw))
    jc, _ = _cons(in_hw, out_hw)
    xla = np.asarray(jeasu.bilinear(jnp.asarray(img), out_hw, jc))[0]
    col, row, px, py = jeasu.easu_coords(jc, out_hw)
    c0, c1 = np.clip(col, 0, in_hw[1] - 1), np.clip(col + 1, 0, in_hw[1] - 1)
    r0, r1 = np.clip(row, 0, in_hw[0] - 1), np.clip(row + 1, 0, in_hw[0] - 1)
    s = img[0].astype(np.float64)

    def fma(a, b, c):
        return (a * b + c).astype(np.float32).astype(np.float64)

    def sub(a, b):
        return (a - b).astype(np.float32).astype(np.float64)

    pxd, pyd = px.astype(np.float64)[None, :], py.astype(np.float64)[:, None]
    top = fma(sub(s[r0][:, c1], s[r0][:, c0]), pxd, s[r0][:, c0])
    bot = fma(sub(s[r1][:, c1], s[r1][:, c0]), pxd, s[r1][:, c0])
    np.testing.assert_array_equal(fma(sub(bot, top), pyd, top).astype(np.float32), xla)
    assert (jref.bilinear_ref(img, out_hw, jc)[0] != xla).any()


@pytest.mark.parametrize("kname,src_dt", [("K1", "float32"), ("K1", "bfloat16"), ("K2", "float32"),
                                          ("K2", "bfloat16")])
def test_bf16_storage_alpha_rounds_once(kname, src_dt):
    """bfloat16 storage: alpha is the float32 bilinear of the alpha plane as
    stored (a float32 source rounds to bfloat16 first), rounded once; within
    the JAX kernels' 4e-3 of the float32 bilinear (tests/test_pallas_fused.py)."""
    in_hw, out_hw = ((40, 128), (80, 256)) if kname == "K1" else ((72, 192), (108, 288))
    img = _img(2, (4, *in_hw))
    x = torch.from_numpy(img).to(getattr(torch, src_dt))
    jc, tc = _cons(in_hw, out_hw)
    got = _call(kname, x, out_hw, tc, rcas=False, dt=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    stored = x[3:4].to(torch.bfloat16).float().numpy()
    want = torch.from_numpy(jref.bilinear_ref(stored, out_hw, jc)).to(torch.bfloat16)
    torch.testing.assert_close(got[3:4], want, atol=0, rtol=0)
    xla = np.asarray(jeasu.bilinear(jnp.asarray(img[3:4]), out_hw, jc))
    np.testing.assert_allclose(got[3:4].float().numpy(), xla, atol=4e-3, rtol=0)


# One interpret-mode call of each JAX kernel on RGBA (they are slow).
INTERPRET = {
    "K1": ((40, 144), (80, 288)),
    "K2": ((72, 192), (108, 288)),
}


@pytest.fixture(scope="module")
def jax_rgba():
    runs = {}
    for kname, (in_hw, out_hw) in INTERPRET.items():
        mod = jfused if kname == "K1" else jgather
        jc, _ = _cons(in_hw, out_hw)
        img = jnp.asarray(_img(3, (4, *in_hw)))
        mod.INTERPRET = True
        try:
            if kname == "K1":
                out = jfused.upscale_fused(img, out_hw, jc, JRcas(0.25))
            else:
                out = jgather.easu_gather(img, out_hw, jc, JRcas(0.25), apply_rcas=True)
            runs[kname] = np.asarray(out)
        finally:
            mod.INTERPRET = False
    return runs


@pytest.mark.parametrize("kname", list(INTERPRET))
def test_rgba_matches_jax_kernel(jax_rgba, kname):
    """One launch for RGBA in both packages.  The JAX kernel's alpha is its
    XLA bilinear bit for bit (FMA lerps on the CPU); the port's is within one
    ulp of it, and its RGB within the interpret bound."""
    in_hw, out_hw = INTERPRET[kname]
    img = _img(3, (4, *in_hw))
    jc, tc = _cons(in_hw, out_hw)
    want = jax_rgba[kname]
    np.testing.assert_array_equal(want[3:4], np.asarray(jeasu.bilinear(jnp.asarray(img[3:4]), out_hw, jc)))
    got = _call(kname, torch.from_numpy(img), out_hw, tc).numpy()
    assert got.shape == want.shape == (4, *out_hw)
    tol = K1_INTERPRET if kname == "K1" else K2_INTERPRET
    np.testing.assert_allclose(got[:3], want[:3], atol=tol, rtol=0)
    np.testing.assert_allclose(got[3], want[3], atol=ALPHA_XLA, rtol=0)


def _img8(seed, shape):
    return (np.random.default_rng(seed).uniform(0, 1, shape) * 255).astype(np.uint8)


@pytest.mark.parametrize("impl", ["kernel", "torch"])
@pytest.mark.parametrize("out_dtype", ["uint8", "uint16"])
@pytest.mark.parametrize("scale", [2.0, 1.5])
def test_alpha_codes(scale, out_dtype, impl):
    """tests/test_uint8.py's RGBA case: alpha codes are the encode of the
    bilinear of the decoded alpha, exactly, on both paths (K1 at 2x, K2 at
    1.5x); RGB codes equal the 3-channel call's; against the JAX XLA path at
    most a few codes differ, by one (its FMA lerps)."""
    in_hw = (32, 48)
    out_hw = (round(32 * scale), round(48 * scale))
    img8 = _img8(4, (4, *in_hw))
    odt = getattr(torch, out_dtype)
    got = fsr_tpu_torch.upscale(torch.from_numpy(img8), scale=scale, out_dtype=odt, impl=impl)
    assert got.shape == (4, *out_hw) and got.dtype == odt
    rgb = fsr_tpu_torch.upscale(torch.from_numpy(img8[:3].copy()), scale=scale, out_dtype=odt, impl=impl)
    torch.testing.assert_close(got[:3], rgb, atol=0, rtol=0)
    jc, _ = _cons(in_hw, out_hw)
    encode = im.to_uint8 if out_dtype == "uint8" else im.to_uint10
    want = encode(jref.bilinear_ref(im.from_uint8(img8[3:4]), out_hw, jc))
    np.testing.assert_array_equal(got[3:4].numpy(), want)
    jax_codes = np.asarray(fsr_tpu.upscale(jnp.asarray(img8), scale=scale, impl="xla",
                                           out_dtype=getattr(jnp, out_dtype)))[3].astype(np.int32)
    d = np.abs(got[3].numpy().astype(np.int32) - jax_codes)
    assert d.max() <= 1 and (d > 0).mean() <= 5e-3


EPILOGUES = [
    # id, epilogue, out_dtype
    ("gamma2", Epilogue(transform="gamma2"), None),
    ("srtm_inv", Epilogue(transform="srtm_inv"), None),
    ("grain + dither10", Epilogue(grain_amount=0.3, dither_bits=10), None),
    ("gamma2 + page dither8, uint8", Epilogue(transform="gamma2", dither_bits=8, dither_texture=True), torch.uint8),
    ("dither10, uint16", Epilogue(dither_bits=10), torch.uint16),
]


@pytest.mark.parametrize("kname", ["K1", "K2"])
@pytest.mark.parametrize("case", EPILOGUES, ids=lambda c: c[0])
def test_epilogue_leaves_alpha(case, kname):
    """The K5 epilogue runs on RGB (equal to the 3-channel call with the same
    epilogue) and alpha rides through, stored by the output's rule."""
    _, epi, od = case
    in_hw, out_hw = ((40, 144), (80, 288)) if kname == "K1" else ((72, 192), (108, 288))
    img = _img(5, (4, *in_hw))
    _, tc = _cons(in_hw, out_hw)
    kw = dict(epilogue=epi, frame=3, grain=torch.from_numpy(_img(6, (3, *out_hw)) - 0.5),
              dither_page=torch.from_numpy(_img(7, (16, 24))), out_dtype=od)
    got = _call(kname, torch.from_numpy(img), out_hw, tc, **kw)
    rgb = _call(kname, torch.from_numpy(img[:3].copy()), out_hw, tc, **kw)
    torch.testing.assert_close(got[:3], rgb, atol=0, rtol=0)
    bare = _call(kname, torch.from_numpy(img), out_hw, tc, out_dtype=od)
    torch.testing.assert_close(got[3], bare[3], atol=0, rtol=0)


API_CASES = [
    # id, input shape, upscale kwargs (the same for both packages)
    ("performance", (4, 27, 48), dict(preset="performance")),
    ("quality", (4, 36, 64), dict(preset="quality")),
    ("HWC", (27, 48, 4), dict(scale=2.0, layout="HWC")),
    ("HWC batch", (2, 30, 44, 4), dict(preset="ultra_quality", layout="HWC")),
    ("DRS offset", (2, 4, 40, 72), dict(scale=2.0, input_viewport=(36, 64), input_offset=(2, 4))),
    ("easu only", (4, 24, 36), dict(scale=2.0, apply_rcas=False)),
]


@pytest.mark.parametrize("impl", ["auto", "kernel"])
@pytest.mark.parametrize("case", API_CASES, ids=lambda c: c[0])
def test_upscale_rgba_matches_fsr_tpu(case, impl):
    """tests/test_api.py's alpha case: ``upscale`` on RGBA against
    ``fsr_tpu.upscale(impl="xla")``: RGB within the torch path's 2e-6 (the
    kernels' plain versions 6e-5), alpha within one ulp; RGB equal to the
    3-channel call's, alpha to the oracle's bilinear."""
    _, shape, kw = case
    img = _img(8, shape)
    want = np.asarray(fsr_tpu.upscale(jnp.asarray(img), impl="xla", **kw))
    got = fsr_tpu_torch.upscale(torch.from_numpy(img), impl=impl, **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    ch = -1 if kw.get("layout") == "HWC" else -3
    g, w = np.moveaxis(got.numpy(), ch, 0), np.moveaxis(want, ch, 0)
    np.testing.assert_allclose(g[:3], w[:3], atol=F32_TOL if impl == "auto" else KERNEL_TOL, rtol=0)
    np.testing.assert_allclose(g[3], w[3], atol=ALPHA_XLA, rtol=0)
    rgb = fsr_tpu_torch.upscale(torch.from_numpy(np.take(img, [0, 1, 2], axis=ch)), impl=impl, **kw)
    np.testing.assert_array_equal(g[:3], np.moveaxis(rgb.numpy(), ch, 0))


def test_upscale_rgba_bf16_alpha_within_the_bf16_contract():
    """bf16 storage: the kernel path's alpha is the bilinear of the bf16
    alpha plane rounded once; the JAX XLA path rounds the f32 bilinear once.
    They differ only by the input rounding: within 2**-8 (ROADMAP.md §3)."""
    img = _img(9, (4, 36, 64))
    want = np.asarray(fsr_tpu.upscale(jnp.asarray(img), preset="quality", impl="xla",
                                      compute_dtype=jnp.bfloat16).astype(jnp.float32))
    got = fsr_tpu_torch.upscale(torch.from_numpy(img), preset="quality", impl="kernel",
                                compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    d = np.abs(got[3].float().numpy() - want[3])
    assert d.max() <= 2.0 ** -8 and np.median(d) <= 1.0 / 1250.0


def _pipe_pair(kw, img, **port_kw):
    jpipe = fsr_tpu.UpscalePipeline((80, 288), **{k: (getattr(jnp, str(v).split(".")[-1])
                                                      if k == "compute_dtype" else v) for k, v in kw.items()})
    want = jpipe(jnp.asarray(img), frame=5)
    got = fsr_tpu_torch.UpscalePipeline((80, 288), **kw, **port_kw)(torch.from_numpy(img), frame=5)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_pipeline_fused_dither_leaves_alpha(impl):
    """float32 storage fuses the TEPD dither: it runs on RGB and alpha stays
    the bilinear, on both paths and in the JAX pipeline."""
    img = _img(10, (4, 40, 144))
    got, want = _pipe_pair(dict(dither_bits=8, compute_dtype=torch.float32), img, impl=impl)
    jc, _ = _cons((40, 144), (80, 288))
    np.testing.assert_array_equal(got[3:4], jref.bilinear_ref(img[3:4], (80, 288), jc))
    np.testing.assert_allclose(got[3], want[3], atol=ALPHA_XLA, rtol=0)
    d = np.abs(got[:3] - want[:3])
    assert (d > F32_TOL).mean() <= 2e-4 and d.max() <= 2.05 / 255.0


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_pipeline_bf16_after_pass_dithers_alpha(impl):
    """bfloat16 storage cannot hold the TEPD codes, so the dither runs as an
    after-pass over the whole output; the JAX pipeline's after-pass
    (fsr_tpu/api.py:600-605) is elementwise over every channel, alpha
    included, and the port does the same (ROADMAP.md §3).  The frame holds
    bfloat16 values, so the kernel path's alpha (the bilinear of the stored
    bfloat16 plane) and the XLA path's (of the float32 plane) start equal."""
    img = torch.from_numpy(_img(11, (4, 40, 144))).bfloat16().float().numpy()
    got, want = _pipe_pair(dict(dither_bits=10, compute_dtype=torch.bfloat16), img, impl=impl)
    codes = got[3] * 1023.0  # tepd_quantize returns the gamma-2 code level k/1023
    np.testing.assert_allclose(codes, np.round(codes), atol=2e-3)
    jc, _ = _cons((40, 144), (80, 288))
    assert (got[3] != jref.bilinear_ref(img[3:4], (80, 288), jc)[0]).mean() > 0.5
    d = np.abs(got[3] - want[3])
    assert (d > F32_TOL).mean() <= 2e-3 and d.max() <= 2.05 / 1023.0
