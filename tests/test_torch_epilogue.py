"""K1's and K2's plain versions with the SRTM prologue and the K5 epilogue
(``fsr_tpu_torch.kernels.epilogue``), on the CPU, against the JAX package.

Three holds:
1. The epilogue's arithmetic: a kernel's plain version with an ``Epilogue``
   against the ``fsr_tpu.ops.extras`` chain run on the same plain version's
   output without it, as tests/test_epilogue.py:40-66 holds the JAX
   kernels.  No dither: within 2e-6 abs and 3e-5 relative; dither: at most
   4 differing values, each within 2.05 steps.
2. The whole against ``fsr_tpu.upscale(impl="xla", epilogue=, prologue=)``.
   The kernels' fast forms sit up to ~1.5e-6 from the XLA ops at these
   sizes, and the epilogue carries that difference: no dither within 2e-6
   abs and 3e-5 relative; ``srtm_inv`` compared after the forward tonemap
   (the inverse multiplies an input difference by (1 + y)^2 at output y;
   the tonemap maps its output back to the compared domain); dither at
   most 2e-4 of the values at another step (about 14 of 69120; each
   knife-edge pixel of the base difference flips one step), each within
   2.05 steps.
3. Against the JAX Pallas kernels in interpret mode (slow, so three calls
   in all, made once per module): the display case on K1 and K2 (uint8 in,
   gamma2 + grain + 8-bit dither, uint8 out) and the texture dither on K2.
   Interpret mode's approximate reciprocal puts those kernels' base up to
   5e-4 from the XLA ops (tests/test_torch_sharpen.py, and the JAX tests'
   own 2e-3 for the prologue), so their codes sit at another step on 22-60
   of 69120 values at these sizes, where the port's plain versions sit on
   0-3 from the XLA chain: at most 0.2% of the values at another code or
   step, each by one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fsr_tpu
from fsr_tpu.core.constants import EasuConstants as JEasu
from fsr_tpu.core.constants import RcasConstants as JRcas
from fsr_tpu.kernels import easu_gather as jgather
from fsr_tpu.kernels import fused as jfused
from fsr_tpu.kernels import pad as jpad
from fsr_tpu.kernels.epilogue import Epilogue as JEpilogue
from fsr_tpu.ops import extras as jx

from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import easu_gather as tgather
from fsr_tpu_torch.kernels import fused as tfused
from fsr_tpu_torch.kernels.epilogue import Epilogue
from fsr_tpu_torch.ops import extras as tx

ATOL, RTOL = 2e-6, 3e-5
MAX_FLIPS = 4
XLA_FLIP_SHARE = 2e-4
INTERPRET_FLIP_SHARE = 2e-3

SHAPES = {"K1": ((40, 144), (80, 288)), "K2": ((48, 160), (72, 240))}
EPILOGUES = [  # tests/test_epilogue.py:69-75, and the texture dither
    dict(transform="gamma2"),
    dict(transform="srtm_inv"),
    dict(grain_amount=0.3),
    dict(dither_bits=10),
    dict(transform="gamma2", grain_amount=0.25, dither_bits=8),
    dict(dither_bits=8, dither_texture=True),
]


def _cons(in_hw, out_hw):
    args = ((in_hw[1], in_hw[0]), None, (out_hw[1], out_hw[0]))
    return JEasu.create(*args), EasuConstants.create(*args)


def _inputs(kernel, seed=0):
    in_hw, out_hw = SHAPES[kernel]
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (3, *in_hw)).astype(np.float32)
    hdr = rng.uniform(0, 8, (3, *in_hw)).astype(np.float32)
    grain = rng.uniform(-0.5, 0.5, (3, *out_hw)).astype(np.float32)
    page = rng.uniform(0, 1, (128, 128)).astype(np.float32)
    return img, hdr, grain, page


def _plain(kernel, img, rcas, epi=None, prologue="none", out_dtype=None, **kw):
    """A kernel's plain version (what the CPU wrapper runs) on a numpy image."""
    in_hw, out_hw = SHAPES[kernel]
    _, tc = _cons(in_hw, out_hw)
    fn = tfused.upscale_fused_reference if kernel == "K1" else tgather.easu_gather_reference
    out = fn(torch.from_numpy(img), out_hw, tc, RcasConstants(0.25), rcas, False, torch.float32,
             epilogue=epi, prologue=prologue, out_dtype=out_dtype,
             **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    return out.numpy()


def _extras_chain(x, epi, grain, frame, page):
    x = jnp.asarray(x)
    if epi.get("transform") == "srtm_inv":
        x = jx.srtm_inv(x)
    elif epi.get("transform") == "gamma2":
        x = x * x
    if epi.get("grain_amount"):
        x = jx.lfga(x, jnp.asarray(grain), epi["grain_amount"])
    if epi.get("dither_bits"):
        if epi.get("dither_texture"):
            dit = jx.texture_dither(x.shape[-2:], 0, jnp.asarray(page))
        else:
            dit = jx.tepd_dither(x.shape[-2:], frame)
        x = jx.tepd_quantize(x, dit, bits=epi["dither_bits"])
    return np.asarray(x)


def _check_dither(got, want, bits, max_flips):
    d = np.abs(got - want)
    step = 1.0 / (255.0 if bits == 8 else 1023.0)
    assert (d > ATOL).sum() <= max_flips, f"{(d > ATOL).sum()} dither mismatches"
    assert d.max() <= 2.05 * step, f"dither mismatch beyond one step: {d.max()}"


CASES = [(k, e, r, p) for k in ("K1", "K2") for e in range(len(EPILOGUES))
         for r in (True, False) for p in ("none", "srtm")]


def _case_id(c):
    k, e, r, p = c
    return f"{k}-{'-'.join(f'{a}={b}' for a, b in EPILOGUES[e].items())}-rcas={r}-{p}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_epilogue_matches_extras_chain_and_jax_xla(case):
    kernel, e, rcas, prologue = case
    kw = EPILOGUES[e]
    img, hdr, grain, page = _inputs(kernel)
    src = hdr if prologue == "srtm" else img
    ops = dict(frame=3, grain=grain, dither_page=page)
    got = _plain(kernel, src, rcas, Epilogue(**kw), prologue, **ops)
    assert got.dtype == np.float32 and np.isfinite(got).all()

    # 1. The epilogue's arithmetic, on the plain version's own base.
    chain = _extras_chain(_plain(kernel, src, rcas, None, prologue), kw, grain, 3, page)
    # 2. The whole, against the JAX package's XLA path.
    out_hw = SHAPES[kernel][1]
    xla = np.asarray(fsr_tpu.upscale(
        jnp.asarray(src), out_size=out_hw, impl="xla", apply_rcas=rcas, epilogue=JEpilogue(**kw),
        frame=3, grain=jnp.asarray(grain), dither_page=jnp.asarray(page), prologue=prologue))
    if kw.get("dither_bits"):
        _check_dither(got, chain, kw["dither_bits"], MAX_FLIPS)
        _check_dither(got, xla, kw["dither_bits"], int(XLA_FLIP_SHARE * got.size))
        return
    np.testing.assert_allclose(got, chain, atol=ATOL, rtol=RTOL)
    if kw.get("transform") == "srtm_inv":
        got, xla = (tx.srtm(torch.from_numpy(np.array(a))).numpy() for a in (got, xla))
    np.testing.assert_allclose(got, xla, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_srtm_prologue_is_srtm_then_upscale(kernel):
    """The prologue equals the tonemap applied to the source first (the
    JAX tests' test_*_srtm_prologue, here exactly: the same ops)."""
    _, hdr, _, _ = _inputs(kernel, seed=1)
    got = _plain(kernel, hdr, True, None, "srtm")
    want = _plain(kernel, tx.srtm(torch.from_numpy(hdr)).numpy(), True)
    np.testing.assert_array_equal(got, want)


# --- 3. the JAX Pallas kernels in interpret mode ------------------------------

DISPLAY = dict(transform="gamma2", grain_amount=0.25, dither_bits=8)
TEXTURE = dict(dither_bits=10, dither_texture=True)


@pytest.fixture(scope="module")
def jax_kernels():
    """The three interpret-mode runs: (name -> JAX output)."""
    jfused.INTERPRET = jgather.INTERPRET = jpad.INTERPRET = True
    try:
        runs = {}
        for kernel in ("K1", "K2"):
            in_hw, out_hw = SHAPES[kernel]
            jc, _ = _cons(in_hw, out_hw)
            img, _, grain, page = _inputs(kernel, seed=2)
            img8 = (img * 255).astype(np.uint8)
            common = dict(epilogue=JEpilogue(**DISPLAY), frame=5, out_dtype=jnp.uint8)
            if kernel == "K1":
                gp = jfused.planarize_grain(grain, out_hw, jc)
                out = jfused.upscale_fused(jnp.asarray(img8), out_hw, jc, JRcas(0.25),
                                           grain_planar=gp, **common)
            else:
                out = jgather.easu_gather(jnp.asarray(img8), out_hw, jc, JRcas(0.25), apply_rcas=True,
                                          grain=jnp.asarray(grain), **common)
                runs["K2 texture"] = np.asarray(jgather.easu_gather(
                    jnp.asarray(img), out_hw, jc, JRcas(0.25), apply_rcas=True,
                    epilogue=JEpilogue(**TEXTURE), dither_page=jnp.asarray(page)))
            runs[f"{kernel} display"] = np.asarray(out)
        return runs
    finally:
        jfused.INTERPRET = jgather.INTERPRET = jpad.INTERPRET = False


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_display_codes_match_jax_kernel(jax_kernels, kernel):
    img, _, grain, _ = _inputs(kernel, seed=2)
    img8 = (img * 255).astype(np.uint8)
    got = _plain(kernel, img8, True, Epilogue(**DISPLAY), out_dtype=torch.uint8, frame=5, grain=grain)
    want = jax_kernels[f"{kernel} display"]
    assert got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int))
    assert (d > 0).mean() <= INTERPRET_FLIP_SHARE and d.max() <= 1


def test_texture_dither_matches_jax_kernel(jax_kernels):
    img, _, _, page = _inputs("K2", seed=2)
    got = _plain("K2", img, True, Epilogue(**TEXTURE), dither_page=page)
    _check_dither(got, jax_kernels["K2 texture"], 10, int(INTERPRET_FLIP_SHARE * got.size))


def test_any_page_shape_tiles_the_output():
    """A dither page of any shape tiles as page[y % th, x % tw] (the TPU
    kernels took only 128 x 128 pages)."""
    img, _, _, _ = _inputs("K2")
    page = np.random.default_rng(3).uniform(0, 1, (24, 40)).astype(np.float32)
    got = _plain("K2", img, True, Epilogue(**TEXTURE), dither_page=page)
    base = _plain("K2", img, True)
    want = np.asarray(jx.tepd_quantize(jnp.asarray(base), jx.texture_dither(base.shape[-2:], 0, jnp.asarray(page)),
                                       bits=10))
    _check_dither(got, want, 10, MAX_FLIPS)
