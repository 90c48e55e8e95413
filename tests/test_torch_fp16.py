"""float16 on the port (FsrEasuH/FsrRcasH on the torch path, K3 on float16
storage) on the CPU, against the JAX package.

Limits: the float16 bit tricks and the numpy oracle copies are integer
arithmetic or the same numpy float16 ops, so they are bit-equal to their
originals.  ``ops.easu`` in float16 is held by the ``docs/FIDELITY.md`` f16
rows: "mixed" against the float32 oracle (median <= 1/2040, p99 <= 5/255,
<= 4% of values over 1/255) and "strict" against the float16 oracle
(median <= 1e-3, p99.9 <= 5e-3, <= 0.2% over 1/255).  Against JAX
``ops.easu`` in float16 by the strict row too: torch rounds every float16
op, where XLA on the CPU may keep float32 inside a fusion, and the
direction estimate is chaotic where it flips.  ``ops.rcas`` in float16
within 2e-3 of the float16 oracle (tests/test_ops_vs_oracle.py's bound).
K3 on float16 storage is float32 math on the widened half, rounded once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fsr_tpu
import fsr_tpu_torch
from fsr_tpu.core import approx as japprox
from fsr_tpu.core.constants import EasuConstants as JEasu
from fsr_tpu.core.constants import RcasConstants as JRcas
from fsr_tpu.kernels import rcas_pallas as jrcas_k
from fsr_tpu.ops import easu as jeasu
from fsr_tpu.ops import rcas as jrcas
from fsr_tpu.reference import scalar as jref

from fsr_tpu_torch.core import approx as tapprox
from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import rcas as trcas
from fsr_tpu_torch.ops import easu as teasu
from fsr_tpu_torch.ops import rcas as trcas_ops
from fsr_tpu_torch.reference import scalar as tref

BUDGET = 1.0 / 255.0
INTERPRET_TOL = 5e-4
F16_ULP = 2.0 ** -11  # one float16 step in [0.5, 1)


def _img(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _cons(in_hw, out_hw):
    args = ((in_hw[1], in_hw[0]), None, (out_hw[1], out_hw[0]))
    return JEasu.create(*args), EasuConstants.create(*args)


def _halves():
    """Positive float16 values over the tricks' specified range (smallest
    normal to 16384, ffx_a.h), plus a few exact ones."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(6.2e-5, 1.0, 2048), rng.uniform(1.0, 16384.0, 2048),
                        [6.104e-5, 1.0, 0.5, 2.0, 1.0 / 3.0, 1e-4, 3.14159, 16384.0]])
    return x.astype(np.float16)


@pytest.mark.parametrize("name", ["prx_lo_rcp", "prx_med_rcp", "prx_lo_rsq", "prx_lo_sqrt"])
def test_f16_bit_tricks_bit_equal_to_oracle(name):
    x = _halves()
    want = getattr(jref, name + "_f16")(x)
    got = getattr(tapprox, name)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float16
    np.testing.assert_array_equal(got.view(np.uint16), np.asarray(want, np.float16).view(np.uint16))
    np.testing.assert_array_equal(getattr(tref, name + "_f16")(x).view(np.uint16),
                                  np.asarray(want, np.float16).view(np.uint16))


@pytest.mark.parametrize("name", ["prx_lo_rcp", "prx_lo_rsq", "prx_lo_sqrt"])
def test_f16_bit_tricks_bit_equal_to_jax(name):
    """The integer tricks against ``fsr_tpu.core.approx``; its med_rcp may
    keep the Newton step in float32 inside an XLA fusion, so it is held to
    the oracle above (tests/test_approx.py allows it 2e-3)."""
    x = _halves()
    want = np.asarray(getattr(japprox, name)(jnp.asarray(x)))
    got = getattr(tapprox, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


def test_f16_med_rcp_within_jax_bound():
    x = _halves()
    want = np.asarray(japprox.prx_med_rcp(jnp.asarray(x))).astype(np.float32)
    got = tapprox.prx_med_rcp(torch.from_numpy(x)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3)


@pytest.mark.parametrize("out_hw", [(54, 80), (41, 60)])
def test_easu_ref_f16_copy_bit_equal(out_hw):
    img = _img(1, (3, 27, 40))
    jc, tc = _cons((27, 40), out_hw)
    got = tref.easu_ref_f16(img, out_hw, tc)
    want = jref.easu_ref_f16(img, out_hw, jc)
    assert got.dtype == np.float16
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


@pytest.mark.parametrize("denoise", [False, True])
@pytest.mark.parametrize("stops", [0.0, 0.25])
def test_rcas_ref_f16_copy_bit_equal(denoise, stops):
    rgba = _img(2, (4, 19, 23))
    got = tref.rcas_ref(rgba, RcasConstants(stops), denoise=denoise, dtype=np.float16)
    want = jref.rcas_ref(rgba, JRcas(stops), denoise=denoise, dtype=np.float16)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(np.asarray(got).view(np.uint16), np.asarray(want).view(np.uint16))


IN_HW, OUT_HW = (54, 96), (108, 192)


def _easu16(img, precision):
    _, tc = _cons(IN_HW, OUT_HW)
    out = teasu.easu(torch.from_numpy(img), OUT_HW, tc, compute_dtype=torch.float16, precision=precision)
    assert out.dtype == torch.float16 and out.shape == (3, *OUT_HW)
    return out.float().numpy()


def test_easu_f16_mixed_statistics():
    """FIDELITY f16 mixed row against the float32 oracle."""
    img = _img(3, (3, *IN_HW))
    jc, _ = _cons(IN_HW, OUT_HW)
    d = np.abs(_easu16(img, "mixed") - jref.easu_ref(img, OUT_HW, jc))
    assert np.median(d) <= BUDGET / 8
    assert np.percentile(d, 99) <= 5 * BUDGET
    assert (d > BUDGET).mean() <= 0.04
    assert d.max() <= 0.25  # the dering clamp bounds every pixel


def test_easu_f16_strict_matches_h_oracle():
    """FIDELITY f16 strict row against the float16 oracle (FsrEasuH)."""
    img = _img(4, (3, *IN_HW))
    jc, _ = _cons(IN_HW, OUT_HW)
    d = np.abs(_easu16(img, "strict") - jref.easu_ref_f16(img, OUT_HW, jc).astype(np.float32))
    assert np.median(d) <= 1e-3
    assert np.percentile(d, 99.9) <= 5e-3
    assert (d > BUDGET).mean() <= 0.002


def test_easu_f16_mixed_beats_strict():
    img = _img(5, (3, *IN_HW))
    jc, _ = _cons(IN_HW, OUT_HW)
    want32 = jref.easu_ref(img, OUT_HW, jc)
    mixed, strict = (np.median(np.abs(_easu16(img, p) - want32)) for p in ("mixed", "strict"))
    assert mixed <= strict


@pytest.mark.parametrize("precision", ["mixed", "strict"])
def test_easu_f16_matches_jax_ops(precision):
    img = _img(6, (2, 3, *IN_HW))
    jc, tc = _cons(IN_HW, OUT_HW)
    want = np.asarray(jeasu.easu(jnp.asarray(img), OUT_HW, jc, compute_dtype=jnp.float16,
                                 precision=precision)).astype(np.float32)
    got = teasu.easu(torch.from_numpy(img), OUT_HW, tc, compute_dtype=torch.float16,
                     precision=precision).float().numpy()
    d = np.abs(got - want)
    assert np.median(d) <= 1e-3
    assert np.percentile(d, 99.9) <= 5e-3
    assert (d > BUDGET).mean() <= 0.002


def test_easu_rejects_unknown_precision():
    _, tc = _cons(IN_HW, OUT_HW)
    with pytest.raises(ValueError, match="precision"):
        teasu.easu(torch.zeros((3, *IN_HW)), OUT_HW, tc, precision="exact")


@pytest.mark.parametrize("denoise", [False, True])
def test_rcas_f16_ops(denoise):
    """tests/test_ops_vs_oracle.py's float16 RCAS case: FsrRcasH (the
    sharpness as a half) within 2e-3 of the float16 oracle, and of JAX
    ``ops.rcas`` in float16."""
    img = _img(7, (4, 24, 40))
    got = trcas_ops.rcas(torch.from_numpy(img), RcasConstants(0.25), denoise=denoise,
                         compute_dtype=torch.float16)
    assert got.dtype == torch.float16
    got = got.float().numpy()
    np.testing.assert_array_equal(got[3], img[3].astype(np.float16).astype(np.float32))
    want = jref.rcas_ref(img, JRcas(0.25), denoise=denoise, dtype=np.float16).astype(np.float32)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
    xla = np.asarray(jrcas.rcas(jnp.asarray(img), JRcas(0.25), denoise=denoise,
                                compute_dtype=jnp.float16)).astype(np.float32)
    np.testing.assert_allclose(got, xla, atol=2e-3, rtol=0)


@pytest.mark.parametrize("border", ["clamp", "zero"])
@pytest.mark.parametrize("src_dt", ["float16", "float32"])
def test_k3_plain_version_on_f16_storage(src_dt, border):
    """K3's plain version on float16 storage: the source rounded to half,
    float32 math, one rounding to half at the store."""
    img = _img(8, (2, 3, 33, 47))
    x = torch.from_numpy(img).to(getattr(torch, src_dt))
    got = trcas.rcas_fused(x, RcasConstants(0.25), False, torch.float16, border)
    assert got.dtype == torch.float16 and got.shape == x.shape
    want = trcas.rcas_fused_reference(x.half().float(), RcasConstants(0.25), False, torch.float32, border)
    torch.testing.assert_close(got, want.half(), atol=0, rtol=0)


def test_k3_f16_matches_jax_kernel():
    """The JAX RCAS kernel in interpret mode takes float16 and returns its
    float32 result (rcas_pallas.py:66-67); the port's K3 stores float16 (a
    JAX quirk, ROADMAP.md section 3): within one half step plus the
    interpret bound."""
    img = _img(9, (3, 40, 136)).astype(np.float16)
    jrcas_k.INTERPRET = True
    try:
        want = np.asarray(jrcas_k.rcas_fused(jnp.asarray(img), JRcas(0.25)))
    finally:
        jrcas_k.INTERPRET = False
    assert want.dtype == np.float32
    got = trcas.rcas_fused(torch.from_numpy(img), RcasConstants(0.25))
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(), want, atol=F16_ULP + INTERPRET_TOL, rtol=0)


F16_UPSCALES = [
    # id, input shape, upscale kwargs (the same for both packages)
    ("f16 image", (3, 27, 48), dict(preset="performance", compute_dtype="float16"), "float16"),
    ("f16 compute", (3, 36, 64), dict(preset="quality", compute_dtype="float16"), "float32"),
    ("f16 RGBA", (4, 27, 48), dict(scale=2.0, compute_dtype="float16"), "float16"),
    ("f16 HWC", (27, 48, 3), dict(scale=2.0, layout="HWC", compute_dtype="float16"), "float16"),
]


@pytest.mark.parametrize("case", F16_UPSCALES, ids=lambda c: c[0])
def test_upscale_f16_matches_fsr_tpu(case):
    """float16 ``upscale`` runs the torch path on the tensor's device under
    impl="auto", as JAX runs it on XLA: against ``fsr_tpu.upscale`` in
    float16 by the strict row (both round in float16, at other places)."""
    _, shape, kw, src_dt = case
    img = _img(10, shape).astype(src_dt)
    jkw = {k: (getattr(jnp, v) if k == "compute_dtype" else v) for k, v in kw.items()}
    tkw = {k: (getattr(torch, v) if k == "compute_dtype" else v) for k, v in kw.items()}
    want = np.asarray(fsr_tpu.upscale(jnp.asarray(img), impl="xla", **jkw))
    got = fsr_tpu_torch.upscale(torch.from_numpy(img), **tkw)
    assert got.dtype == torch.float16 and tuple(got.shape) == want.shape
    assert torch.equal(got, fsr_tpu_torch.upscale(torch.from_numpy(img), impl="torch", **tkw))
    d = np.abs(got.float().numpy() - want.astype(np.float32))
    assert np.median(d) <= 1e-3 and (d > BUDGET).mean() <= 0.01


@pytest.mark.parametrize("what", ["image", "compute_dtype"])
def test_upscale_kernel_impl_refuses_f16(what):
    """impl="kernel" in float16 (a float16 image, then a float32 image under
    compute_dtype=float16) refuses nothing: it runs K6, here its plain
    version, bit-equal to impl="torch"."""
    x = torch.from_numpy(_img(11, (3, 27, 48)))
    kw = dict(image=x.half()) if what == "image" else dict(image=x)
    got = fsr_tpu_torch.upscale(**kw, preset="performance", compute_dtype=torch.float16, impl="kernel")
    want = fsr_tpu_torch.upscale(**kw, preset="performance", compute_dtype=torch.float16, impl="torch")
    assert got.dtype == torch.float16 and got.shape == (3, 54, 96)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
