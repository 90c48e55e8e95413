"""K3 (``fsr_tpu_torch.kernels.rcas``) and ``fsr_tpu_torch.sharpen`` on the
CPU, against the JAX package.

On the CPU K3 runs its plain version (f32 ``rcas_resolve(fast=True)``,
one rounding at the end).  Tolerances: against the JAX RCAS kernel in
Pallas interpret mode 5e-4, the JAX tests' own bound
(``tests/test_kernels_general.py``: interpret mode's approximate reciprocal);
against the JAX XLA op 6e-5 (the fast limiter against the exact one, the
JAX package's fused-vs-XLA bound).  ``sharpen`` on its plain-torch path runs
the same f32 ops as ``fsr_tpu.sharpen`` on the CPU: within 2e-6 (XLA may
fuse and reassociate).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fsr_tpu
import fsr_tpu_torch
from fsr_tpu.core.constants import RcasConstants as JRcas
from fsr_tpu.kernels import rcas_pallas as jrcas_k
from fsr_tpu.ops import rcas as jrcas
from fsr_tpu.reference import scalar as jref

from fsr_tpu_torch.core.constants import RcasConstants
from fsr_tpu_torch.kernels import _build
from fsr_tpu_torch.kernels import rcas as trcas
from fsr_tpu_torch.utils import profiling

INTERPRET_TOL = 5e-4
KERNEL_TOL = 6e-5
F32_TOL = 2e-6
ORACLE_TOL = 2e-5


def _img(seed, shape, lo=0.0):
    return np.random.default_rng(seed).uniform(lo, 1, shape).astype(np.float32)


# Shared interpret-mode runs of the JAX RCAS kernel (made once).
INTERPRET_CASES = {
    "ragged clamp": dict(seed=0, shape=(3, 67, 131), border="clamp", denoise=False, stops=0.25),
    "zero denoise batched": dict(seed=1, shape=(2, 3, 40, 136), border="zero", denoise=True, stops=0.5),
}


@pytest.fixture(scope="module")
def jax_rcas():
    jrcas_k.INTERPRET = True
    try:
        return {
            name: np.asarray(jrcas_k.rcas_fused(
                jnp.asarray(_img(c["seed"], c["shape"])), JRcas(c["stops"]),
                denoise=c["denoise"], border=c["border"]))
            for name, c in INTERPRET_CASES.items()
        }
    finally:
        jrcas_k.INTERPRET = False


@pytest.mark.parametrize("name", list(INTERPRET_CASES))
def test_rcas_reference_matches_jax_kernel(jax_rcas, name):
    c = INTERPRET_CASES[name]
    got = trcas.rcas_fused(torch.from_numpy(_img(c["seed"], c["shape"])), RcasConstants(c["stops"]),
                           c["denoise"], None, c["border"])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jax_rcas[name], atol=INTERPRET_TOL, rtol=0)


def _bright():
    img = np.zeros((3, 40, 130), np.float32)
    img[:, 20, 60] = 0.5
    return img


XLA_CASES = [
    # name, image, border, denoise, sharpness stops
    ("clamp", _img(2, (3, 64, 160)), "clamp", False, 0.25),
    ("zero", _img(3, (3, 40, 136), lo=0.2), "zero", False, 0.25),
    ("denoise batched", _img(4, (2, 3, 32, 140)), "clamp", True, 0.5),
    ("zero denoise", _img(5, (3, 33, 47)), "zero", True, 0.5),
    ("isolated pixel", _bright(), "clamp", False, 0.0),
    ("one row", _img(6, (3, 1, 50)), "clamp", False, 0.25),
]


@pytest.mark.parametrize("case", XLA_CASES, ids=lambda c: c[0])
def test_rcas_reference_matches_jax_xla(case):
    _, img, border, denoise, stops = case
    got = trcas.rcas_fused_reference(torch.from_numpy(img), RcasConstants(stops), denoise, None, border)
    assert np.isfinite(got.numpy()).all()
    want = np.asarray(jrcas.rcas(jnp.asarray(img), JRcas(stops), denoise=denoise, border=border))
    np.testing.assert_allclose(got.numpy(), want, atol=KERNEL_TOL, rtol=0)


def test_rcas_reference_matches_oracle():
    img = _img(7, (3, 45, 70))
    want = jref.rcas_ref(img, JRcas(0.25))
    got = trcas.rcas_fused_reference(torch.from_numpy(img), RcasConstants(0.25))
    np.testing.assert_allclose(got.numpy(), want, atol=ORACLE_TOL, rtol=0)


@pytest.mark.parametrize("src_dt", ["float32", "bfloat16"])
def test_rcas_bf16_storage_rounds_source_first(src_dt):
    """bf16 storage: the source rounds to bf16, the math is f32, one
    rounding at the end."""
    x = torch.from_numpy(_img(8, (3, 30, 50))).to(getattr(torch, src_dt))
    got = trcas.rcas_fused(x, RcasConstants(0.25), compute_dtype=torch.bfloat16)
    want = trcas.rcas_fused_reference(x.to(torch.bfloat16).float(), RcasConstants(0.25))
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16), atol=0, rtol=0)


def test_rcas_bad_arguments_raise():
    x = torch.zeros(3, 8, 8)
    with pytest.raises(ValueError, match="border"):
        trcas.rcas_fused(x, RcasConstants(0.25), border="mirror")
    with pytest.raises(ValueError, match="3, H, W"):
        trcas.rcas_fused(torch.zeros(4, 8, 8), RcasConstants(0.25))


SHARPEN_CASES = [
    # id, input shape, sharpen kwargs (the same for both packages)
    ("defaults", (3, 36, 64), {}),
    ("HWC", (36, 64, 3), dict(layout="HWC")),
    ("RGBA", (4, 36, 64), {}),
    ("RGBA HWC", (2, 36, 64, 4), dict(layout="HWC")),
    ("border zero", (3, 36, 64), dict(border="zero")),
    ("denoise sharpness", (2, 3, 30, 50), dict(denoise=True, sharpness=0.6)),
]


@pytest.mark.parametrize("impl", ["auto", "torch", "kernel"])
@pytest.mark.parametrize("case", SHARPEN_CASES, ids=lambda c: c[0])
def test_sharpen_matches_fsr_tpu(case, impl):
    _, shape, kw = case
    img = _img(9, shape)
    want = np.asarray(fsr_tpu.sharpen(jnp.asarray(img), **kw))
    got = fsr_tpu_torch.sharpen(torch.from_numpy(img), impl=impl, **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = KERNEL_TOL if impl == "kernel" else F32_TOL
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


def test_sharpen_rgba_passes_alpha_verbatim():
    img = _img(10, (4, 20, 30))
    for impl in ("torch", "kernel"):
        got = fsr_tpu_torch.sharpen(torch.from_numpy(img), impl=impl)
        np.testing.assert_array_equal(got[3].numpy(), img[3])


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_sharpen_bf16_compute_dtype(impl):
    """bf16: the torch path accumulates in bf16 (as fsr_tpu's XLA path), the
    kernel path stores bf16 of f32 math; both are held to the f32 oracle."""
    img = _img(11, (3, 40, 72))
    got = fsr_tpu_torch.sharpen(torch.from_numpy(img), compute_dtype=torch.bfloat16, impl=impl)
    assert got.dtype == torch.bfloat16
    want = np.asarray(fsr_tpu.sharpen(jnp.asarray(img), compute_dtype=jnp.bfloat16).astype(jnp.float32))
    oracle = jref.rcas_ref(img, JRcas(0.25))
    d_got, d_jax = np.abs(got.float().numpy() - oracle), np.abs(want - oracle)
    assert np.median(d_got) <= 1.1 * np.median(d_jax) + 1e-6
    assert np.percentile(d_got, 99) <= 1.1 * np.percentile(d_jax, 99)
    if impl == "kernel":  # one rounding of the f32 result on the bf16 source
        src = np.asarray(jnp.asarray(img).astype(jnp.bfloat16).astype(jnp.float32))
        d_src = np.abs(got.float().numpy() - jref.rcas_ref(src, JRcas(0.25)))
        assert d_src.max() <= 2.0 ** -9 + ORACLE_TOL


FLOAT16 = [
    # id, sharpen kwargs beside the image: the float16 options that raised
    # until float16 was ported
    ("float16 input", lambda x: dict(image=x.half())),
    ("float16 compute", lambda x: dict(compute_dtype=torch.float16)),
]


@pytest.mark.parametrize("case", FLOAT16, ids=lambda c: c[0])
def test_sharpen_float16_runs(case):
    """float16 sharpens on both paths and stays float16: the torch path is
    FsrRcasH (held to the float16 oracle by tests/test_ops_vs_oracle.py's
    2e-3), K3 (its plain version here) f32 math on the widened half, one
    rounding (within one float16 step of the f32 oracle on the half input)."""
    _, make = case
    x = torch.from_numpy(_img(12, (3, 20, 30)))
    kw = dict(image=x)
    kw.update(make(x))
    src = x.half().float().numpy()
    for impl in ("torch", "kernel"):
        got = fsr_tpu_torch.sharpen(**kw, impl=impl)
        assert got.dtype == torch.float16 and got.shape == x.shape
        if impl == "torch":
            want, tol = jref.rcas_ref(src, JRcas(0.25), dtype=np.float16).astype(np.float32), 2e-3
        else:
            want, tol = jref.rcas_ref(src, JRcas(0.25)), 2.0 ** -11 + ORACLE_TOL
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


# The names are those of the raise this case expected before autodiff; it
# checks that a gradient flows through K3's plain version (impl="kernel")
# and equals the torch path's (tests/test_torch_grad.py holds it against
# jax.grad).
UNSUPPORTED = [
    ("grad", "kernel"),
]


@pytest.mark.parametrize("case", UNSUPPORTED, ids=lambda c: c[0])
def test_sharpen_unsupported_options_raise(case):
    _, impl = case

    def grad(impl):
        x = torch.from_numpy(_img(12, (3, 20, 30))).requires_grad_()
        fsr_tpu_torch.sharpen(x, impl=impl).sum().backward()
        return x.grad

    got = grad(impl)
    assert torch.isfinite(got).all() and got.abs().max() > 0
    torch.testing.assert_close(got, grad("torch"), atol=0, rtol=0)


def test_sharpen_bad_arguments_raise_value_error():
    x = torch.from_numpy(_img(13, (3, 20, 30)))
    for kw in (dict(impl="pallas"), dict(layout="NHWC"), dict(border="mirror")):
        with pytest.raises(ValueError):
            fsr_tpu_torch.sharpen(x, **kw)
    with pytest.raises(ValueError):
        fsr_tpu_torch.sharpen(x[:2])


def test_sharpen_on_cpu_launches_nothing():
    x = torch.from_numpy(_img(14, (3, 20, 30)))
    with profiling.recording() as rec:
        for impl in ("auto", "kernel", "torch"):
            assert fsr_tpu_torch.sharpen(x, impl=impl).shape == x.shape
    assert not rec.launches()
    assert _build.library.cache_info().currsize == 0
