"""Gradients through the port (``fsr_tpu_torch``) against ``jax.grad`` of the
JAX package, on the CPU.  Mirrors tests/test_grad.py case by case.

The bit tricks carry the ideal functions' derivatives under the non-finite
guard (``core/approx.py``), as the JAX package's ``custom_jvp`` rules do;
the kernel path runs the kernel forward (here its plain version) and
differentiates the torch path's twin (``fsr_tpu_torch.autodiff``), as the
JAX package's kernel path differentiates its XLA twin.  So JAX's kernel-path
gradient is its ``impl="xla"`` gradient (tests/test_grad.py:101-130), and
the port is held to that.

Limits:
- float32, the port's torch path against ``jax.grad`` of the XLA path:
  max|dg| <= 1e-5 * max|g| (measured at most 1.2e-6 relative: the two sum
  the same terms in other orders), every value finite.
- the port's kernel path against its torch path: bit-equal under a linear
  loss (the incoming cotangent is ones on both); under a squared loss the
  cotangent is 2*out, and the two forwards differ by the kernels' fidelity
  budget: rtol 5e-3, atol 5e-4, as tests/test_grad.py holds JAX's.  In
  bfloat16 storage the twin accumulates its gradient in bfloat16, where a
  luma difference of one bf16 step meets the ideal -1/a^2 of a reciprocal
  and spikes (so does JAX's, op by op); the squared-loss gradients are held
  by p99 <= 3e-2 * max|g| and median <= 2e-3 * max|g| (measured at most
  1.4e-2 and 9e-4 on seeds 11-14 at 64x96 -> 128x192).
- bfloat16 and float16 against JAX op by op (``jax.disable_jit``: jitted
  XLA keeps excess precision inside fusions, tests/test_torch_ops.py; op
  by op the forwards are bit-equal), relative to max|g|: bfloat16 max
  6e-2, p99 1.5e-2, median 2e-3; float16 max 1e-2, p99 3e-3, median 5e-4.
  Both sides sum the partial gradients in the low-precision type, in other
  orders; measured on seeds 11-13 at 16x20 -> 32x40 at most 4.1e-2,
  9.4e-3, 1.2e-3 (bfloat16) and 3.6e-3, 1.2e-3, 1.6e-4 (float16).
- the directional derivative along all-ones: 3 * Hout * Wout, rtol 5e-2
  (tests/test_grad.py).
- the bilinear gradient against central differences: rtol 2e-2, atol 1e-3.
- the inverse problem's Adam steps against the JAX example's: see
  ``test_adam_update_matches_jax_adam_step`` and
  ``test_inverse_steps_match_jax``.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fsr_tpu
import fsr_tpu_torch
from fsr_tpu.core import approx as japprox
from fsr_tpu.core.constants import EasuConstants as JEasu
from fsr_tpu.core.constants import RcasConstants as JRcas
from fsr_tpu.kernels.epilogue import Epilogue as JEpilogue
from fsr_tpu.ops import easu as jeasu
from fsr_tpu.ops import rcas as jrcas
from fsr_tpu.parallel import sharding as jsharding
from fsr_tpu.parallel import spatial as jspatial

from fsr_tpu_torch.core import approx
from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import easu_gather, fused
from fsr_tpu_torch.kernels import rcas as rcas_kernel
from fsr_tpu_torch.kernels.epilogue import Epilogue
from fsr_tpu_torch.ops import easu as teasu
from fsr_tpu_torch.ops import rcas as trcas
from fsr_tpu_torch.parallel import sharding, spatial
from fsr_tpu_torch.utils import capture

REL = 1e-5
# (max, p99, median) of |dg| / max|g|
LP_LIMITS = {"bfloat16": (6e-2, 1.5e-2, 2e-3), "float16": (1e-2, 3e-3, 5e-4)}
SQ_RTOL, SQ_ATOL = 5e-3, 5e-4
BF16_SQ_P99, BF16_SQ_MEDIAN = 3e-2, 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops per test; beside other pytest workers torch's
    intra-op threads oversubscribe the cores.  One thread for this module;
    restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _img(seed, shape, lo=0.1, hi=0.9):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _grad(fn, img, dtype=torch.float32, square=False):
    """d sum(fn(x)) / dx (or of sum(fn(x)**2)) at x = img in ``dtype``,
    with the loss in float32; returns (value, gradient as float32 numpy)."""
    x = torch.from_numpy(img).to(dtype).requires_grad_()
    out = fn(x).float()
    loss = (out * out).sum() if square else out.sum()
    loss.backward()
    return loss.item(), x.grad.float().numpy()


def _jgrad(fn, img, dtype=jnp.float32, square=False, jit=True):
    """``jax.grad`` of the same loss; ``jit=False`` runs it op by op."""

    def loss(x):
        out = fn(x).astype(jnp.float32)
        return jnp.sum(out * out) if square else jnp.sum(out)

    def run():
        return np.asarray(jax.grad(loss)(jnp.asarray(img).astype(dtype)).astype(jnp.float32))

    if jit:
        return run()
    with jax.disable_jit():
        return run()


def _close_rel(got, want, rel=REL):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 0.0
    d = np.abs(got - want).max()
    assert d <= rel * scale, f"max|dg| {d:.3e} > {rel:g} * max|g| ({scale:.3e})"


# --- the bit tricks' derivatives --------------------------------------------

TRICKS = [
    ("prx_lo_rcp", lambda a: -1.0 / (a * a)),
    ("prx_med_rcp", lambda a: -1.0 / (a * a)),
    ("prx_lo_rsq", lambda a: -0.5 * a ** -1.5),
    ("prx_lo_sqrt", lambda a: 0.5 * a ** -0.5),
    ("rcp", lambda a: -1.0 / (a * a)),
]


@pytest.mark.parametrize("dt", ["float32", "float16"])
def test_approx_grads_are_ideal_derivatives(dt):
    """Reverse and forward mode give d/da of the ideal function at a = 2
    (JAX's custom_jvp tangents), and a zero where it is not finite."""
    rtol = 1e-6 if dt == "float32" else 1e-3
    for name, want in TRICKS:
        fn = getattr(approx, name)
        a = torch.tensor(2.0, dtype=getattr(torch, dt), requires_grad=True)
        (g,) = torch.autograd.grad(fn(a), a)
        _, t = torch.func.jvp(fn, (a.detach(),), (torch.ones_like(a),))
        _, jt = jax.jvp(getattr(japprox, name), (jnp.asarray(2.0, dt),), (jnp.asarray(1.0, dt),))
        for v in (g, t):
            assert v.dtype == a.dtype
            np.testing.assert_allclose(float(v), want(2.0), rtol=rtol, err_msg=name)
        np.testing.assert_allclose(float(g), float(jt), rtol=rtol, err_msg=name)
        z = torch.zeros((), dtype=a.dtype, requires_grad=True)
        (g0,) = torch.autograd.grad(fn(z), z)
        assert float(g0) == 0.0, name


@pytest.mark.parametrize("dt", ["float32", "float16"])
def test_approx_forward_values_unchanged(dt):
    """The differentiable tricks return the same bits with and without a
    graph."""
    a = torch.from_numpy(_img(1, (257,), 0.01, 8.0)).to(getattr(torch, dt))
    for name, _ in TRICKS:
        fn = getattr(approx, name)
        with torch.no_grad():
            want = fn(a)
        got = fn(a.clone().requires_grad_())
        assert got.grad_fn is not None
        assert torch.equal(got.detach().view(torch.int16 if dt == "float16" else torch.int32),
                           want.view(torch.int16 if dt == "float16" else torch.int32)), name


# --- the ops ------------------------------------------------------------------


@pytest.mark.parametrize("square", [False, True], ids=["linear", "squared"])
@pytest.mark.parametrize("in_hw,out_hw", [((24, 32), (48, 64)), ((20, 26), (30, 39))], ids=["2x", "1.5x"])
def test_grad_easu_rcas_matches_jax(in_hw, out_hw, square):
    """The fault's regression test: the integer views once cut the graph
    (no derivative through APrxLoRcp/Rsq/Sqrt, only the Newton step's
    through APrxMedRcp, 0 * inf through rcp), up to 51.7 from jax.grad."""
    img = _img(11, (3, *in_hw))
    jc = JEasu.create((in_hw[1], in_hw[0]), None, (out_hw[1], out_hw[0]))
    tc = EasuConstants.create((in_hw[1], in_hw[0]), None, (out_hw[1], out_hw[0]))
    want = _jgrad(lambda x: jrcas.rcas(jeasu.easu(x, out_hw, jc), JRcas(0.25)), img, square=square)
    _, got = _grad(lambda x: trcas.rcas(teasu.easu(x, out_hw, tc), RcasConstants(0.25)), img, square=square)
    _close_rel(got, want)


def test_shift_equivariance_directional_derivative():
    """EASU+RCAS are shift-equivariant, so the directional derivative along
    all-ones is ~1 per output element (forward mode through the tricks'
    jvp rules; tests/test_grad.py's limit)."""
    img = torch.from_numpy(_img(11, (3, 24, 32), 0.2, 0.8))
    tc = EasuConstants.create((32, 24), None, (64, 48))

    def f(x):
        return trcas.rcas(teasu.easu(x, (48, 64), tc), RcasConstants(0.25)).sum()

    _, dd = torch.func.jvp(f, (img,), (torch.ones_like(img),))
    np.testing.assert_allclose(float(dd), 3 * 48 * 64, rtol=5e-2)
    x = img.clone().requires_grad_()
    f(x).backward()
    np.testing.assert_allclose(float(dd), float(x.grad.sum()), rtol=1e-5)


@pytest.mark.parametrize("scale", [1.5, 2.0])
def test_grad_through_upscale(scale):
    img = _img(11, (3, 20, 26))
    want = _jgrad(lambda x: fsr_tpu.upscale(x, scale=scale, impl="xla"), img)
    _, got = _grad(lambda x: fsr_tpu_torch.upscale(x, scale=scale, impl="torch"), img)
    _close_rel(got, want)


def test_bilinear_grad_matches_finite_difference():
    """The bilinear alpha path is piecewise linear: its gradient matches
    central differences away from weight kinks, and jax.grad."""
    img = _img(11, (3, 12, 16))
    con = EasuConstants.create((16, 12), None, (32, 24))

    def loss(x):
        return (teasu.bilinear(x, (24, 32), con) ** 2).sum()

    x = torch.from_numpy(img).requires_grad_()
    loss(x).backward()
    g = x.grad.numpy()
    jc = JEasu.create((16, 12), None, (32, 24))
    _close_rel(g, _jgrad(lambda v: jeasu.bilinear(v, (24, 32), jc), img, square=True))
    eps = 1e-3
    for c, i, j in [(0, 5, 7), (1, 0, 0), (2, 11, 15)]:
        up, dn = img.copy(), img.copy()
        up[c, i, j] += eps
        dn[c, i, j] -= eps
        fd = (loss(torch.from_numpy(up)).item() - loss(torch.from_numpy(dn)).item()) / (2 * eps)
        np.testing.assert_allclose(g[c, i, j], fd, rtol=2e-2, atol=1e-3)


# --- the kernel path -------------------------------------------------------------

KERNEL_CASES = [
    ("K1 2x", dict(scale=2.0), fused, "upscale_fused_reference"),
    ("K2 1.5x", dict(scale=1.5), easu_gather, "easu_gather_reference"),
]


@pytest.mark.parametrize("case", KERNEL_CASES, ids=lambda c: c[0])
def test_kernel_path_grad_equals_torch_path(case, monkeypatch):
    """Forward through the kernel's plain version (checked by counting its
    calls), backward through the torch twin: bit-equal to the torch path
    under a linear loss, within the fidelity budget under a squared one."""
    _, kw, module, plain = case
    img = _img(11, (3, 32, 80))
    calls = []
    real = getattr(module, plain)

    def counted(*a, **k):
        calls.append(torch.is_grad_enabled())
        return real(*a, **k)

    monkeypatch.setattr(module, plain, counted)
    v_k, g_k = _grad(lambda x: fsr_tpu_torch.upscale(x, impl="kernel", **kw), img)
    assert calls == [False]  # one forward, outside the graph; none in the backward
    v_t, g_t = _grad(lambda x: fsr_tpu_torch.upscale(x, impl="torch", **kw), img)
    assert len(calls) == 1
    np.testing.assert_array_equal(g_k, g_t)
    np.testing.assert_allclose(v_k, v_t, rtol=1e-4)
    assert np.abs(g_k).max() > 0.0
    _, gq_k = _grad(lambda x: fsr_tpu_torch.upscale(x, impl="kernel", **kw), img, square=True)
    _, gq_t = _grad(lambda x: fsr_tpu_torch.upscale(x, impl="torch", **kw), img, square=True)
    np.testing.assert_allclose(gq_k, gq_t, rtol=SQ_RTOL, atol=SQ_ATOL)
    _close_rel(g_t, _jgrad(lambda x: fsr_tpu.upscale(x, impl="xla", **kw), img))


def test_grain_changes_the_gradient():
    """The twin includes LFGA: the grain's term changes the gradient, the
    kernel path's equals the torch path's, and both match jax.grad with the
    same grain (frame and grain take no gradient)."""
    img = _img(11, (3, 32, 80))
    grain = _img(12, (3, 64, 160), -0.5, 0.5)
    kw = dict(scale=2.0, epilogue=Epilogue(grain_amount=0.35), frame=3, grain=torch.from_numpy(grain))
    _, g = _grad(lambda x: fsr_tpu_torch.upscale(x, impl="kernel", **kw), img)
    _, g_t = _grad(lambda x: fsr_tpu_torch.upscale(x, impl="torch", **kw), img)
    _, g0 = _grad(lambda x: fsr_tpu_torch.upscale(x, impl="kernel", scale=2.0), img)
    assert np.isfinite(g).all() and np.abs(g - g0).max() > 0.0
    np.testing.assert_array_equal(g, g_t)
    jkw = dict(scale=2.0, epilogue=JEpilogue(grain_amount=0.35), frame=3, grain=jnp.asarray(grain))
    _close_rel(g, _jgrad(lambda x: fsr_tpu.upscale(x, impl="xla", **jkw), img))


@pytest.mark.parametrize("channels", [3, 4], ids=["rgb", "rgba"])
def test_sharpen_grad(channels, monkeypatch):
    img = _img(11, (channels, 32, 80))
    calls = []
    real = rcas_kernel.rcas_fused_reference
    monkeypatch.setattr(rcas_kernel, "rcas_fused_reference", lambda *a, **k: calls.append(1) or real(*a, **k))
    _, g_k = _grad(lambda x: fsr_tpu_torch.sharpen(x, impl="kernel"), img)
    assert calls == [1]
    _, g_t = _grad(lambda x: fsr_tpu_torch.sharpen(x, impl="torch"), img)
    np.testing.assert_array_equal(g_k, g_t)
    _close_rel(g_t, _jgrad(lambda x: fsr_tpu.sharpen(x, impl="xla"), img))
    if channels == 4:  # alpha passes through: an identity gradient
        np.testing.assert_array_equal(g_k[3], np.ones_like(g_k[3]))


@pytest.mark.parametrize("scale", [2.0, 1.5])
def test_rgba_alpha_gradient(scale):
    """RGBA enters the kernel and its twin whole: alpha takes the bilinear
    gradient, RGB the EASU+RCAS one, both as jax.grad gives them."""
    img = _img(11, (4, 20, 26))
    _, g_k = _grad(lambda x: fsr_tpu_torch.upscale(x, scale=scale, impl="kernel"), img)
    _, g_t = _grad(lambda x: fsr_tpu_torch.upscale(x, scale=scale, impl="torch"), img)
    np.testing.assert_array_equal(g_k, g_t)
    want = _jgrad(lambda x: fsr_tpu.upscale(x, scale=scale, impl="xla"), img)
    _close_rel(g_k[:3], want[:3])
    _close_rel(g_k[3], want[3])
    np.testing.assert_allclose(g_k[3].sum(), scale * scale * 20 * 26, rtol=5e-2)  # weights sum to 1


@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
@pytest.mark.parametrize("square", [False, True], ids=["linear", "squared"])
def test_low_precision_grad_matches_jax_op_by_op(dt, square):
    img = _img(11, (3, 16, 20))
    tdt, jdt = getattr(torch, dt), getattr(jnp, dt)
    want = _jgrad(lambda x: fsr_tpu.upscale(x, scale=2.0, compute_dtype=jdt, impl="xla"), img, jdt,
                  square=square, jit=False)
    _, got = _grad(lambda x: fsr_tpu_torch.upscale(x, scale=2.0, compute_dtype=tdt, impl="torch"), img, tdt,
                   square=square)
    assert np.isfinite(got).all()
    d = np.abs(got - want) / np.abs(want).max()
    stats = (d.max(), np.percentile(d, 99), np.median(d))
    assert all(v <= lim for v, lim in zip(stats, LP_LIMITS[dt])), (stats, LP_LIMITS[dt])
    if dt == "bfloat16" and not square:  # bf16 runs the kernels: the same gradient
        _, g_k = _grad(lambda x: fsr_tpu_torch.upscale(x, scale=2.0, compute_dtype=tdt, impl="kernel"), img, tdt)
        np.testing.assert_array_equal(g_k, got)


def test_bf16_kernel_path_squared_loss():
    img = _img(11, (3, 64, 96), 0.0, 1.0)
    kw = dict(scale=2.0, compute_dtype=torch.bfloat16)
    _, g_k = _grad(lambda x: fsr_tpu_torch.upscale(x, impl="kernel", **kw), img, torch.bfloat16, square=True)
    _, g_t = _grad(lambda x: fsr_tpu_torch.upscale(x, impl="torch", **kw), img, torch.bfloat16, square=True)
    assert np.isfinite(g_k).all()
    d = np.abs(g_k - g_t) / np.abs(g_t).max()
    assert np.percentile(d, 99) <= BF16_SQ_P99 and np.median(d) <= BF16_SQ_MEDIAN


def test_pipeline_grad():
    """A float pipeline differentiates through its one upscale call; a TEPD
    dither's floor gives a zero gradient, as in the JAX package."""
    img = _img(11, (3, 20, 32), 0.1, 2.0)
    grain = _img(12, (3, 40, 64), -0.5, 0.5)
    kw = dict(hdr_srtm=True, hdr_out=True, grain_amount=0.3)
    _, g_k = _grad(lambda x: fsr_tpu_torch.UpscalePipeline((40, 64), impl="kernel", **kw)(
        x, grain=torch.from_numpy(grain)), img)
    _, g_t = _grad(lambda x: fsr_tpu_torch.UpscalePipeline((40, 64), impl="torch", **kw)(
        x, grain=torch.from_numpy(grain)), img)
    np.testing.assert_array_equal(g_k, g_t)
    want = _jgrad(lambda x: fsr_tpu.UpscalePipeline((40, 64), **kw)(x, grain=jnp.asarray(grain)), img)
    _close_rel(g_k, want)
    for dt in (torch.float32, torch.bfloat16):  # the fused dither and the bf16 after-pass
        pipe = fsr_tpu_torch.UpscalePipeline((40, 64), dither_bits=10, compute_dtype=dt, impl="kernel")
        _, g = _grad(lambda x: pipe(x, frame=2), _img(11, (3, 20, 32)), dt)
        assert not np.any(g)


def test_row_sharded_grad_matches_jax():
    """Every strip runs ``api._upscale``, so a row-sharded call
    differentiates, through ``Sharded.gather()``: the port's sharded
    gradient on 4 CPU strips (torch ops and the kernels' plain versions)
    against jax.grad of the JAX sharded call on 4 of the conftest's CPU
    devices."""
    img = _img(11, (3, 64, 96))
    assert len(jax.devices()) >= 4, "conftest should provide 8 CPU devices"
    jmesh = jsharding.make_mesh(4, ("sp",))
    want = _jgrad(lambda x: jspatial.upscale_spatial_sharded(x, (128, 192), jmesh, axis="sp"), img)
    mesh = sharding.make_mesh(4, ("sp",), devices=[torch.device("cpu")] * 4)
    for impl in ("torch", "kernel"):
        _, got = _grad(lambda x: spatial.upscale_spatial_sharded(x, (128, 192), mesh, impl=impl).gather(), img)
        _close_rel(got, want)


# --- the trainer -----------------------------------------------------------------

EXAMPLE = Path(__file__).resolve().parent.parent / "examples_torch" / "train_through_fsr.py"


@pytest.mark.parametrize("mode,extra", [("inverse", []), ("prefilter", ["--lr", "1e-4"])], ids=["inverse", "prefilter"])
def test_train_through_fsr_example(mode, extra):
    """Five Adam steps at 16 -> 32 rows beat the baseline (the JAX
    example's exit rule).  The prefilter takes lr 1e-4: at its default 1e-3
    the first steps overshoot the identity kernel and the loss rises for
    more than five steps, in the JAX example too."""
    res = subprocess.run([sys.executable, str(EXAMPLE), mode, "--cpu", "--steps", "5", "--size", "16", *extra],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "MSE" in res.stdout


# --- the trainer's Adam steps against the JAX example's ----------------------------

JAX_EXAMPLE = Path(__file__).resolve().parent.parent / "examples" / "train_through_fsr.py"
INVERSE_LR = 3e-3  # both examples' inverse default


def _jax_example():
    """examples/train_through_fsr.py, loaded by path (examples/ is no package)."""
    spec = importlib.util.spec_from_file_location("jax_train_through_fsr", JAX_EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_adam_update_matches_jax_adam_step():
    """``torch.optim.Adam`` then ``clamp_`` (``Inverse.step``) against the
    JAX example's own ``adam_step`` then ``jnp.clip``, fed the same five
    gradients: magnitudes from 1e-12 to 1e-2 (below, at and far above
    Adam's eps of 1e-8) and exact zeros.  The two place eps and the bias
    corrections in the same algebra and round in other orders, so each step
    may move a parameter in [0, 1] by one float32 ulp of 1.0 more or less:
    after step t the parameters agree within t * 2**-23 (measured at most
    3 * 2**-24 after five steps).  Neither where eps sits nor how the step
    count enters differs."""
    jex = _jax_example()
    rng = np.random.default_rng(5)
    p0 = rng.uniform(0, 1, (3, 16, 32)).astype(np.float32)
    p = torch.from_numpy(p0.copy()).requires_grad_()
    opt = torch.optim.Adam([p], lr=INVERSE_LR)
    jp, m, v = jnp.asarray(p0), jnp.zeros(p0.shape, jnp.float32), jnp.zeros(p0.shape, jnp.float32)
    for t in range(1, 6):
        g = (rng.standard_normal(p0.shape) * 10.0 ** rng.uniform(-12, -2, p0.shape)).astype(np.float32)
        g[0, 0, :8] = 0.0
        p.grad = torch.from_numpy(g)
        opt.step()
        with torch.no_grad():
            p.clamp_(0.0, 1.0)
        upd, m, v = jex.adam_step(jnp.asarray(g), m, v, jnp.float32(t), INVERSE_LR)
        jp = jnp.clip(jp - upd, 0.0, 1.0)
        d = np.abs(p.detach().numpy() - np.asarray(jp)).max()
        assert d <= t * 2.0 ** -23, f"step {t}: parameters {d:.3e} apart"


@pytest.mark.parametrize("size,steps", [(16, 5), (96, 2)], ids=["size16", "size96"])
def test_inverse_steps_match_jax(size, steps):
    """The inverse problem's displayed MSE, step by step, through the port's
    ``Inverse.step`` as the example calls it (through
    ``capture.CapturedStep``, which on the CPU calls it eagerly; on a card
    it replays the captured step, bit-equal to it, ``chip_smoke.py`` phase
    20) and through a JAX loop built from the JAX example's own
    ``make_scene``, ``downsample``, ``adam_step`` and ``jnp.clip`` (its
    ``run_inverse`` prints only every 50th step), both from ``make_scene``
    with seed 0, lr 3e-3, at ``--size`` 16 (16 -> 32 rows; the example test's
    size) and at the example's default 96.

    Limits, relative to JAX's MSE: before the first step (the two forwards,
    within f32 rounding) 1e-5, measured at most 2.1e-6; after one step from
    the same render, 1e-4, measured at most 1.7e-5: the gradients agree
    within 1e-5 of max|g| (``test_grad_easu_rcas_matches_jax``) and the
    optimizers within an ulp (``test_adam_update_matches_jax_adam_step``);
    after later steps 5e-3, measured at most 1.2e-3: Adam divides each
    texel's moment by its own root mean square, so a texel whose gradient
    is near zero, where the two gradients' 1e-5 of max|g| is most of it,
    takes a step of a different size or sign, and the renders drift apart.

    The first step raises the displayed MSE at size 96 in JAX, and in the
    port alike (measured +0.58%): Adam's first update is lr * g / (|g| +
    eps), a full 3e-3 step at almost every texel whatever its gradient, and
    almost every texel's gradient is under a thousandth of the largest.
    That is the reference's behaviour (PERF.md section 7), which the test
    pins; at size 16 the first step lowers it in both."""
    import fsr_tpu

    from examples_torch import train_through_fsr as ttrain

    jex = _jax_example()
    hi_np = jex.make_scene(np.random.default_rng(0), (2 * size, 4 * size))
    np.testing.assert_array_equal(ttrain.make_scene(np.random.default_rng(0), (2 * size, 4 * size)), hi_np)
    hi = jnp.asarray(hi_np)

    def loss_fn(lo):
        return jnp.mean((fsr_tpu.upscale(lo, scale=2.0) - hi) ** 2)

    @jax.jit
    def step(lo, m, v, t):
        loss, g = jax.value_and_grad(loss_fn)(lo)
        upd, m, v = jex.adam_step(g, m, v, t, INVERSE_LR)
        return jnp.clip(lo - upd, 0.0, 1.0), m, v, loss

    lo = jnp.asarray(jex.downsample(hi_np))
    m, v = jnp.zeros_like(lo), jnp.zeros_like(lo)
    want = []
    for i in range(steps):
        lo, m, v, loss = step(lo, m, v, jnp.float32(i + 1))
        want.append(float(loss))
    want.append(float(jax.jit(loss_fn)(lo)))

    prob = ttrain.Inverse(torch.from_numpy(hi_np), INVERSE_LR)
    step = capture.CapturedStep(prob.step, prob.params, prob.opt)  # on the CPU: the eager step
    got = [float(step()) for _ in range(steps)] + [prob.loss()]
    rel = [abs(a - b) / b for a, b in zip(got, want)]
    print(f"size {size}: JAX MSE {want}, port {got}, relative {rel}")
    limits = [1e-5, 1e-4] + [5e-3] * (steps - 1)
    for i, (r, lim) in enumerate(zip(rel, limits)):
        assert r <= lim, f"displayed MSE after {i} steps: {got[i]:.6e} vs JAX {want[i]:.6e} ({r:.2e} > {lim:g})"
    assert (got[1] > got[0]) == (want[1] > want[0])
    if size == 96:
        assert want[1] > want[0], "the JAX reference's first step no longer raises the displayed MSE"


PREFILTER_LR = 1e-3  # both examples' prefilter default


def test_prefilter_steps_match_jax():
    """The prefilter's loss, step by step, through the port's
    ``Prefilter.step`` as the example calls it (``capture.CapturedStep``,
    eager on the CPU) and through a JAX loop built from the JAX example's
    own ``make_scene``, ``downsample``, ``gaussian_blur``, ``conv_apply``
    and ``adam_step`` and its ``run_prefilter``'s loss (a vmapped
    ``conv_apply``, ``jnp.clip``, ``fsr_tpu.upscale`` at scale 2, the mean
    squared error; its ``loss_fn`` and ``step`` are local to
    ``run_prefilter``, and it prints only every 50th step): four scenes
    from seed 0 with noise 0.02, an identity 5x5 kernel, lr 1e-3, at
    ``--size`` 16 for 5 steps.

    Limits, relative to JAX's loss, those of
    ``test_inverse_steps_match_jax``: before the first step 1e-5 (the two
    forwards, within f32 rounding); after one step 1e-4 (the gradients
    within 1e-5 of max|g|, the optimizers within an ulp); after later steps
    5e-3 (Adam's per-parameter normalisation lets a parameter with a
    near-zero gradient take a step of another size).  Measured at most
    6.4e-7, 3.4e-6 and 5.4e-6."""
    import fsr_tpu

    from examples_torch import train_through_fsr as ttrain

    size, steps = 16, 5
    jex = _jax_example()
    rng = np.random.default_rng(0)
    frames_hi = [jex.make_scene(rng, (2 * size, 4 * size), noise=0.02) for _ in range(4)]
    lo_np = np.stack([jex.gaussian_blur(jex.downsample(f)) for f in frames_hi])
    hi_np = np.stack(frames_hi)
    for got, want in zip(ttrain.prefilter_scenes(np.random.default_rng(0), size), (lo_np, hi_np)):
        np.testing.assert_array_equal(got, want)
    lo, hi = jnp.asarray(lo_np), jnp.asarray(hi_np)

    def loss_fn(params):
        filt = jax.vmap(lambda f: jex.conv_apply(params, f))(lo)
        shown = fsr_tpu.upscale(jnp.clip(filt, 0.0, 1.0), scale=2.0)
        return jnp.mean((shown - hi) ** 2)

    @jax.jit
    def step(params, m, v, t):
        loss, g = jax.value_and_grad(loss_fn)(params)
        upd, m, v = jex.adam_step(g, m, v, t, PREFILTER_LR)
        return jax.tree.map(lambda p, u: p - u, params, upd), m, v, loss

    k0 = np.zeros((3, 3, 5, 5), np.float32)
    for c in range(3):
        k0[c, c, 2, 2] = 1.0
    params = [(jnp.asarray(k0), jnp.zeros((3,), jnp.float32))]
    m = jax.tree.map(jnp.zeros_like, params)
    v = jax.tree.map(jnp.zeros_like, params)
    want = []
    for i in range(steps):
        params, m, v, loss = step(params, m, v, jnp.float32(i + 1))
        want.append(float(loss))
    want.append(float(jax.jit(loss_fn)(params)))

    prob = ttrain.Prefilter(torch.from_numpy(lo_np), torch.from_numpy(hi_np), PREFILTER_LR)
    np.testing.assert_array_equal(prob.k.detach().numpy(), k0)
    tstep = capture.CapturedStep(prob.step, prob.params, prob.opt)
    got = [float(tstep()) for _ in range(steps)] + [prob.loss()]
    rel = [abs(a - b) / b for a, b in zip(got, want)]
    print(f"prefilter: JAX loss {want}, port {got}, relative {rel}")
    limits = [1e-5, 1e-4] + [5e-3] * (steps - 1)
    for i, (r, lim) in enumerate(zip(rel, limits)):
        assert r <= lim, f"loss after {i} steps: {got[i]:.6e} vs JAX {want[i]:.6e} ({r:.2e} > {lim:g})"
