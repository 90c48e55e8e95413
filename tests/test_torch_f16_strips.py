"""float16 row strips and ``impl="auto"``'s fallback, on the CPU.

- ``impl="auto"`` on a card (the device check ``api._on_card`` made to see
  one): a configuration no kernel takes (a float32 or float16 downscale)
  runs the torch path, against ``fsr_tpu.upscale`` (float32 within 2e-6 as
  tests/test_torch_api.py; float16 within docs/FIDELITY.md's f16 mixed
  row), where the port raised; ``impl="kernel"`` still raises.  A row
  strip follows the same rule (``dispatch.supported(strip=)``).
- K6's strip form: its plain version (``easu_h_reference(row_plan=)``) on
  each strip, read from a ``StripSource``, bit-equal to the torch path's
  float16 strips and to the unsharded ``easu_h_reference``: RGB and RGBA,
  2x and 1.5x, 2 and 4 strips, RCAS on, off and denoise, every source type;
  the sharded call against ``fsr_tpu.parallel.upscale_spatial_sharded(
  compute_dtype=float16)`` on the conftest's virtual CPU devices within the
  f16 mixed row.
- K1's and K2's strip forms on a float16 source: their plain versions
  bit-equal to the whole frame's, under float32 and bfloat16 math.
- The gradient of a float16 strip under ``impl="kernel"``
  (``kernel_with_torch_vjp`` over the plain versions) bit-equal to the
  torch path's; ``CapturedSpatial`` of a float16 call (eager here) bit-equal
  to the eager call.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fsr_tpu
import fsr_tpu_torch
from fsr_tpu.parallel import sharding as jsharding
from fsr_tpu.parallel import spatial as jspatial

from fsr_tpu_torch import api
from fsr_tpu_torch.core.constants import RcasConstants
from fsr_tpu_torch.kernels import dispatch, halo
from fsr_tpu_torch.kernels import easu_h as teasu_h
from fsr_tpu_torch.parallel import sharding, spatial

CPU = torch.device("cpu")
F16 = torch.float16
F32_TOL = 2e-6
# docs/FIDELITY.md, f16 "mixed" row.
F16_MIXED = dict(median=1.0 / 2040.0, p99=5.0 / 255.0, share=0.04)
GEOMS = {"2x": ((32, 48), (64, 96)), "1.5x": ((48, 64), (72, 96))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops per strip: one intra-op thread beside the other
    pytest workers (as tests/test_torch_parallel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _mesh(n):
    return sharding.make_mesh(n, ("sp",), None, devices=[CPU] * n)


def _source(kind, shape, seed=21):
    x = torch.from_numpy(_rand(seed, shape))
    return (x * 255).to(torch.uint8) if kind == "uint8" else x.to(getattr(torch, kind))


def _bits_equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == F16:
        got, want = got.view(torch.int16), want.view(torch.int16)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def _f16_row(got: np.ndarray, want: np.ndarray):
    d = np.abs(got.astype(np.float32) - want.astype(np.float32))
    assert np.isfinite(got).all()
    assert np.median(d) <= F16_MIXED["median"]
    assert np.percentile(d, 99) <= F16_MIXED["p99"]
    assert (d > 1.0 / 255.0).mean() <= F16_MIXED["share"]


# --- fault 21: impl="auto" on a card falls back where no kernel takes it ----


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_auto_on_a_card_runs_the_torch_path_on_a_downscale(monkeypatch, dtype):
    """As fsr_tpu/api.py:178-189: "auto" takes the kernel only where
    ``dispatch.supported`` holds, else the torch path's image."""
    monkeypatch.setattr(api, "_on_card", lambda image: True)
    img = _rand(6, (3, 27, 48))
    dt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = fsr_tpu_torch.upscale(torch.from_numpy(img).to(dt), out_size=(20, 40), compute_dtype=dt)
    want = np.asarray(fsr_tpu.upscale(jnp.asarray(img).astype(jdt), out_size=(20, 40), compute_dtype=jdt))
    assert tuple(got.shape) == (3, 20, 40) and got.dtype == dt
    torch.testing.assert_close(got, fsr_tpu_torch.upscale(torch.from_numpy(img).to(dt), out_size=(20, 40),
                                                          compute_dtype=dt, impl="torch"), atol=0, rtol=0)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)
    else:
        _f16_row(got.float().numpy(), want)
    with pytest.raises(NotImplementedError, match="impl='torch'"):
        fsr_tpu_torch.upscale(torch.from_numpy(img).to(dt), out_size=(20, 40), compute_dtype=dt, impl="kernel")


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_auto_on_a_card_takes_the_kernel_where_supported(monkeypatch, dtype):
    """On a card "auto" still reaches the kernel path for an upscale (here
    its plain versions), once per call."""
    monkeypatch.setattr(api, "_on_card", lambda image: True)
    calls = []
    real = dispatch.upscale_fused
    monkeypatch.setattr(dispatch, "upscale_fused", lambda *a, **k: calls.append(1) or real(*a, **k))
    dt = getattr(torch, dtype)
    x = torch.from_numpy(_rand(7, (3, 27, 48))).to(dt)
    got = fsr_tpu_torch.upscale(x, preset="performance", compute_dtype=dt)
    assert len(calls) == 1
    _bits_equal(got, fsr_tpu_torch.upscale(x, preset="performance", compute_dtype=dt, impl="kernel"))


@pytest.mark.parametrize("compute", ["float16", "float32"])
def test_auto_on_a_card_routes_each_strip_by_its_kernel_form(monkeypatch, compute):
    """Row strips under "auto" on a card: each strip reaches its kernel's
    strip form where it takes the strip's plan; where it does not
    (``dispatch.supported`` False), the torch path, and "kernel" raises."""
    monkeypatch.setattr(api, "_on_card", lambda image: True)
    calls = []
    real = dispatch.upscale_fused
    monkeypatch.setattr(dispatch, "upscale_fused", lambda *a, **k: calls.append(k["strip"]) or real(*a, **k))
    dt = getattr(torch, compute)
    x = torch.from_numpy(_rand(8, (2, 3, 48, 64))).half()
    out_hw = GEOMS["1.5x"][1]
    got = spatial.upscale_spatial_sharded(x, out_hw, _mesh(4), compute_dtype=dt).gather()
    assert [s.row0 for s in calls] == [0, 18, 36, 54]
    _bits_equal(got, fsr_tpu_torch.upscale(x, out_size=out_hw, compute_dtype=dt, impl="kernel"))
    calls.clear()
    monkeypatch.setattr(dispatch, "supported", lambda *a, **k: False)
    got = spatial.upscale_spatial_sharded(x, out_hw, _mesh(4), compute_dtype=dt).gather()
    assert calls == []
    _bits_equal(got, spatial.upscale_spatial_sharded(x, out_hw, _mesh(4), compute_dtype=dt, impl="torch").gather())
    with pytest.raises(NotImplementedError, match="row strip"):
        spatial.upscale_spatial_sharded(x, out_hw, _mesh(4), compute_dtype=dt, impl="kernel")


# --- K6's strip form --------------------------------------------------------

MODES = {"rcas": (True, False), "off": (False, False), "denoise": (True, True)}
STRIPS = [(ratio, nc, n, mode) for ratio in GEOMS for nc in (3, 4) for n in (2, 4) for mode in MODES]


def _strip_sources(x, n, halo_rows):
    return spatial._sources(list(x.split(x.shape[-2] // n, dim=-2)), halo_rows)


@pytest.mark.parametrize("ratio,nc,n,mode", STRIPS)
def test_k6_strip_plain_version_is_the_torch_strips_and_the_whole_frame(ratio, nc, n, mode):
    (in_hw, out_hw), (rc, dn) = GEOMS[ratio], MODES[mode]
    x = _source("float16", (2, nc, *in_hw), seed=30 + n)
    layout = spatial._layout(in_hw, out_hw, n, None, (0, 0))
    rcon = RcasConstants(0.5 if dn else 0.25)
    strips = [teasu_h.easu_h(s, layout.out_hw, layout.con, rcon, rc, dn, row_plan=st.rows)
              for s, st in zip(_strip_sources(x, n, layout.halo), layout.strips)]
    got = torch.cat(strips, dim=-2)
    kw = dict(compute_dtype=F16, apply_rcas=rc, denoise=dn, sharpness=0.5 if dn else 0.25)
    _bits_equal(got, spatial.upscale_spatial_sharded(x, out_hw, _mesh(n), impl="torch", **kw).gather())
    _bits_equal(got, teasu_h.easu_h_reference(x, out_hw, layout.con, rcon, rc, dn))
    _bits_equal(got, spatial.upscale_spatial_sharded(x, out_hw, _mesh(n), impl="kernel", **kw).gather())


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "uint8"])
@pytest.mark.parametrize("nc", [3, 4])
def test_k6_strips_from_every_source_type(kind, nc):
    in_hw, out_hw = GEOMS["2x"]
    x = _source(kind, (2, nc, *in_hw), seed=40)
    got = spatial.upscale_spatial_sharded(x, out_hw, _mesh(4), compute_dtype=F16, impl="kernel").gather()
    layout = spatial._layout(in_hw, out_hw, 4, None, (0, 0))
    _bits_equal(got, teasu_h.easu_h_reference(x, out_hw, layout.con, RcasConstants(0.25)))


def test_k6_strip_with_options_and_drs_equals_the_torch_path():
    """With the prologue, an epilogue (grain at the strip's rows, the dither
    at its global rows) and a byte output, K6's strip form runs them inside
    its call, equal to the torch path's strips; a DRS viewport's strips
    likewise."""
    from fsr_tpu_torch.kernels.epilogue import Epilogue

    in_hw, out_hw = GEOMS["1.5x"]
    x = _source("float16", (2, 4, *in_hw), seed=41)
    grain = torch.from_numpy(_rand(42, (3, *out_hw))) - 0.5
    for kw in (dict(prologue="srtm", epilogue=Epilogue(transform="srtm_inv", grain_amount=0.3), grain=grain),
               dict(epilogue=Epilogue(grain_amount=0.25, dither_bits=8), out_dtype=torch.uint8, grain=grain,
                    frame=3),
               dict(input_viewport=(44, 60), input_offset=(2, 3))):
        args = (x, out_hw, _mesh(3 if "input_viewport" in kw else 4))
        got = spatial.upscale_spatial_sharded(*args, compute_dtype=F16, impl="kernel", **kw).gather()
        _bits_equal(got, spatial.upscale_spatial_sharded(*args, compute_dtype=F16, impl="torch", **kw).gather())


def test_k6_strip_refuses_a_plan_that_does_not_fit_its_source():
    in_hw, out_hw = GEOMS["2x"]
    layout = spatial._layout(in_hw, out_hw, 4, None, (0, 0))
    x = _source("float16", (3, in_hw[0] // 4, in_hw[1]))  # no halo rows: the taps reach past it
    with pytest.raises(ValueError, match="plan and footprint fit"):
        teasu_h.easu_h(x, layout.out_hw, layout.con, RcasConstants(0.25), row_plan=layout.strips[1].rows)
    assert not dispatch.supported(x, layout.out_hw, layout.con, F16, strip=layout.strips[1])


JAX_STRIPS = [("2x", 3, 2), ("2x", 4, 4), ("1.5x", 3, 4), ("1.5x", 4, 2)]


@pytest.mark.parametrize("ratio,nc,n", JAX_STRIPS)
def test_f16_strips_match_jax_sharded(ratio, nc, n):
    in_hw, out_hw = GEOMS[ratio]
    img = _rand(50 + n, (2, nc, *in_hw))
    x = torch.from_numpy(img).half()
    got = spatial.upscale_spatial_sharded(x, out_hw, _mesh(n), compute_dtype=F16, impl="kernel").gather()
    jmesh = jsharding.make_mesh(n, ("sp",))
    want = np.asarray(jspatial.upscale_spatial_sharded(jnp.asarray(img).astype(jnp.float16), out_hw, jmesh,
                                                       axis="sp", compute_dtype=jnp.float16))
    assert got.shape == want.shape and want.dtype == np.float16
    _f16_row(got.float().numpy(), want)


# --- K1 and K2 on a float16 source -----------------------------------------


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("ratio,nc,n", [("2x", 3, 4), ("2x", 4, 2), ("1.5x", 3, 2), ("1.5x", 4, 4)])
def test_k1_k2_strips_on_a_float16_source_equal_the_whole_frame(compute, ratio, nc, n):
    in_hw, out_hw = GEOMS[ratio]
    dt = getattr(torch, compute)
    x = _source("float16", (2, nc, *in_hw), seed=60 + n)
    layout = spatial._layout(in_hw, out_hw, n, None, (0, 0))
    assert (layout.strips[0].local_con is not None) == (ratio == "2x")  # K1 at 2x, K2 at 1.5x
    got = spatial.upscale_spatial_sharded(x, out_hw, _mesh(n), compute_dtype=dt, impl="kernel").gather()
    want = fsr_tpu_torch.upscale(x, out_size=out_hw, compute_dtype=dt, impl="kernel")
    _bits_equal(got, want)
    # each strip read from its parts, and from its halo'd rows as one tensor
    for k, (s, st) in enumerate(zip(_strip_sources(x, n, layout.halo), layout.strips)):
        kw = dict(apply_rcas=True, denoise=False, compute_dtype=dt, strip=st)
        rows = dispatch.upscale_fused(s, layout.out_hw, layout.con, RcasConstants(0.25), **kw)
        _bits_equal(rows, dispatch.upscale_fused(halo.halo_rows_reference(s), layout.out_hw, layout.con,
                                                 RcasConstants(0.25), **kw))
        _bits_equal(rows, want[..., k * layout.out_hw[0]:(k + 1) * layout.out_hw[0], :])


# --- gradients and capture ---------------------------------------------------


@pytest.mark.parametrize("compute", ["float16", "float32"])
def test_f16_strip_gradient_under_kernel_is_the_torch_paths(compute):
    in_hw, out_hw = GEOMS["1.5x"]
    dt = getattr(torch, compute)
    base = torch.from_numpy(_rand(70, (3, *in_hw)))

    def grad(impl):
        # float16 math from a float32 image; a float16 image under float32 math
        v = (base.clone() if dt == F16 else base.half()).requires_grad_()
        out = spatial.upscale_spatial_sharded(v, out_hw, _mesh(4), compute_dtype=dt, impl=impl).gather()
        out.float().sum().backward()
        return v.grad

    got = grad("kernel")
    assert torch.isfinite(got.float()).all() and got.abs().max() > 0
    _bits_equal(got, grad("torch"))


def test_captured_f16_call_equals_the_eager_call():
    in_hw, out_hw = GEOMS["2x"]
    x = _source("float16", (2, 3, *in_hw), seed=80)
    cap = spatial.CapturedSpatial(x, out_hw, _mesh(4), compute_dtype=F16)
    for seed in (81, 82):
        y = _source("float16", (2, 3, *in_hw), seed=seed)
        _bits_equal(cap(y, 0).gather(),
                    spatial.upscale_spatial_sharded(y, out_hw, _mesh(4), compute_dtype=F16).gather())
