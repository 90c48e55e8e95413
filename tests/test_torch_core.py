"""Port host code (constants, presets, coordinate tables, phase structure,
the numpy oracle copy) against the JAX package: all bit-equal."""

import dataclasses

import numpy as np
import pytest

from fsr_tpu.core import constants as jconst
from fsr_tpu.core import presets as jpresets
from fsr_tpu.kernels import fused as jfused
from fsr_tpu.ops import easu as jeasu
from fsr_tpu.reference import scalar as jref

import fsr_tpu_torch
from fsr_tpu_torch.core import constants as tconst
from fsr_tpu_torch.core import presets as tpresets
from fsr_tpu_torch.kernels import fused as tfused
from fsr_tpu_torch.ops import easu as teasu
from fsr_tpu_torch.reference import scalar as tref

# (viewport (w, h), container (w, h) or None, output (w, h), DRS offset (x, y))
CONFIGS = [
    ((960, 540), None, (1920, 1080), (0, 0)),     # 540p -> 1080p
    ((1920, 1080), None, (3840, 2160), (0, 0)),   # 1080p -> 4K
    ((480, 270), None, (1920, 1080), (0, 0)),     # 4x
    ((1280, 720), None, (1920, 1080), (0, 0)),    # 1.5x (quality)
    ((1600, 900), (1920, 1080), (3200, 1800), (160, 90)),  # DRS offset
]


def _pair(cfg):
    return jconst.EasuConstants.create(*cfg), tconst.EasuConstants.create(*cfg)


@pytest.mark.parametrize("cfg", CONFIGS)
def test_easu_constants_bit_equal(cfg):
    j, t = _pair(cfg)
    np.testing.assert_array_equal(t.as_uint4(), j.as_uint4())
    for attr in ("scale", "offset", "inv_size"):
        got = np.asarray(getattr(t, attr), np.float32).view(np.uint32)
        want = np.asarray(getattr(j, attr), np.float32).view(np.uint32)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stops", [0.0, 0.25, 1.0, 2.5])
def test_rcas_constants_bit_equal(stops):
    j, t = jconst.RcasConstants(stops), tconst.RcasConstants(stops)
    np.testing.assert_array_equal(t.as_uint4(), j.as_uint4())
    assert t.sharpness.view(np.uint32) == j.sharpness.view(np.uint32)
    assert tconst.FSR_RCAS_LIMIT == jconst.FSR_RCAS_LIMIT


@pytest.mark.parametrize("cfg", CONFIGS)
def test_constants_from_jax_round_trip(cfg):
    j, _ = _pair(cfg)
    jr = jconst.RcasConstants(0.75)
    con, rcon = fsr_tpu_torch.constants_from_jax(dataclasses.asdict(j), dataclasses.asdict(jr))
    assert isinstance(con, tconst.EasuConstants) and isinstance(rcon, tconst.RcasConstants)
    assert dataclasses.asdict(con) == dataclasses.asdict(j)
    assert dataclasses.asdict(rcon) == dataclasses.asdict(jr)
    np.testing.assert_array_equal(con.as_uint4(), j.as_uint4())
    np.testing.assert_array_equal(rcon.as_uint4(), jr.as_uint4())


@pytest.mark.parametrize("cfg", CONFIGS)
def test_easu_coords_bit_equal(cfg):
    j, t = _pair(cfg)
    out_hw = (cfg[2][1], cfg[2][0])
    for got, want in zip(teasu.easu_coords(t, out_hw), jeasu.easu_coords(j, out_hw)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cfg", CONFIGS + [((131, 67), None, (262, 134), (0, 0)),
                                           ((128, 64), None, (128, 128), (0, 0))])
def test_phase_structure_equal(cfg):
    j, t = _pair(cfg)
    out_hw = (cfg[2][1], cfg[2][0])
    got = tfused._phase_structure(t, out_hw)
    want = jfused._phase_structure(j, out_hw)
    if want is not None:
        want = tuple(tuple(v) if isinstance(v, list) else v for v in want)
    assert got == want
    if got is not None:
        # The kernel plan's padded source covers every tap of every pixel.
        in_hw = (cfg[1] or cfg[0])[::-1]
        plan = tfused.plan(in_hw, out_hw, t)
        pt, pb, pl, pr = plan.pads
        hp, wp = in_hw[0] + pt + pb, in_hw[1] + pl + pr
        rows = np.arange(out_hw[0]) // plan.qy + np.asarray(plan.ry)[np.arange(out_hw[0]) % plan.qy]
        cols = np.arange(out_hw[1]) // plan.qx + np.asarray(plan.rx)[np.arange(out_hw[1]) % plan.qx]
        assert rows.min() - 1 >= 0 and rows.max() + 2 < hp
        assert cols.min() - 1 >= 0 and cols.max() + 2 < wp


def test_presets_equal():
    assert {k: dataclasses.asdict(v) for k, v in tpresets.PRESETS.items()} == {
        k: dataclasses.asdict(v) for k, v in jpresets.PRESETS.items()
    }
    for display in [(2160, 3840), (1080, 1920), (1441, 2561)]:
        for p in tpresets.PRESETS.values():
            assert tpresets.render_resolution(display, p.scale) == jpresets.render_resolution(display, p.scale)
            assert tpresets.recommended_mip_bias(p.scale) == jpresets.recommended_mip_bias(p.scale)


def test_oracle_copy_bit_equal():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (3, 27, 40)).astype(np.float32)
    for cfg in [((40, 27), None, (80, 54), (0, 0)), ((40, 27), None, (60, 41), (0, 0))]:
        j, t = _pair(cfg)
        out_hw = (cfg[2][1], cfg[2][0])
        np.testing.assert_array_equal(tref.easu_ref(img, out_hw, t), jref.easu_ref(img, out_hw, j))
        np.testing.assert_array_equal(tref.bilinear_ref(img, out_hw, t), jref.bilinear_ref(img, out_hw, j))
    rgba = rng.uniform(0, 1, (4, 19, 23)).astype(np.float32)
    for denoise in (False, True):
        for stops in (0.0, 0.25):
            np.testing.assert_array_equal(
                tref.rcas_ref(rgba, tconst.RcasConstants(stops), denoise=denoise),
                jref.rcas_ref(rgba, jconst.RcasConstants(stops), denoise=denoise),
            )
    x = np.concatenate([rng.uniform(0, 4, 256), [0.0, 1e-40, 1e30]]).astype(np.float32)
    for name in ("prx_lo_rcp_f32", "prx_med_rcp_f32", "prx_lo_rsq_f32", "prx_lo_sqrt_f32"):
        with np.errstate(over="ignore", invalid="ignore"):
            got = getattr(tref, name)(x)
            want = getattr(jref, name)(x)
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_port_imports_no_jax_in_its_sources():
    import pathlib

    root = pathlib.Path(fsr_tpu_torch.__file__).parent
    for p in root.rglob("*.py"):
        text = p.read_text()
        assert "import jax" not in text and "from jax" not in text, p
        assert "import fsr_tpu\n" not in text and "from fsr_tpu." not in text, p
