"""K2 (``fsr_tpu_torch.kernels.easu_gather``) and the kernel dispatch on the
CPU, where K2 runs its plain version, against the JAX package.

Tolerances: against the JAX XLA path (``ops.easu`` then ``ops.rcas``) f32
within 6e-5, the JAX package's fused-vs-XLA bound (the port runs the
kernels' ``fast`` forms, the XLA path the exact ones); against the numpy
oracle 2e-5 (``tests/test_ops_vs_oracle.py``).  Against the JAX gather
kernel in Pallas interpret mode 5e-4, the JAX tests' own bound
(``tests/test_kernels_general.py``: interpret mode's approximate reciprocal
is cruder than the TPU's); bf16 storage there by median and p99, and by
max-abs against the oracle (see ``test_gather_bf16_matches_jax_kernel``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsr_tpu.core.constants import EasuConstants as JEasu
from fsr_tpu.core.constants import RcasConstants as JRcas
from fsr_tpu.kernels import easu_gather as jgather
from fsr_tpu.ops import easu as jeasu
from fsr_tpu.ops import rcas as jrcas
from fsr_tpu.reference import scalar as jref

from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import _build
from fsr_tpu_torch.kernels import dispatch as tdispatch
from fsr_tpu_torch.kernels import easu_gather as tgather
from fsr_tpu_torch.kernels import fused as tfused
from fsr_tpu_torch.kernels import pad as tpad

F32_TOL = 6e-5
ORACLE_TOL = 2e-5
INTERPRET_TOL = 5e-4
BF16_MAX = 2.0 ** -8


def _cons(in_hw, out_hw, viewport=None, offset=(0, 0)):
    vp = viewport or in_hw
    args = ((vp[1], vp[0]), (in_hw[1], in_hw[0]), (out_hw[1], out_hw[0]), (offset[1], offset[0]))
    return JEasu.create(*args), EasuConstants.create(*args)


def _img(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _port(img, out_hw, tc, stops=0.25, apply_rcas=True, denoise=False, dt=torch.float32):
    return tgather.easu_gather_reference(
        torch.from_numpy(img), out_hw, tc, RcasConstants(stops), apply_rcas, denoise, dt)


def _xla(img, out_hw, jc, stops=0.25, apply_rcas=True, denoise=False):
    out = jeasu.easu(jnp.asarray(img), out_hw, jc)
    if apply_rcas:
        out = jrcas.rcas(out, JRcas(stops), denoise=denoise)
    return np.asarray(out)


# The ratios of tests/test_kernels_general.py:34-40.
RATIOS = [
    ((72, 128), (108, 192)),   # 1.5x
    ((64, 114), (108, 192)),   # ~1.7x ragged
    ((84, 148), (108, 192)),   # ~1.3x ragged
    ((54, 96), (108, 192)),    # 2x
    ((100, 300), (130, 390)),  # 1.3x wide
]

# DRS: a viewport inside a larger container, with an offset
# (tests/test_kernels_general.py:52-59).
DRS = dict(in_hw=(96, 160), out_hw=(128, 256), viewport=(64, 120), offset=(8, 16))

PLAN_CASES = RATIOS + [
    ((50, 60), (50, 60)),      # native 1x
    ((54, 96), (108, 193)),    # 2x with an odd output width
    ((5, 7), (20, 28)),        # 4x, tiny
]


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("case", PLAN_CASES + ["drs"], ids=str)
def test_plan_tables_equal_jax_coords(case):
    if case == "drs":
        in_hw, out_hw = DRS["in_hw"], DRS["out_hw"]
        jc, tc = _cons(in_hw, out_hw, DRS["viewport"], DRS["offset"])
    else:
        in_hw, out_hw = case
        jc, tc = _cons(in_hw, out_hw)
    fx, fy, px, py = jeasu.easu_coords(jc, out_hw)
    d = np.arange(-1, 3)[:, None]
    gplan = tgather.plan(in_hw, out_hw, tc)
    # Rows for output rows -1..Hout: the RCAS ring's rows outside the frame
    # repeat its edge rows.
    ring = np.clip(np.arange(-1, out_hw[0] + 1), 0, out_hw[0] - 1)
    np.testing.assert_array_equal(gplan.rows, np.clip(np.asarray(fy)[ring][None, :] + d, 0, in_hw[0] - 1))
    np.testing.assert_array_equal(gplan.cols, np.clip(np.asarray(fx)[None, :] + d, 0, in_hw[1] - 1))
    np.testing.assert_array_equal(_bits(gplan.py), _bits(np.asarray(py)[ring]))
    np.testing.assert_array_equal(_bits(gplan.px), _bits(px))
    assert gplan.rows.dtype == gplan.cols.dtype == np.int32
    assert tgather.plan(in_hw, out_hw, tc) is gplan  # cached per configuration


@pytest.mark.parametrize("apply_rcas", [True, False], ids=["rcas", "easu-only"])
@pytest.mark.parametrize("in_hw,out_hw", RATIOS)
def test_gather_reference_matches_jax_xla(in_hw, out_hw, apply_rcas):
    img = _img(0, (3, *in_hw))
    jc, tc = _cons(in_hw, out_hw)
    got = _port(img, out_hw, tc, apply_rcas=apply_rcas).numpy()
    np.testing.assert_allclose(got, _xla(img, out_hw, jc, apply_rcas=apply_rcas), atol=F32_TOL, rtol=0)


def _bright():
    img = np.zeros((3, 40, 90), np.float32)
    img[:, 20, 45] = 0.5
    return img


XLA_CASES = [
    # name, image, out_hw, constants kwargs, sharpness stops, apply_rcas, denoise
    ("DRS offset", _img(1, (3, *DRS["in_hw"])), DRS["out_hw"],
     dict(viewport=DRS["viewport"], offset=DRS["offset"]), 0.25, True, False),
    ("batched", _img(2, (2, 3, 48, 128)), (72, 192), {}, 0.25, True, False),
    ("denoise batched", _img(3, (2, 3, 48, 128)), (72, 192), {}, 0.5, True, True),
    ("native 1x", _img(4, (3, 50, 60)), (50, 60), {}, 0.25, True, False),
    ("2x odd width", _img(5, (3, 54, 96)), (108, 193), {}, 0.25, True, False),
    ("isolated bright pixel", _bright(), (60, 135), {}, 0.0, True, False),
    ("all-black frame", np.zeros((3, 32, 64), np.float32), (48, 96), {}, 0.25, True, False),
]


@pytest.mark.parametrize("case", XLA_CASES, ids=lambda c: c[0])
def test_gather_reference_cases_match_jax_xla(case):
    _, img, out_hw, kw, stops, apply_rcas, denoise = case
    jc, tc = _cons(img.shape[-2:], out_hw, **kw)
    got = _port(img, out_hw, tc, stops, apply_rcas, denoise).numpy()
    assert got.shape == img.shape[:-2] + out_hw
    assert np.isfinite(got).all()
    want = _xla(img, out_hw, jc, stops, apply_rcas, denoise)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("in_hw,out_hw", [RATIOS[0], RATIOS[2], ((50, 60), (50, 60))])
def test_gather_reference_matches_oracle(in_hw, out_hw):
    img = _img(6, (3, *in_hw))
    jc, tc = _cons(in_hw, out_hw)
    oracle = jref.rcas_ref(jref.easu_ref(img, out_hw, jc), JRcas(0.25))
    np.testing.assert_allclose(_port(img, out_hw, tc).numpy(), oracle, atol=ORACLE_TOL, rtol=0)


# Shared interpret-mode runs of the JAX gather kernel (slow; made once).
INTERPRET_CASES = {
    "1.5x f32": dict(seed=7, in_hw=(72, 128), out_hw=(108, 192), dt="float32", denoise=False, stops=0.25),
    "1.7x denoise": dict(seed=8, in_hw=(64, 114), out_hw=(108, 192), dt="float32", denoise=True, stops=0.5),
    "1.5x bf16": dict(seed=9, in_hw=(64, 512), out_hw=(96, 768), dt="bfloat16", denoise=False, stops=0.25),
}


@pytest.fixture(scope="module")
def jax_gather():
    jgather.INTERPRET = True
    try:
        runs = {}
        for name, c in INTERPRET_CASES.items():
            img = _img(c["seed"], (3, *c["in_hw"]))
            jc, _ = _cons(c["in_hw"], c["out_hw"])
            dt = jnp.dtype(c["dt"])
            out = jgather.easu_gather(
                jnp.asarray(img).astype(dt), c["out_hw"], jc, rcon=JRcas(c["stops"]),
                apply_rcas=True, denoise=c["denoise"], compute_dtype=dt)
            runs[name] = (np.asarray(out.astype(jnp.float32)), out.dtype)
        return runs
    finally:
        jgather.INTERPRET = False


def _port_interpret_case(name):
    c = INTERPRET_CASES[name]
    img = _img(c["seed"], (3, *c["in_hw"]))
    _, tc = _cons(c["in_hw"], c["out_hw"])
    x = torch.from_numpy(img).to(getattr(torch, c["dt"]))
    return tgather.easu_gather(x, c["out_hw"], tc, RcasConstants(c["stops"]), True, c["denoise"],
                               getattr(torch, c["dt"]))


@pytest.mark.parametrize("name", ["1.5x f32", "1.7x denoise"])
def test_gather_f32_matches_jax_kernel(jax_gather, name):
    got = _port_interpret_case(name)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jax_gather[name][0], atol=INTERPRET_TOL, rtol=0)


def test_gather_bf16_matches_jax_kernel(jax_gather):
    """bf16 storage.  The JAX kernel's bf16 path selects the per-texel
    direction responses through bf16 one-hot dots (``sel_cols`` at
    fsr_tpu/kernels/easu_gather.py:990-991), which rounds them to bf16 and
    moves a few pixels by several bf16 ulps; the port keeps them float32.
    So the two agree by median and p99, and the port is held by max-abs to
    the f32 oracle on the bf16-rounded source: one output rounding (2**-9)
    plus the oracle bound, and no further from it than the JAX kernel."""
    got = _port_interpret_case("1.5x bf16")
    want, jdt = jax_gather["1.5x bf16"]
    assert got.dtype == torch.bfloat16 and jdt == jnp.bfloat16
    d = np.abs(got.float().numpy() - want)
    assert np.median(d) <= 1.0 / 1250.0
    assert np.percentile(d, 99) <= 1.25 / 255.0
    c = INTERPRET_CASES["1.5x bf16"]
    src = np.asarray(jnp.asarray(_img(c["seed"], (3, *c["in_hw"]))).astype(jnp.bfloat16).astype(jnp.float32))
    jc, _ = _cons(c["in_hw"], c["out_hw"])
    oracle = jref.rcas_ref(jref.easu_ref(src, c["out_hw"], jc), JRcas(c["stops"]))
    d_port = np.abs(got.float().numpy() - oracle)
    assert d_port.max() <= BF16_MAX / 2 + ORACLE_TOL
    assert d_port.max() <= np.abs(want - oracle).max()


@pytest.mark.parametrize("src_dt", ["float32", "bfloat16"])
def test_gather_bf16_storage_rounds_source_first(src_dt):
    """bf16 storage: the source is rounded to bf16 first, the math is f32,
    one rounding at the end (not the bf16-accumulating ops path)."""
    img = _img(10, (3, 36, 64))
    _, tc = _cons((36, 64), (54, 96))
    x = torch.from_numpy(img).to(getattr(torch, src_dt))
    got = tgather.easu_gather(x, (54, 96), tc, RcasConstants(0.25), True, False, torch.bfloat16)
    want = tgather.easu_gather_reference(
        x.to(torch.bfloat16).float(), (54, 96), tc, RcasConstants(0.25), True, False, torch.float32)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16), atol=0, rtol=0)


ROUTES = [
    # in_hw, out_hw, constants kwargs, the kernel the dispatch picks; outputs
    # at least 16 x 128, where the JAX gates have no TPU tiling minimum.
    ((32, 64), (64, 128), {}, "K1"),           # 2x Performance
    ((16, 32), (64, 128), {}, "K1"),           # 4x
    ((64, 128), (128, 128), {}, "K1"),         # rows 2x, columns 1x
    ((36, 128), (54, 192), {}, "K2"),          # 1.5x Quality
    ((64, 114), (108, 192), {}, "K2"),         # ~1.7x Balanced
    ((84, 148), (108, 192), {}, "K2"),         # ~1.3x Ultra Quality
    ((40, 128), (40, 128), {}, "K2"),          # native 1x
    ((32, 96), (64, 193), {}, "K2"),           # 2x with an odd output width
    ((40, 136), (60, 192), dict(viewport=(36, 128), offset=(2, 4)), "K2"),  # DRS
]


@pytest.mark.parametrize("case", ROUTES, ids=lambda c: f"{c[0]}->{c[1]}")
def test_dispatch_picks_k1_for_integer_ratios_else_k2(monkeypatch, case):
    in_hw, out_hw, kw, want = case
    jc, tc = _cons(in_hw, out_hw, **kw)
    called = []
    monkeypatch.setattr(tfused, "upscale_fused", lambda *a, **k: called.append("K1"))
    monkeypatch.setattr(tgather, "easu_gather", lambda *a, **k: called.append("K2"))
    x = torch.zeros((3, *in_hw))
    assert tdispatch.supported(x, out_hw, tc, torch.float32)
    tdispatch.upscale_fused(x, out_hw, tc, RcasConstants(0.25), True, False, torch.float32)
    assert called == [want]
    # The JAX dispatch draws the same line: its fused kernel first, else the
    # gather kernel (fsr_tpu/kernels/dispatch.py:83-102).
    from fsr_tpu.kernels import fused as jfused

    assert jfused.supported((3, *in_hw), out_hw, jc, jnp.float32) == (want == "K1")


@pytest.mark.parametrize("in_hw,out_hw", [((54, 96), (27, 48)), ((40, 72), (40, 60)), ((40, 72), (30, 72))])
def test_dispatch_raises_on_downscale(in_hw, out_hw):
    x = torch.from_numpy(_img(11, (3, *in_hw)))
    _, tc = _cons(in_hw, out_hw)
    assert not tdispatch.supported(x, out_hw, tc, torch.float32)
    with pytest.raises(NotImplementedError, match="impl='torch'"):
        tdispatch.upscale_fused(x, out_hw, tc, RcasConstants(0.25), True, False, torch.float32)
    with pytest.raises(ValueError):
        tgather.easu_gather(x, out_hw, tc, RcasConstants(0.25), True)


GATE_CASES = [
    # in_hw, out_hw: every upscale at the JAX gate's minimum output or above
    ((720, 1280), (1080, 1920)),
    ((720, 1280), (720, 1280)),
    ((1080, 1920), (720, 1280)),   # downscale: out of the EASU contract
    ((64, 128), (64, 96)),         # downscale in one axis
    ((12, 100), (16, 128)),
]


@pytest.mark.parametrize("in_hw,out_hw", GATE_CASES)
def test_supported_agrees_with_jax_gate(in_hw, out_hw):
    jc, tc = _cons(in_hw, out_hw)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        assert tgather.supported((3, *in_hw), out_hw, tc, tdt) == jgather.supported(
            (3, *in_hw), out_hw, jc, jdt)
    assert not tgather.supported((3, *in_hw), out_hw, tc, torch.float16)
    # RGBA takes the same gate (alpha is resolved in the same launch).
    assert tgather.supported((4, *in_hw), out_hw, tc, torch.float32) == jgather.supported(
        (4, *in_hw), out_hw, jc, jnp.float32)


def test_supported_drops_the_tpu_minimum_output():
    """The JAX gate refuses outputs under 16 x 128 (a TPU tiling limit,
    fsr_tpu/kernels/easu_gather.py:132); the port's gate does not."""
    jc, tc = _cons((10, 40), (15, 60))
    assert not jgather.supported((3, 10, 40), (15, 60), jc, jnp.float32)
    assert tgather.supported((3, 10, 40), (15, 60), tc, torch.float32)


def test_cpu_calls_count_no_launches_and_build_nothing():
    n = (tgather.easu_gather.launches, tfused.upscale_padded.launches, tpad.edge_pad.launches)
    x = torch.from_numpy(_img(12, (2, 3, 20, 36)))
    _, tc = _cons((20, 36), (30, 54))
    out = tdispatch.upscale_fused(x, (30, 54), tc, RcasConstants(0.25), True, False, torch.float32)
    assert out.shape == (2, 3, 30, 54)
    assert (tgather.easu_gather.launches, tfused.upscale_padded.launches, tpad.edge_pad.launches) == n
    assert _build.library.cache_info().currsize == 0


def test_gather_requires_rcon_for_rcas():
    _, tc = _cons((36, 64), (54, 96))
    with pytest.raises(ValueError, match="rcon"):
        tgather.easu_gather(torch.zeros(3, 36, 64), (54, 96), tc, None, apply_rcas=True)
