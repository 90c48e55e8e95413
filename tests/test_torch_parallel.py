"""Batch- and row-sharded execution (``fsr_tpu_torch.parallel``) on the CPU,
on meshes of ``torch.device("cpu")``, against the unsharded port and the
JAX package (``fsr_tpu.parallel`` on the conftest's 8 virtual CPU devices,
its XLA path).  Mirrors tests/test_parallel.py.  Each sharded result is
compared through ``Sharded.gather()``; tests/test_torch_sharded.py holds
the shards themselves against JAX's ``addressable_shards``.

Limits:
- row-sharded against the unsharded port: bit-equal float32, bfloat16,
  float16 and codes (each strip runs the same plain versions or torch ops on
  the same host-exact coordinates).  The one exception is the TEPD dither:
  its ``torch.sqrt`` is not correctly rounded on this CPU and its result
  depends on the vector path, so a strip can sit one dither step from the
  whole frame at a few values (tests/test_torch_epilogue.py); held to at
  most 2e-4 of the values, each within 2.05 steps.  On the card the seams are
  bit-equal (``chip_smoke.py`` phase 18).
- shard row tables against ``build_shard_plans``'s ``rows_xla``/``py_xla``:
  bit-equal host ints and floats.
- against the JAX sharded XLA path, the unsharded port-vs-JAX limits
  (tests/test_torch_api.py, tests/test_torch_pipeline.py,
  tests/test_torch_uint8.py, tests/test_torch_epilogue.py): the torch path
  within 2e-6, the kernels' plain versions (fast forms) within 6e-5, the
  epilogue within 2e-6 (torch path) or 6e-5 (plain versions) abs and 3e-5
  relative, an SRTM^-1 output after the forward tonemap, dithered values
  as above, uint8/uint16 codes one apart at most 1e-3 of the codes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fsr_tpu
import fsr_tpu_torch
from fsr_tpu.core.constants import EasuConstants as JEasu
from fsr_tpu.kernels import easu_gather as jgather
from fsr_tpu.kernels.epilogue import Epilogue as JEpilogue
from fsr_tpu.parallel import sharding as jsharding
from fsr_tpu.parallel import spatial as jspatial

from fsr_tpu_torch.core.constants import EasuConstants
from fsr_tpu_torch.kernels import easu_gather as tgather
from fsr_tpu_torch.kernels import fused as tfused
from fsr_tpu_torch.kernels.epilogue import Epilogue
from fsr_tpu_torch.ops import easu as teasu
from fsr_tpu_torch.ops import extras
from fsr_tpu_torch.parallel import sharding, spatial

CPU = torch.device("cpu")
TORCH_TOL = 2e-6
KERNEL_TOL = 6e-5
ATOL, RTOL = 2e-6, 3e-5
FLIP_SHARE = 2e-4
CODE_SHARE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The strips run many small torch ops, each a fork-join of torch's
    intra-op threads; beside other pytest workers on the same cores those
    threads oversubscribe them and the file runs ten times slower.  One
    thread for this module; restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(seed, shape, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _mesh(n, names=("sp",), shape=None):
    return sharding.make_mesh(n, names, shape, devices=[CPU] * n)


def _check_steps(got, want, bits):
    """Dithered values: at most FLIP_SHARE of them at another step, each
    within 2.05 steps (tests/test_torch_pipeline.py's limits: a sqrt one ulp
    off moves the quantize's lower step, and its choice can then land two
    steps away)."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    step = 1.0 / (255.0 if bits == 8 else 1023.0)
    assert (d > ATOL).mean() <= FLIP_SHARE, f"{(d > ATOL).sum()} of {d.size} values at another step"
    assert d.max() <= 2.05 * step, f"a dithered value {d.max() / step:.2f} steps away"


# --- meshes and batch sharding -------------------------------------------------


def test_make_mesh_layout():
    mesh = _mesh(8, ("dp", "sp"), (2, 4))
    assert mesh.shape == {"dp": 2, "sp": 4} and mesh.size == 8
    assert all(d == CPU for d in mesh.devices.flat)
    assert sharding.axis_devices(mesh, "sp", {"dp": 1}) == [CPU] * 4
    assert _mesh(3).shape == {"sp": 3}
    with pytest.raises(ValueError):
        sharding.make_mesh(4, ("dp", "sp"), (3, 2), devices=[CPU] * 4)
    with pytest.raises(ValueError):
        sharding.make_mesh(5, devices=[CPU] * 4)


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharding.make_mesh()


def test_shard_batch_layout():
    imgs = torch.arange(8 * 3 * 2 * 2, dtype=torch.float32).reshape(8, 3, 2, 2)
    parts = sharding.shard_batch(imgs, _mesh(4, ("batch",)))
    assert parts.spec == ("batch", None, None, None) and parts.shape == (8, 3, 2, 2)
    assert [tuple(p.shape) for p in parts.shards] == [(2, 3, 2, 2)] * 4
    torch.testing.assert_close(parts.gather(), imgs, atol=0, rtol=0)
    with pytest.raises(ValueError):
        sharding.shard_batch(imgs[:6], _mesh(4, ("batch",)))


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_batch_sharded_matches_single(impl):
    imgs = _rand(0, (8, 3, 32, 48))
    got = sharding.upscale_batch_sharded(torch.from_numpy(imgs), _mesh(8, ("batch",)), scale=2.0, impl=impl).gather()
    torch.testing.assert_close(got, fsr_tpu_torch.upscale(torch.from_numpy(imgs), scale=2.0, impl=impl),
                               atol=0, rtol=0)
    want = np.asarray(fsr_tpu.upscale(jnp.asarray(imgs), scale=2.0, impl="xla"))
    np.testing.assert_allclose(got.numpy(), want, atol=TORCH_TOL if impl == "torch" else KERNEL_TOL, rtol=0)


# --- gating and host plans -----------------------------------------------------

GATING = [((hin, win), (hout, wout), n)
          for hin, win in ((64, 96), (60, 96), (62, 96), (66, 96), (96, 144), (32, 48), (90, 130))
          for hout, wout in ((2 * hin, 2 * win), (4 * hin, 4 * win), (hin * 3 // 2, win * 3 // 2),
                             (128, 192), (117, 169), (hin, win))
          for n in (2, 3, 4, 8, 16)]


def test_spatial_shardable_matches_jax():
    got = [spatial.spatial_shardable(i, o, n) for i, o, n in GATING]
    assert got == [jspatial.spatial_shardable(i, o, n) for i, o, n in GATING]
    assert any(got) and not all(got)
    assert [spatial._exact_phase(i, o, n) for i, o, n in GATING] == [jspatial._exact_phase(i, o, n)
                                                                      for i, o, n in GATING]


PLANS = [((96, 144), (144, 216), 4), ((80, 130), (136, 221), 2), ((90, 130), (117, 169), 3),
         ((64, 256), (96, 384), 4), ((64, 96), (128, 192), 4)]


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("in_hw,out_hw,n", PLANS)
def test_shard_rows_equal_build_shard_plans(in_hw, out_hw, n):
    jc = JEasu.create((in_hw[1], in_hw[0]), None, (out_hw[1], out_hw[0]))
    tc = EasuConstants.create((in_hw[1], in_hw[0]), None, (out_hw[1], out_hw[0]))
    _, plan = jgather.build_shard_plans(in_hw, out_hw, jc, n, halo=spatial._GHALO)
    full = tgather.plan(in_hw, out_hw, tc)
    for k in range(n):
        base, py = tgather.shard_rows(in_hw, out_hw, tc, n, k, spatial._GHALO)
        np.testing.assert_array_equal(base, np.asarray(plan["rows_xla"])[k])
        np.testing.assert_array_equal(_bits(py), _bits(np.asarray(plan["py_xla"])[k]))
        gp = tgather.shard_plan(in_hw, out_hw, tc, n, k, spatial._GHALO)
        assert gp is tgather.shard_plan(in_hw, out_hw, tc, n, k, spatial._GHALO)  # cached per strip
        np.testing.assert_array_equal(gp.rows, base[None, :] + np.arange(-1, 3)[:, None])
        assert gp.rows.dtype == np.int32 and gp.cols is full.cols and gp.px is full.px


def test_shard_rows_raise_when_the_halo_cannot_host():
    tc = EasuConstants.create((96, 64), None, (144, 96))
    tgather.shard_rows((64, 96), (96, 144), tc, 16, 3, 2)  # strip 3's taps reach local rows 0..7 of 8
    with pytest.raises(ValueError, match="cannot host"):
        tgather.shard_rows((64, 96), (96, 144), tc, 16, 3, 1)


@pytest.mark.parametrize("in_hw,out_hw", [((64, 96), (128, 192)), ((32, 48), (128, 192)),
                                          ((64, 96), (128, 96))])
def test_local_plan_is_the_global_plan_shifted(in_hw, out_hw):
    """Exact-phase strips: the shard-local constants give the global phase
    fractions exactly and 'f' rows shifted by the halo."""
    tc = EasuConstants.create((in_hw[1], in_hw[0]), None, (out_hw[1], out_hw[0]))
    n, halo = 4, spatial._HALO
    loc = tfused._phase_structure(spatial._local_constants(tc, halo), (out_hw[0] // n, out_hw[1]))
    qy, qx, ry, rx, py, px = tfused._phase_structure(tc, out_hw)
    assert loc == (qy, qx, tuple(r + halo for r in ry), rx, py, px)


def test_ring_rows():
    assert tfused.ring_rows(20) == (0, 19)
    assert tfused.ring_rows(20, 0, 80) == (0, 20)
    assert tfused.ring_rows(20, 20, 80) == (-1, 20)
    assert tfused.ring_rows(20, 60, 80) == (-1, 19)
    with pytest.raises(ValueError):
        tfused.ring_rows(20, 70, 80)


# --- row-sharded == unsharded, in the port ------------------------------------

RATIOS = ([("2x", (64, 96), (128, 192), n) for n in (2, 4, 8)]
          + [("4x", (32, 48), (128, 192), n) for n in (2, 4, 8)]
          + [(name, i, o, n) for name, i, o in (("1.5x", (96, 144), (144, 216)), ("1.3x", (120, 130), (156, 169)),
                                                ("1.7x", (84, 130), (144, 221)))
             for n in (2, 3, 4)])


def _ids(case):
    return f"{case[0]}-n{case[-1]}"


@pytest.mark.parametrize("impl", ["kernel", "torch"])
@pytest.mark.parametrize("case", RATIOS, ids=_ids)
def test_row_sharded_equals_unsharded(case, impl):
    _, in_hw, out_hw, n = case
    if not spatial.spatial_shardable(in_hw, out_hw, n):
        pytest.fail(f"{case} is not shardable")
    x = torch.from_numpy(_rand(1, (2, 3, *in_hw)))
    got = spatial.upscale_spatial_sharded(x, out_hw, _mesh(n), impl=impl).gather()
    torch.testing.assert_close(got, fsr_tpu_torch.upscale(x, out_size=out_hw, impl=impl), atol=0, rtol=0)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_row_sharded_drs_equals_unsharded(n):
    """A DRS viewport and offset inside a larger container (K2 strips)."""
    x = torch.from_numpy(_rand(2, (3, 96, 144)))
    kw = dict(input_viewport=(92, 138), input_offset=(2, 3))
    got = spatial.upscale_spatial_sharded(x, (132, 192), _mesh(n), impl="kernel", **kw).gather()
    want = fsr_tpu_torch.upscale(x, out_size=(132, 192), impl="kernel", **kw)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


U8, U16, BF16, F16 = torch.uint8, torch.uint16, torch.bfloat16, torch.float16
OPTIONS = {
    # name: (source kind, upscale kwargs, dither bits or None)
    "rgba": ("rgba", {}, None),
    "rgba u8->u8": ("rgba u8", dict(out_dtype=U8), None),
    "u8->u8": ("u8", dict(out_dtype=U8), None),
    "f32->u16": ("float", dict(out_dtype=U16), None),
    "bf16": ("float", dict(compute_dtype=BF16), None),
    "f16": ("float", dict(compute_dtype=F16), None),
    "easu only": ("float", dict(apply_rcas=False), None),
    "denoise": ("float", dict(denoise=True, sharpness=0.5), None),
    "srtm + srtm_inv": ("hdr", dict(prologue="srtm", epilogue=Epilogue(transform="srtm_inv")), None),
    "grain + hash dither10": ("float", dict(epilogue=Epilogue(transform="gamma2", grain_amount=0.3,
                                                              dither_bits=10), frame=5), 10),
    "page dither8, u8->u8": ("u8", dict(epilogue=Epilogue(grain_amount=0.25, dither_bits=8, dither_texture=True),
                                        out_dtype=U8), 8),
}
OPTION_GEOMS = {"2x": ((32, 96), (64, 192)), "1.5x": ((64, 96), (96, 144))}


def _source(kind, in_hw, seed=3):
    x = torch.from_numpy(_rand(seed, (2, 4 if kind.startswith("rgba") else 3, *in_hw)))
    if kind == "hdr":
        return x * 8
    return (x * 255).to(U8) if kind.endswith("u8") else x


@pytest.mark.parametrize("geom", sorted(OPTION_GEOMS))
@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_row_sharded_options_equal_unsharded(name, geom):
    kind, kw, bits = OPTIONS[name]
    in_hw, out_hw = OPTION_GEOMS[geom]
    x = _source(kind, in_hw)
    kw = dict(kw, grain=torch.from_numpy(_rand(4, (3, *out_hw), -0.5, 0.5)),
              dither_page=torch.from_numpy(_rand(5, (24, 40))))
    impl = "auto" if F16 in kw.values() else "kernel"
    got = spatial.upscale_spatial_sharded(x, out_hw, _mesh(4), impl=impl, **kw).gather()
    want = fsr_tpu_torch.upscale(x, out_size=out_hw, impl=impl, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    if bits is None:
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    else:
        scale = 255.0 if got.dtype == U8 else 1.0
        _check_steps(got.double().numpy() / scale, want.double().numpy() / scale, bits)


def test_row_sharded_dp_by_sp_equals_unsharded():
    mesh = _mesh(8, ("dp", "sp"), (2, 4))
    x = torch.from_numpy(_rand(6, (4, 3, 32, 64)))
    got = spatial.upscale_spatial_sharded(x, (64, 128), mesh, axis="sp", batch_axis="dp", impl="kernel").gather()
    torch.testing.assert_close(got, fsr_tpu_torch.upscale(x, out_size=(64, 128), impl="kernel"), atol=0, rtol=0)
    with pytest.raises(ValueError, match="does not split"):
        spatial.upscale_spatial_sharded(x[:3], (64, 128), mesh, axis="sp", batch_axis="dp")


def test_row_sharded_raises():
    x = torch.from_numpy(_rand(7, (3, 62, 96)))
    with pytest.raises(ValueError, match="spatial sharding needs"):
        spatial.upscale_spatial_sharded(x, (124, 192), _mesh(4))
    # A gradient flows through the strips (it raised here before autodiff),
    # equals the sharded torch path's, and the unsharded one's up to
    # summation order (tests/test_torch_grad.py holds it against jax.grad).
    def grad(fn):
        v = torch.from_numpy(_rand(7, (3, 64, 96))).requires_grad_()
        fn(v).sum().backward()
        return v.grad

    got = grad(lambda v: spatial.upscale_spatial_sharded(v, (128, 192), _mesh(4), impl="kernel").gather())
    assert torch.isfinite(got).all() and got.abs().max() > 0
    torch.testing.assert_close(got, grad(lambda v: spatial.upscale_spatial_sharded(v, (128, 192), _mesh(4),
                                                                                  impl="torch").gather()),
                               atol=0, rtol=0)
    whole = grad(lambda v: fsr_tpu_torch.upscale(v, out_size=(128, 192), impl="torch"))
    torch.testing.assert_close(got, whole, atol=1e-6 * whole.abs().max().item(), rtol=0)
    y = torch.from_numpy(_rand(7, (3, 64, 96)))
    # float16 strips run the kernels' strip forms (their plain versions here):
    # a float16 image under float32 math K1's, bit-equal to the unsharded
    # call and within float32 rounding of the torch path; float16 math K6's,
    # bit-equal to the torch path.
    got = spatial.upscale_spatial_sharded(y.half(), (128, 192), _mesh(4), impl="kernel").gather()
    torch.testing.assert_close(got, fsr_tpu_torch.upscale(y.half(), out_size=(128, 192), impl="kernel"), atol=0,
                               rtol=0)
    torch.testing.assert_close(got, spatial.upscale_spatial_sharded(y.half(), (128, 192), _mesh(4),
                                                                    impl="torch").gather(), atol=1e-6, rtol=0)
    got = spatial.upscale_spatial_sharded(y.half(), (128, 192), _mesh(4), impl="kernel", compute_dtype=F16)
    torch.testing.assert_close(got.gather(), spatial.upscale_spatial_sharded(
        y.half(), (128, 192), _mesh(4), impl="torch", compute_dtype=F16).gather(), atol=0, rtol=0)
    with pytest.raises(ValueError, match="10-bit"):
        spatial.upscale_spatial_sharded(y.detach(), (128, 192), _mesh(4), out_dtype=U8,
                                        epilogue=Epilogue(dither_bits=10))


def test_kernel_counts_stay_zero_on_cpu():
    """CPU strips run the plain versions: no launch is counted."""
    from fsr_tpu_torch.kernels import pad as tpad

    counts = (tpad.edge_pad.launches, tfused.upscale_padded.launches, tgather.easu_gather.launches)
    for in_hw, out_hw in (((64, 96), (128, 192)), ((64, 96), (96, 144))):
        spatial.upscale_spatial_sharded(torch.from_numpy(_rand(8, (3, *in_hw))), out_hw, _mesh(4), impl="kernel")
    assert (tpad.edge_pad.launches, tfused.upscale_padded.launches, tgather.easu_gather.launches) == counts


DEFAULT_IMPL = [("2x", (64, 96), (128, 192), "float", {}), ("1.5x", (96, 144), (144, 216), "float", {}),
                ("1.7x", (84, 130), (144, 221), "rgba u8", dict(out_dtype=U8)),
                ("DRS", (96, 144), (132, 192), "float", dict(input_viewport=(92, 138), input_offset=(2, 3))),
                ("2x f16", (32, 96), (64, 192), "float", dict(compute_dtype=F16)),
                ("1.5x bf16 srtm", (64, 96), (96, 144), "hdr", dict(compute_dtype=BF16, prologue="srtm"))]


@pytest.mark.parametrize("case", DEFAULT_IMPL, ids=[c[0] for c in DEFAULT_IMPL])
def test_row_sharded_default_impl_equals_upscale(case, monkeypatch):
    """impl="auto" means what it means for ``upscale``: on CPU strips the
    torch path (no kernel wrapper is called), bit-equal to ``upscale`` of
    the whole frame with its default impl."""
    _, in_hw, out_hw, kind, kw = case
    x = _source(kind, in_hw, seed=19)
    want = fsr_tpu_torch.upscale(x, out_size=out_hw, **kw)

    def no_kernel(*args, **kwargs):
        raise AssertionError("a kernel wrapper ran under impl='auto' on CPU strips")

    for mod, name in ((tfused, "upscale_fused"), (tgather, "easu_gather"), (tfused, "upscale_padded")):
        monkeypatch.setattr(mod, name, no_kernel)
    got = spatial.upscale_spatial_sharded(x, out_hw, _mesh(4), **kw).gather()
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_easu_rows_override_is_the_global_plan():
    """ops.easu/bilinear with rows= from the global mapping equal the
    unsharded rows of the whole frame, and JAX's easu(rows=)."""
    in_hw, out_hw = (96, 144), (144, 216)
    img = _rand(9, (3, *in_hw))
    tc = EasuConstants.create((in_hw[1], in_hw[0]), None, (out_hw[1], out_hw[0]))
    _, fy, _, py = teasu.easu_coords(tc, out_hw)
    ring = np.clip(np.arange(-1, out_hw[0] + 1), 0, out_hw[0] - 1)  # output rows -1 .. Hout
    base, py = fy[ring].astype(np.int32), py[ring]
    x = torch.from_numpy(img)
    full = teasu.easu(x, out_hw, tc)
    got = teasu.easu(x, (out_hw[0] + 2, out_hw[1]), tc, rows=(base, py))
    torch.testing.assert_close(got[..., 1:-1, :], full, atol=0, rtol=0)
    torch.testing.assert_close(teasu.bilinear(x, out_hw, tc, rows=(base[1:-1], py[1:-1])),
                               teasu.bilinear(x, out_hw, tc), atol=0, rtol=0)
    jc = JEasu.create((in_hw[1], in_hw[0]), None, (out_hw[1], out_hw[0]))
    from fsr_tpu.ops import easu as jeasu

    want = np.asarray(jeasu.easu(jnp.asarray(img), (out_hw[0] + 2, out_hw[1]), jc,
                                 rows=(jnp.asarray(base), jnp.asarray(py))))
    np.testing.assert_allclose(got.numpy(), want, atol=TORCH_TOL, rtol=0)


def test_epilogue_origin_is_a_slice_of_the_frame():
    from fsr_tpu_torch import api

    x = torch.from_numpy(_rand(10, (3, 128, 192)))
    for epi in (Epilogue(dither_bits=10), Epilogue(dither_bits=8, dither_texture=True)):
        page = torch.from_numpy(_rand(11, (24, 40)))
        full = api._apply_epilogue(x, epi, 3, None, page)
        part = api._apply_epilogue(x[:, 40:96], epi, 3, None, page, origin=(40, 0))
        _check_steps(part.numpy(), full[:, 40:96].numpy(), epi.dither_bits)
    with pytest.raises(ValueError, match="row origin"):
        api._apply_epilogue(x, Epilogue(dither_bits=10), 3, None, origin=(0, 8))


# --- against the JAX package's sharded XLA path --------------------------------


def _jmesh(n, names=("sp",), shape=None):
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    return jsharding.make_mesh(n, names, shape=shape)


# One strip count per ratio (each JAX mesh and configuration compiles anew,
# ~2.5 s): the others equal the port's unsharded output above, which the
# unsharded tests hold to the JAX package.  The JAX function takes no DRS
# viewport, so the DRS case stays port-only.
JAX_RATIOS = [c for c in RATIOS if (c[0], c[-1]) in {("2x", 8), ("4x", 2), ("1.5x", 4), ("1.3x", 3), ("1.7x", 2)}]


@pytest.mark.parametrize("impl", ["kernel", "torch"])
@pytest.mark.parametrize("case", JAX_RATIOS, ids=_ids)
def test_row_sharded_matches_jax_sharded(case, impl):
    _, in_hw, out_hw, n = case
    img = _rand(12, (2, 3, *in_hw))
    want = np.asarray(jspatial.upscale_spatial_sharded(jnp.asarray(img), out_hw, _jmesh(n), axis="sp"))
    got = spatial.upscale_spatial_sharded(torch.from_numpy(img), out_hw, _mesh(n), impl=impl).gather().numpy()
    np.testing.assert_allclose(got, want, atol=TORCH_TOL if impl == "torch" else KERNEL_TOL, rtol=0)


# RGBA, u8 in, u8/u16 out, SRTM, grain with the hash dither and a dither
# page (OPTIONS' names), on the exact-phase (2x) or the general (1.5x)
# regime; each JAX configuration compiles anew, so the list stays short.
JAX_OPTIONS = [("2x", "rgba u8->u8"), ("2x", "srtm + srtm_inv"), ("2x", "grain + hash dither10"),
               ("1.5x", "rgba u8->u8"), ("1.5x", "f32->u16"), ("1.5x", "page dither8, u8->u8")]


def _jax_kw(kw):
    """The port's upscale options under the JAX package's names and types."""
    out = {}
    for k, v in kw.items():
        if k == "epilogue":
            v = JEpilogue(**dataclasses.asdict(v))
        elif k == "out_dtype":
            v = {U8: jnp.uint8, U16: jnp.uint16}[v]
        elif isinstance(v, torch.Tensor):
            v = jnp.asarray(v.numpy())
        out[k] = v
    return out


@pytest.mark.parametrize("geom,name", JAX_OPTIONS)
def test_row_sharded_options_match_jax_sharded(geom, name):
    kind, kw, bits = OPTIONS[name]
    in_hw, out_hw = OPTION_GEOMS[geom]
    x = _source(kind, in_hw)
    kw = dict(kw, grain=torch.from_numpy(_rand(4, (3, *out_hw), -0.5, 0.5)),
              dither_page=torch.from_numpy(_rand(5, (24, 40))))
    got = spatial.upscale_spatial_sharded(x, out_hw, _mesh(4), **kw).gather().numpy()
    want = np.asarray(jspatial.upscale_spatial_sharded(jnp.asarray(x.numpy()), out_hw, _jmesh(4), axis="sp",
                                                       **_jax_kw(kw)))
    assert got.dtype == want.dtype and got.shape == want.shape
    if bits is not None:
        scale = 255.0 if got.dtype == np.uint8 else 1.0
        _check_steps(got / scale, want / scale, bits)
    elif got.dtype in (np.uint8, np.uint16):
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1 and (d != 0).mean() <= CODE_SHARE, f"{(d != 0).sum()} codes off"
    elif "epilogue" in kw:  # SRTM^-1: compared after the forward tonemap, as tests/test_torch_epilogue.py
        got, want = (extras.srtm(torch.from_numpy(np.array(a))).numpy() for a in (got, want))
        np.testing.assert_allclose(got, want, atol=KERNEL_TOL, rtol=RTOL)
    else:
        np.testing.assert_allclose(got, want, atol=KERNEL_TOL, rtol=0)


def test_dp_by_sp_matches_jax_sharded():
    img = _rand(14, (4, 3, 32, 64))
    want = np.asarray(jspatial.upscale_spatial_sharded(
        jnp.asarray(img), (64, 128), _jmesh(8, ("dp", "sp"), (2, 4)), axis="sp", batch_axis="dp"))
    got = spatial.upscale_spatial_sharded(torch.from_numpy(img), (64, 128), _mesh(8, ("dp", "sp"), (2, 4)),
                                          axis="sp", batch_axis="dp", impl="torch").gather()
    np.testing.assert_allclose(got.numpy(), want, atol=TORCH_TOL, rtol=0)


# --- UpscalePipeline(mesh=) ---------------------------------------------------

PIPELINES = {
    # name: (constructor kwargs, source kind, call grain, dither bits)
    "hdr tail": (dict(hdr_srtm=True, grain_amount=0.3, dither_bits=10), "hdr", True, 10),
    "display u8, page": (dict(grain_amount=0.25, dither_bits=8, out_dtype=U8, compute_dtype=BF16,
                              dither_texture=_rand(15, (2, 24, 40))), "u8", True, 8),
    "bf16 after-pass": (dict(dither_bits=10, compute_dtype=BF16), "float", False, 10),
    "hdr out": (dict(hdr_srtm=True, hdr_out=True), "hdr", False, None),
    # impl="kernel" on both sides: the kernels' plain versions on each strip
    "hdr tail, kernel": (dict(hdr_srtm=True, grain_amount=0.3, dither_bits=10, impl="kernel"), "hdr", True, 10),
    "hdr out, kernel": (dict(hdr_srtm=True, hdr_out=True, impl="kernel"), "hdr", False, None),
}


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_pipeline_mesh_equals_single_device(name):
    kw, kind, use_grain, bits = PIPELINES[name]
    in_hw, out_hw = (64, 96), (96, 144)
    x = _source(kind, in_hw)[0]
    grain = torch.from_numpy(_rand(16, (3, *out_hw), -0.5, 0.5)) if use_grain else None
    sharded = fsr_tpu_torch.UpscalePipeline(out_hw, mesh=_mesh(4), **kw)
    single = fsr_tpu_torch.UpscalePipeline(out_hw, **kw)  # the same impl: "auto" is the torch path on the CPU
    got, want = sharded(x, grain=grain, frame=3).gather(), single(x, grain=grain, frame=3)
    assert got.dtype == want.dtype and got.shape == want.shape
    if bits is None:
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    else:
        scale = 255.0 if got.dtype == U8 else 1.0
        _check_steps(got.double().numpy() / scale, want.double().numpy() / scale, bits)


def test_pipeline_mesh_matches_jax():
    """tests/test_parallel.py::test_pipeline_mesh_full_chain on the port."""
    in_hw, out_hw = (96, 144), (144, 216)
    hdr = _rand(17, (3, *in_hw), 0.0, 4.0)
    grain = _rand(18, (3, *out_hw), -0.5, 0.5)
    kw = dict(out_size=out_hw, hdr_srtm=True, grain_amount=0.25, dither_bits=10)
    want = np.asarray(fsr_tpu.UpscalePipeline(mesh=_jmesh(4), **kw)(jnp.asarray(hdr), grain=jnp.asarray(grain),
                                                                     frame=3))
    got = fsr_tpu_torch.UpscalePipeline(mesh=_mesh(4), **kw)(torch.from_numpy(hdr), grain=torch.from_numpy(grain),
                                                             frame=3).gather()
    _check_steps(got.numpy(), want, 10)
