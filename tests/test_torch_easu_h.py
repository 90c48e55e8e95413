"""K6 (``fsr_tpu_torch.kernels.easu_h``: the float16 upscale, EASU "mixed"
+ FsrRcasH) and its dispatch on the CPU, where K6 runs its plain version,
against the port's torch path and the JAX package.

Limits: K6's plain version and the kernel path in float16 are the torch
path's ops, so they are bit-equal to ``upscale(impl="torch")`` (on the card
the kernel is held to the same bits, ``chip_smoke.py`` phase 17).  Against
``fsr_tpu.upscale(impl="xla", compute_dtype=float16)`` by the rows of
``tests/test_torch_fp16.py::test_upscale_f16_matches_fsr_tpu``: median
<= 1e-3 and at most 1% of the values over 1/255 (both round in float16, at
other places: XLA on the CPU may keep float32 inside a fusion).  K6's host
tables are bit-equal to ``ops.easu``'s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fsr_tpu
import fsr_tpu_torch
from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import dispatch as tdispatch
from fsr_tpu_torch.kernels import easu_gather as tgather
from fsr_tpu_torch.kernels import easu_h as teasu_h
from fsr_tpu_torch.kernels import fused as tfused
from fsr_tpu_torch.ops import easu as teasu

BUDGET = 1.0 / 255.0
F16 = torch.float16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small float16 ops per case: one torch thread for this module, so
    that pytest's workers do not oversubscribe the cores; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _img(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _source(seed, shape, kind):
    x = _img(seed, shape)
    return (x * 255).astype(np.uint8) if kind == "uint8" else x


def _torch(x, kind):
    t = torch.from_numpy(x)
    return t if kind in ("uint8", "float32") else t.to(getattr(torch, kind))


def _jax(x, kind):
    return jnp.asarray(x) if kind in ("uint8", "float32") else jnp.asarray(x).astype(getattr(jnp, kind))


def _con(in_hw, out_hw, viewport=None, offset=(0, 0)):
    vp = viewport or in_hw
    return EasuConstants.create((vp[1], vp[0]), (in_hw[1], in_hw[0]), (out_hw[1], out_hw[0]),
                                (offset[1], offset[0]))


CASES = [
    # id, source kind, source shape, upscale kwargs (the same for both packages)
    ("performance f16", "float16", (3, 27, 48), dict(preset="performance")),
    ("quality f32", "float32", (3, 36, 64), dict(preset="quality")),
    ("ultra_quality 1.3x bf16", "bfloat16", (3, 30, 40), dict(preset="ultra_quality")),
    ("balanced 1.7x u8", "uint8", (3, 30, 40), dict(preset="balanced")),
    ("DRS f16", "float16", (2, 3, 40, 72), dict(scale=1.5, input_viewport=(36, 64), input_offset=(2, 4))),
    ("odd extent f32", "float32", (3, 27, 48), dict(out_size=(53, 97))),
    ("RGBA performance f16", "float16", (4, 27, 48), dict(preset="performance")),
    ("RGBA quality u8", "uint8", (4, 36, 64), dict(preset="quality")),
    ("RGBA 1.7x bf16", "bfloat16", (4, 30, 40), dict(preset="balanced")),
    ("RGBA DRS f32", "float32", (4, 40, 72), dict(scale=1.5, input_viewport=(36, 64), input_offset=(2, 4))),
    ("EASU only f16", "float16", (3, 27, 48), dict(preset="performance", apply_rcas=False)),
    ("EASU only RGBA u8", "uint8", (4, 30, 40), dict(preset="ultra_quality", apply_rcas=False)),
    ("denoise f32", "float32", (3, 36, 64), dict(preset="quality", denoise=True, sharpness=0.5)),
    ("denoise RGBA f16", "float16", (4, 27, 48), dict(scale=2.0, denoise=True)),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_easu_h_equals_torch_path_and_fsr_tpu(case):
    """K6 (its plain version here) and the float16 kernel path, bit-equal
    to the torch path; all three against the JAX XLA path in float16."""
    _, kind, shape, kw = case
    x = _source(10, shape, kind)
    t = _torch(x, kind)
    want = fsr_tpu_torch.upscale(t, compute_dtype=F16, impl="torch", **kw)
    got = fsr_tpu_torch.upscale(t, compute_dtype=F16, impl="kernel", **kw)
    assert got.dtype == F16 and torch.equal(got.view(torch.int16), want.view(torch.int16))

    vp = kw.get("input_viewport", shape[-2:])
    out_hw = tuple(want.shape[-2:])
    con = _con(shape[-2:], out_hw, vp, kw.get("input_offset", (0, 0)))
    rcon = RcasConstants(kw.get("sharpness", 0.25))
    k6 = teasu_h.easu_h(t, out_hw, con, rcon, kw.get("apply_rcas", True), kw.get("denoise", False))
    assert torch.equal(k6.view(torch.int16), want.view(torch.int16))

    jx = fsr_tpu.upscale(_jax(x, kind), compute_dtype=jnp.float16, impl="xla", **kw)
    assert jx.dtype == jnp.float16 and tuple(jx.shape) == tuple(got.shape)
    d = np.abs(got.float().numpy() - np.asarray(jx).astype(np.float32))
    assert np.median(d) <= 1e-3 and (d > BUDGET).mean() <= 0.01


@pytest.mark.parametrize("in_hw,out_hw,vp,off", [
    ((27, 48), (54, 96), None, (0, 0)), ((36, 64), (54, 96), None, (0, 0)), ((30, 40), (51, 68), None, (0, 0)),
    ((40, 72), (54, 96), (36, 64), (2, 4)), ((27, 48), (53, 97), None, (0, 0)), ((30, 44), (30, 44), None, (0, 0))])
def test_k6_tables_equal_ops_easu_tables(in_hw, out_hw, vp, off):
    """The columns, rows, px and py K6 reads (K2's plan) are ``ops.easu``'s
    tap tables; the row tables' extra rows -1 and Hout repeat the edge rows
    (the RCAS clamp); each block's footprint holds its taps."""
    con = _con(in_hw, out_hw, vp, off)
    plan = tgather.plan(in_hw, out_hw, con)
    cols, rows, px, py = teasu._tables(con, out_hw, in_hw, torch.device("cpu"))
    for k, d in enumerate(range(-1, 3)):
        np.testing.assert_array_equal(plan.cols[k], cols[d].numpy())
        np.testing.assert_array_equal(plan.rows[k, 1:-1], rows[d].numpy())
    np.testing.assert_array_equal(plan.rows[:, 0], plan.rows[:, 1])
    np.testing.assert_array_equal(plan.rows[:, -1], plan.rows[:, -2])
    np.testing.assert_array_equal(plan.px.view(np.int32), px[0].numpy().view(np.int32))
    np.testing.assert_array_equal(plan.py[1:-1].view(np.int32), py[:, 0].numpy().view(np.int32))
    assert plan.py[0] == plan.py[1] and plan.py[-1] == plan.py[-2]
    assert tgather.footprint(plan).fits and teasu_h.supported((3, *in_hw), out_hw, con)


class _Calls:
    """Counts calls of K6's wrapper; K1's and K2's raise."""

    def __init__(self, monkeypatch):
        self.k6 = 0
        real = teasu_h.easu_h

        def k6(*args, **kwargs):
            self.k6 += 1
            return real(*args, **kwargs)

        def refuse(*args, **kwargs):
            raise AssertionError("a float16 upscale reached K1 or K2")

        monkeypatch.setattr(teasu_h, "easu_h", k6)
        for mod, name in ((tfused, "upscale_fused"), (tfused, "upscale_padded"), (tgather, "easu_gather")):
            monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("shape,kw", [
    ((3, 27, 48), dict(preset="performance")), ((4, 27, 48), dict(preset="performance")),
    ((3, 36, 64), dict(preset="quality")), ((4, 36, 64), dict(preset="quality", apply_rcas=False)),
    ((4, 27, 48), dict(preset="performance", out_dtype=torch.uint8, prologue="srtm")),
    ((3, 27, 48), dict(preset="performance", epilogue=fsr_tpu_torch.Epilogue(transform="gamma2", dither_bits=8),
                       frame=3))])
def test_f16_kernel_call_reaches_k6_once(shape, kw, monkeypatch):
    """A float16 ``impl="kernel"`` call: one K6 call, no K1 or K2; with an
    integer output, the prologue or the epilogue, those run inside that call
    (RGBA's alpha too), bit-equal to the torch path."""
    x = torch.from_numpy(_img(12, shape))
    want = fsr_tpu_torch.upscale(x, compute_dtype=F16, impl="torch", **kw)
    calls = _Calls(monkeypatch)
    got = fsr_tpu_torch.upscale(x, compute_dtype=F16, impl="kernel", **kw)
    assert calls.k6 == 1
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_f16_downscale_raises_naming_torch_path():
    x = torch.from_numpy(_img(13, (3, 54, 96)))
    con = _con((54, 96), (27, 48))
    assert not tdispatch.supported(x, (27, 48), con, F16)
    with pytest.raises(NotImplementedError, match="impl='torch'"):
        fsr_tpu_torch.upscale(x, out_size=(27, 48), compute_dtype=F16, impl="kernel")
    with pytest.raises(NotImplementedError, match="impl='torch'"):
        tdispatch.upscale_fused(x, (27, 48), con, RcasConstants(0.25), True, False, F16)
    with pytest.raises(ValueError, match="upscales only"):
        teasu_h.easu_h(x, (27, 48), con, RcasConstants(0.25))
    out = fsr_tpu_torch.upscale(x, out_size=(27, 48), compute_dtype=F16, impl="torch")
    assert out.dtype == F16 and out.shape == (3, 27, 48)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,kw,kernel", [
    ((3, 27, 48), dict(preset="performance"), "K1"), ((4, 36, 64), dict(preset="quality"), "K2"),
    ((3, 27, 48), dict(preset="performance", out_dtype=torch.uint8), "K1")], ids=["K1", "K2 RGBA", "K1 u8 out"])
def test_f16_image_under_f32_math_runs_k1_or_k2(dt, shape, kw, kernel, monkeypatch):
    """K1 and K2 take a float16 image under float32 or bfloat16 math: it
    widens exactly at their loads (or rounds there to bfloat16 storage), so
    the kernel path on it equals the kernel path on the image widened to
    float32; one K1 or K2 call, no K6."""
    x = torch.from_numpy(_img(14, shape)).half()
    want = fsr_tpu_torch.upscale(x.float(), compute_dtype=dt, impl="kernel", **kw)
    calls = {}

    def counted(name, real):
        def run(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return real(*args, **kwargs)
        return run

    monkeypatch.setattr(tfused, "upscale_fused", counted("K1", tfused.upscale_fused))
    monkeypatch.setattr(tgather, "easu_gather", counted("K2", tgather.easu_gather))
    monkeypatch.setattr(teasu_h, "easu_h", counted("K6", teasu_h.easu_h))
    got = fsr_tpu_torch.upscale(x, compute_dtype=dt, impl="kernel", **kw)
    assert calls == {kernel: 1}
    assert got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("src", ["float16", "float32"])
@pytest.mark.parametrize("nc", [3, 4])
def test_f16_kernel_grad_equals_torch_path(src, nc):
    """K6 forward, the torch twin's backward: the gradient under sum(out)
    is the torch path's, bit for bit."""
    def grad(impl):
        x = torch.from_numpy(_img(15, (nc, 20, 26))).to(getattr(torch, src)).requires_grad_()
        fsr_tpu_torch.upscale(x, scale=2.0, compute_dtype=F16, impl=impl).float().sum().backward()
        return x.grad

    got = grad("kernel")
    assert torch.isfinite(got).all() and got.abs().max() > 0
    assert torch.equal(got, grad("torch"))


def test_easu_h_wrapper_refuses():
    con = _con((27, 48), (54, 96))
    x = torch.from_numpy(_img(16, (3, 27, 48)))
    with pytest.raises(TypeError, match="float16/float32/bfloat16/uint8"):
        teasu_h.easu_h(x.double(), (54, 96), con, RcasConstants(0.25))
    with pytest.raises(ValueError, match="3 or 4"):
        teasu_h.easu_h(x[:2], (54, 96), con, RcasConstants(0.25))
    with pytest.raises(ValueError, match="requires rcon"):
        teasu_h.easu_h(x, (54, 96), con, None, True)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        teasu_h.easu_h(x.to("meta"), (54, 96), con, RcasConstants(0.25))
    assert teasu_h.easu_h.launches == 0  # CPU tensors run the plain version


def test_easu_h_module_leaves_jax_out():
    from pathlib import Path

    src = Path(teasu_h.__file__).read_text()
    assert "import jax" not in src and "from jax" not in src
    assert "import fsr_tpu\n" not in src and "from fsr_tpu " not in src and "from fsr_tpu." not in src
