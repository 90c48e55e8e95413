"""The slice as a whole: ``fsr_tpu_torch.upscale`` against ``fsr_tpu.upscale``
on the CPU.

On the CPU both packages take their plain paths ("auto": torch ops and XLA
ops), which run the same f32 ops in the same order: within 2e-6 (XLA may
fuse and reassociate).  bf16 accumulates in bf16 on both sides; jitted XLA
keeps excess precision in fusions, so bf16 is held to the f32 oracle by
median and p99 against the JAX numbers.  ``impl="kernel"`` on the CPU runs
the plain versions of K4 and K1, or of K2: within 6e-5 of the XLA path (the
JAX package's fused-vs-XLA bound).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fsr_tpu
import fsr_tpu_torch
from fsr_tpu_torch.utils.profiling import cuda_time_ms, device_trace

F32_TOL = 2e-6
KERNEL_TOL = 6e-5


def _img(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


CASES = [
    # id, input shape, upscale kwargs
    ("performance", (3, 27, 48), dict(preset="performance")),
    ("scale 1.5", (3, 36, 64), dict(scale=1.5)),
    ("out_size ragged", (3, 30, 44), dict(out_size=(63, 88))),
    ("HWC", (27, 48, 3), dict(preset="performance", layout="HWC")),
    ("batch dims", (2, 2, 3, 20, 36), dict(scale=2.0)),
    ("easu only", (3, 27, 48), dict(preset="performance", apply_rcas=False)),
    ("denoise sharpness", (3, 27, 48), dict(preset="quality", denoise=True, sharpness=0.5)),
    ("DRS viewport offset", (3, 40, 72), dict(scale=2.0, input_viewport=(36, 64), input_offset=(2, 4))),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_upscale_matches_fsr_tpu(case):
    _, shape, kw = case
    img = _img(0, shape)
    want = np.asarray(fsr_tpu.upscale(jnp.asarray(img), **kw))
    got = fsr_tpu_torch.upscale(torch.from_numpy(img), **kw)
    assert got.dtype == torch.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)


def test_upscale_bf16_matches_fsr_tpu_statistically():
    from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
    from fsr_tpu_torch.reference import scalar as ref

    img = _img(1, (3, 27, 48))
    want = np.asarray(fsr_tpu.upscale(jnp.asarray(img), preset="performance",
                                      compute_dtype=jnp.bfloat16).astype(jnp.float32))
    got = fsr_tpu_torch.upscale(torch.from_numpy(img), preset="performance", compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    con = EasuConstants.create((48, 27), None, (96, 54))
    oracle = ref.rcas_ref(ref.easu_ref(img, (54, 96), con), RcasConstants(0.25))
    d_got, d_jax = np.abs(got.float().numpy() - oracle), np.abs(want - oracle)
    assert np.median(d_got) <= 1.1 * np.median(d_jax)
    assert np.percentile(d_got, 99) <= 1.1 * np.percentile(d_jax, 99)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_upscale_kernel_impl_on_cpu_matches_xla(dt):
    img = _img(2, (2, 3, 27, 48))
    want = np.asarray(fsr_tpu.upscale(jnp.asarray(img), preset="performance", impl="xla"))
    got = fsr_tpu_torch.upscale(torch.from_numpy(img), preset="performance", impl="kernel",
                                compute_dtype=getattr(torch, dt))
    assert got.dtype == getattr(torch, dt)
    d = np.abs(got.float().numpy() - want)
    if dt == "float32":
        assert d.max() <= KERNEL_TOL
    else:  # bf16 storage of the f32 kernel math: input and output rounding
        assert np.median(d) <= 1.0 / 510.0 and np.percentile(d, 99) <= 5.0 / 255.0


# The names are those of the raise these cases expected before autodiff;
# each checks that a gradient flows and equals the torch path's
# (tests/test_torch_grad.py holds it against jax.grad).
UNSUPPORTED = [
    ("grad on the kernel path", "kernel"),
    ("grad on the torch path", "torch"),
]


@pytest.mark.parametrize("case", UNSUPPORTED, ids=lambda c: c[0])
def test_unsupported_options_raise(case):
    _, impl = case

    def grad(impl):
        x = torch.from_numpy(_img(3, (3, 27, 48))).requires_grad_()
        fsr_tpu_torch.upscale(x, preset="performance", impl=impl).sum().backward()
        return x.grad

    got = grad(impl)
    assert torch.isfinite(got).all() and got.abs().max() > 0
    torch.testing.assert_close(got, grad("torch"), atol=0, rtol=0)


PORTED_OPTIONS = [
    # id, upscale kwargs beside the image: the options that raised until
    # byte I/O, the prologue, the epilogue, RGBA and float16 were ported
    ("RGBA", lambda x: dict(image=torch.cat([x, x[:1]], dim=0))),
    ("float16 compute", lambda x: dict(compute_dtype=torch.float16)),
    ("float16 input", lambda x: dict(image=x.half())),
    ("uint8 input", lambda x: dict(image=(x * 255).to(torch.uint8))),
    ("uint8 output", lambda x: dict(out_dtype=torch.uint8)),
    ("prologue", lambda x: dict(prologue="srtm")),
    ("epilogue", lambda x: dict(epilogue=fsr_tpu_torch.Epilogue(transform="gamma2"))),
    ("frame", lambda x: dict(epilogue=fsr_tpu_torch.Epilogue(dither_bits=10), frame=3)),
    ("grain", lambda x: dict(epilogue=fsr_tpu_torch.Epilogue(grain_amount=0.3), grain=torch.zeros(3, 54, 96))),
    ("dither_page", lambda x: dict(epilogue=fsr_tpu_torch.Epilogue(dither_bits=8, dither_texture=True),
                                   dither_page=torch.zeros(128, 128))),
]


@pytest.mark.parametrize("case", PORTED_OPTIONS, ids=lambda c: c[0])
def test_ported_options_agree_across_impl(case):
    """Each option runs on the kernel path (its plain versions here) and the
    torch path and agrees with the JAX XLA path (tests/test_torch_epilogue.py,
    test_torch_uint8.py, test_torch_rgba.py and test_torch_fp16.py hold them
    closely).  float16 math runs K6 on the kernel path, and a float16 image
    under float32 math K1 or K2."""
    _, make = case
    x = torch.from_numpy(_img(3, (3, 27, 48)))
    kw = dict(image=x, preset="performance")
    kw.update(make(x))
    outs = [fsr_tpu_torch.upscale(**kw, impl=impl) for impl in ("kernel", "torch")]
    nc = kw["image"].shape[-3]
    assert outs[0].shape == outs[1].shape == (nc, 54, 96) and outs[0].dtype == outs[1].dtype
    d = (outs[0].double() - outs[1].double()).abs()
    step = 1.0 if outs[0].dtype == torch.uint8 else 1.0 / 255.0  # at most a code or a dither step
    assert (d > 1e-4).float().mean() <= 1e-3 and d.max() <= step


KERNEL_PATH_CASES = [
    # id, input shape, upscale kwargs: every preset and a DRS ratio
    ("ultra_quality", (3, 30, 44), dict(preset="ultra_quality")),
    ("quality", (3, 36, 64), dict(preset="quality")),
    ("balanced", (3, 30, 44), dict(preset="balanced")),
    ("native", (3, 30, 44), dict(preset="native")),
    ("2x odd width", (3, 27, 48), dict(out_size=(54, 97))),
    ("DRS 1.5x", (2, 3, 40, 72), dict(scale=1.5, input_viewport=(36, 64), input_offset=(2, 4))),
    ("bf16 storage", (3, 36, 64), dict(preset="quality", compute_dtype=torch.bfloat16)),
]


@pytest.mark.parametrize("case", KERNEL_PATH_CASES, ids=lambda c: c[0])
def test_kernel_path_takes_every_preset(case):
    """impl="kernel" reaches K2 (on the CPU its plain version) wherever K1
    does not apply; held to the JAX XLA path like the Performance case."""
    _, shape, kw = case
    img = _img(5, shape)
    jkw = {k: v for k, v in kw.items() if k != "compute_dtype"}
    want = np.asarray(fsr_tpu.upscale(jnp.asarray(img), impl="xla", **jkw))
    got = fsr_tpu_torch.upscale(torch.from_numpy(img), impl="kernel", **kw)
    assert got.shape == want.shape
    d = np.abs(got.float().numpy() - want)
    if got.dtype == torch.float32:
        assert d.max() <= KERNEL_TOL
    else:
        assert np.median(d) <= 1.0 / 510.0 and np.percentile(d, 99) <= 5.0 / 255.0


def test_kernel_path_raises_on_downscale():
    x = torch.from_numpy(_img(6, (3, 27, 48)))
    with pytest.raises(NotImplementedError, match="impl='torch'"):
        fsr_tpu_torch.upscale(x, out_size=(20, 40), impl="kernel")
    assert fsr_tpu_torch.upscale(x, out_size=(20, 40), impl="torch").shape == (3, 20, 40)


def test_bad_arguments_raise_value_error():
    x = torch.from_numpy(_img(4, (3, 27, 48)))
    for kw in (dict(impl="pallas"), dict(layout="NHWC"), dict(preset="ultra")):
        with pytest.raises(ValueError):
            fsr_tpu_torch.upscale(x, **{"preset": "performance", **kw})


def test_import_leaves_jax_out():
    code = "import sys, fsr_tpu_torch; print('jax' in sys.modules, 'fsr_tpu' in sys.modules)"
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert res.stdout.split() == ["False", "False"]


@pytest.mark.parametrize("fn", [cuda_time_ms, device_trace], ids=lambda f: f.__name__)
def test_device_timers_refuse_without_cuda(fn, monkeypatch):
    # A device timing never falls back to the host clock.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(lambda: None)


def test_chip_smoke_refuses_without_cuda():
    # No card: a non-zero exit and no result line.
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, str(root / "chip_smoke.py")], cwd=root, env=env,
                         capture_output=True, text=True)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
