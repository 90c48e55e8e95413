"""The port's image utilities, ``trace_annotation`` and CLI
(``fsr_tpu_torch.utils``, ``fsr_tpu_torch.cli``) on the CPU, against the
JAX package's.

- ``utils.image``: the cases of tests/test_utils_cli.py:13-56, and each
  function bit-equal to ``fsr_tpu.utils.image``'s on the same inputs.
- The CLI (``--cpu``, the plain-torch path): the cases of
  tests/test_utils_cli.py:58-128; its ``.npy`` output at 32x48 -> 64x96
  f32 within 2e-5 max-abs of ``fsr_tpu.cli``'s (``--impl xla``) for the
  plain, ``--no-rcas``, ``--mode bilinear`` and ``--hdr`` runs (the two
  sum the same float32 terms in other orders); with grain and the 8-bit
  dither, codes within one step and at most 0.2% of them off (the share
  tests/test_torch_epilogue.py uses: a dither knife edge flips a code on
  a last-bit difference); with no CUDA device and no ``--cpu`` it returns
  2 and writes nothing.
"""

import json
import os

import numpy as np
import pytest
import torch

from fsr_tpu import cli as jcli
from fsr_tpu.utils import image as jim

from fsr_tpu_torch import cli
from fsr_tpu_torch.utils import image as im
from fsr_tpu_torch.utils.profiling import trace_annotation

CLI_TOL = 2e-5
CODE_SHARE = 0.002


def test_uint8_codec_d3d_rule():
    x = np.array([0.0, 1.0, 0.4999 / 255, 0.5001 / 255, 2.0, -1.0, np.nan], np.float32)
    got = im.to_uint8(x)
    np.testing.assert_array_equal(got, [0, 255, 0, 1, 255, 0, 0])
    np.testing.assert_allclose(im.from_uint8(np.array([255])), [1.0])


def test_uint10_codec():
    x = np.array([0.0, 1.0, 0.5], np.float32)
    np.testing.assert_array_equal(im.to_uint10(x), [0, 1023, 512])


def test_psnr():
    a = np.zeros((3, 8, 8), np.float32)
    assert im.psnr(a, a) == float("inf")
    b = a + 0.1
    assert abs(im.psnr(a, b) - 20.0) < 1e-3


def test_layout_roundtrip(rng):
    x = rng.uniform(size=(3, 5, 7)).astype(np.float32)
    np.testing.assert_array_equal(im.hwc_to_chw(im.chw_to_hwc(x)), x)


def test_magnify_and_side_by_side(rng):
    x = rng.uniform(size=(3, 64, 64)).astype(np.float32)
    z = im.magnify(x, (32, 32), size=8, zoom=4)
    assert z.shape == (3, 32, 32)
    np.testing.assert_array_equal(z[:, ::4, ::4], x[:, 28:36, 28:36])
    s = im.side_by_side(x, x, pad=2)
    assert s.shape == (3, 64, 130)


def test_image_io_roundtrip(tmp_path, rng):
    x = rng.uniform(size=(3, 16, 24)).astype(np.float32)
    p = str(tmp_path / "img.png")
    im.save_image(p, x)
    back = im.load_image(p)
    assert back.shape == (3, 16, 24)
    assert np.max(np.abs(back - x)) <= 0.5 / 255 + 1e-6
    pn = str(tmp_path / "img.npy")
    im.save_image(pn, x)
    np.testing.assert_array_equal(im.load_image(pn), x)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["hwc_to_chw", "chw_to_hwc", "to_uint8", "from_uint8", "to_uint10",
                                  "from_uint10", "psnr", "max_abs_error", "magnify", "side_by_side"])
def test_image_function_bit_equal_to_jax(name, rng):
    x = rng.uniform(-0.2, 1.2, (3, 40, 36)).astype(np.float32)
    x[0, 0, :3] = [np.nan, np.inf, -np.inf]
    y = rng.uniform(0, 1, (3, 40, 36)).astype(np.float32)
    hwc = rng.uniform(0, 1, (40, 36, 4)).astype(np.float32)
    codes = rng.integers(0, 1024, (3, 8, 8)).astype(np.uint16)
    ours, theirs = getattr(im, name), getattr(jim, name)
    if name == "hwc_to_chw":
        _same(ours(hwc), theirs(hwc))
    elif name == "chw_to_hwc":
        _same(ours(y), theirs(y))
    elif name in ("from_uint8", "from_uint10"):
        _same(ours(codes), theirs(codes))
    elif name in ("psnr", "max_abs_error"):
        for peak in ((1.0,) if name == "max_abs_error" else (1.0, 255.0)):
            args = (y, y + 0.01) if name == "max_abs_error" else (y, y + 0.01, peak)
            assert ours(*args) == theirs(*args)
        assert ours(y, y.astype(np.float64) * 1.001) == theirs(y, y.astype(np.float64) * 1.001)
    elif name == "magnify":
        for center, size, zoom in [((20, 18), 16, 4), ((0, 0), 8, 3), ((39, 35), 32, 2)]:
            _same(ours(y, center, size, zoom), theirs(y, center, size, zoom))
        _same(ours(hwc, (10, 10), 8, 2, layout="HWC"), theirs(hwc, (10, 10), 8, 2, layout="HWC"))
    elif name == "side_by_side":
        _same(ours(y, y[:, :30], x, pad=3), theirs(y, y[:, :30], x, pad=3))
    else:
        _same(ours(x), theirs(x))


@pytest.mark.parametrize("ext", ["png", "npy"])
def test_image_io_bit_equal_to_jax(tmp_path, rng, ext):
    x = rng.uniform(-0.1, 1.1, (3, 17, 23)).astype(np.float32)
    ours, theirs = str(tmp_path / f"a.{ext}"), str(tmp_path / f"b.{ext}")
    im.save_image(ours, x)
    jim.save_image(theirs, x)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for layout in ("CHW", "HWC"):
        _same(im.load_image(ours, layout), jim.load_image(ours, layout))


def test_trace_annotation_in_cpu_trace():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace_annotation("FSR 1.0"):
            torch.ones(4, 4).sum()
    assert any(e.name == "FSR 1.0" for e in prof.events())


def test_cli_end_to_end(tmp_path, rng):
    src = rng.uniform(0, 1, (3, 32, 48)).astype(np.float32)
    inp = str(tmp_path / "in.png")
    outp = str(tmp_path / "out.png")
    cmp_p = str(tmp_path / "cmp.png")
    csv = str(tmp_path / "r.csv")
    im.save_image(inp, src)
    rc = cli.main([inp, outp, "--scale", "2.0", "--cpu", "--impl", "torch",
                   "--benchmark", "2", "--results", csv, "--compare", cmp_p])
    assert rc == 0
    out = im.load_image(outp)
    assert out.shape == (3, 64, 96)
    assert os.path.exists(cmp_p)
    lines = open(csv).read().strip().splitlines()
    assert lines[0] == "frame,ms" and len(lines) == 3

    # Magnified A/B: the strip is two zoomed 32x32 crops + separator.
    mag_p = str(tmp_path / "mag.png")
    rc = cli.main([inp, mag_p, "--scale", "2.0", "--cpu", "--impl", "torch",
                   "--compare", mag_p, "--magnify", "32", "48", "4"])
    assert rc == 0
    mag = im.load_image(mag_p)
    assert mag.shape == (3, 128, 2 * 128 + 4)


def test_cli_pipeline_flags(tmp_path, rng):
    src = rng.uniform(0, 1, (3, 32, 48)).astype(np.float32)
    inp = str(tmp_path / "in.png")
    outp = str(tmp_path / "out.png")
    im.save_image(inp, src)
    rc = cli.main([inp, outp, "--scale", "2.0", "--cpu", "--impl", "torch",
                   "--grain", "0.2", "--dither-bits", "8", "--frame", "3"])
    assert rc == 0
    out = im.load_image(outp)
    assert out.shape == (3, 64, 96)
    assert np.isfinite(out).all() and out.min() >= 0.0 and out.max() <= 1.0
    rc = cli.main([inp, str(tmp_path / "hdr.png"), "--scale", "2.0",
                   "--cpu", "--impl", "torch", "--hdr"])
    assert rc == 0
    # The reference's pipeline refuses TEPD on HDR output; so does the port's.
    with pytest.raises(ValueError, match="TEPD"):
        cli.main([inp, str(tmp_path / "x.png"), "--scale", "2.0", "--cpu", "--hdr", "--dither-bits", "10"])
    assert cli.main([inp, str(tmp_path / "x.png"), "--cpu", "--blue-noise"]) == 2
    assert cli.main([inp, str(tmp_path / "x.png"), "--cpu", "--mode", "bilinear", "--grain", "0.1"]) == 2


def test_cli_config_merge(tmp_path, rng):
    src = rng.uniform(0, 1, (3, 20, 20)).astype(np.float32)
    inp = str(tmp_path / "in.png")
    outp = str(tmp_path / "out.png")
    cfg = str(tmp_path / "cfg.json")
    im.save_image(inp, src)
    with open(cfg, "w") as f:
        json.dump({"scale": 2.0, "no_rcas": True, "impl": "torch", "cpu": True}, f)
    rc = cli.main([inp, outp, "--config", cfg])
    assert rc == 0
    assert im.load_image(outp).shape == (3, 40, 40)


def test_cli_modes(tmp_path, rng):
    src = rng.uniform(0, 1, (3, 16, 16)).astype(np.float32)
    inp = str(tmp_path / "in.png")
    im.save_image(inp, src)
    for mode, shape in [("bilinear", (3, 32, 32)), ("native", (3, 16, 16))]:
        outp = str(tmp_path / f"{mode}.png")
        assert cli.main([inp, outp, "--scale", "2.0", "--mode", mode, "--cpu"]) == 0
        assert im.load_image(outp).shape == shape


def test_cli_without_cuda_needs_cpu_flag(tmp_path, rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inp = str(tmp_path / "in.png")
    im.save_image(inp, rng.uniform(0, 1, (3, 16, 16)).astype(np.float32))
    outp = tmp_path / "out.png"
    assert cli.main([inp, str(outp), "--scale", "2.0"]) == 2
    assert not outp.exists()


@pytest.fixture(scope="module")
def cli_input(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    src = np.random.default_rng(10).uniform(0, 1, (3, 32, 48)).astype(np.float32)
    inp = str(d / "in.png")
    im.save_image(inp, src)
    return d, inp


def _both(cli_input, flags, name):
    d, inp = cli_input
    ours, theirs = str(d / f"{name}_torch.npy"), str(d / f"{name}_jax.npy")
    assert cli.main([inp, ours, "--cpu", *flags]) == 0
    assert jcli.main([inp, theirs, "--impl", "xla", *flags]) == 0
    return np.load(ours), np.load(theirs)


@pytest.mark.parametrize("flags", [["--scale", "2.0"], ["--scale", "2.0", "--no-rcas"],
                                   ["--scale", "2.0", "--mode", "bilinear"], ["--scale", "2.0", "--hdr"],
                                   ["--scale", "2.0", "--denoise"], ["--preset", "quality"]],
                         ids=lambda f: " ".join(f))
def test_cli_matches_jax_cli(cli_input, flags):
    ours, theirs = _both(cli_input, flags, "_".join(f.strip("-.") for f in flags))
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype == np.float32
    assert np.abs(ours - theirs).max() <= CLI_TOL


def test_cli_grain_dither_codes_match_jax_cli(cli_input):
    ours, theirs = _both(cli_input, ["--scale", "2.0", "--grain", "0.2", "--dither-bits", "8", "--frame", "3"],
                         "dither")
    d = np.abs(np.round(ours * 255.0) - np.round(theirs * 255.0))
    np.testing.assert_allclose(ours * 255.0, np.round(ours * 255.0), atol=1e-3)
    assert d.max() <= 1
    assert (d > 0).mean() <= CODE_SHARE
