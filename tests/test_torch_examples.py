"""The port's examples and quality study (``examples_torch/``,
``tools_torch/quality_study.py``) on the CPU, against the JAX package's
files (loaded by path) and functions.

- sample_app: the cases of tests/test_utils_cli.py:237-304 (the
  flythrough at 128x64, camera interpolation, the HDR chain); the
  procedural scene against JAX's by share (at least 99.5% of values within
  1e-5: ``sign(sin(u*110) * sin(v*110))`` flips a pixel between two levels
  where torch's and XLA's ``sin`` part by an ulp at a zero crossing); the
  frame tail (tonemap + pipeline) on one shared scene within 2e-5 of JAX's
  (the same float32 terms in other orders), in the HDR chain by the 0.2%
  share of values off (the 10-bit dither has knife edges).
- The numpy copies (``synthetic_clip``, ``synthetic_corpus``,
  frame_graph's ``render_scene``, quality_study's ``test_images`` and
  ``box_down2``) bit-equal to the JAX files'.
- video_upscale's ``process`` and dataset_preprocessing on
  ``devices=[cpu] * 2`` against ``fsr_tpu`` at 32x48, codes by the 0.2%
  share of tests/test_torch_epilogue.py, each at most one code off.
- quality_study's PSNRs at 128x128 within 0.01 dB of the same loop on
  ``fsr_tpu``.
"""

import importlib.util
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fsr_tpu
from fsr_tpu.core.constants import EasuConstants as JEasu
from fsr_tpu.kernels.epilogue import Epilogue as JEpilogue
from fsr_tpu.ops import easu as jeasu
from fsr_tpu.utils.image import psnr as jpsnr

import fsr_tpu_torch
from examples_torch import dataset_preprocessing, frame_graph, sample_app, video_upscale
from tools_torch import quality_study

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SCENE_TOL, SCENE_SHARE = 1e-5, 0.995
TAIL_TOL = 2e-5
CODE_SHARE = 0.002


def _by_path(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_examples():
    return {
        "sample_app": _by_path("jax_sample_app", "examples/sample_app.py"),
        "frame_graph": _by_path("jax_frame_graph", "examples/frame_graph.py"),
        "video_upscale": _by_path("jax_video_upscale", "examples/video_upscale.py"),
        "dataset_preprocessing": _by_path("jax_dataset_preprocessing", "examples/dataset_preprocessing.py"),
        "quality_study": _by_path("jax_quality_study", "tools/quality_study.py"),
    }


def _codes(ours, theirs, scale=255.0):
    """Codes at most one apart, at most CODE_SHARE of them off."""
    a = np.round(np.asarray(ours, np.float64) * scale) if scale else np.asarray(ours, np.int64)
    b = np.round(np.asarray(theirs, np.float64) * scale) if scale else np.asarray(theirs, np.int64)
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert d.max() <= 1
    assert (d > 0).mean() <= CODE_SHARE


def test_sample_app_benchmark_flythrough(tmp_path):
    """FSRSample-analog app: keyframed benchmark loop writes per-frame CSV
    rows and keyframe screenshots (FSRSample.json BenchmarkSettings)."""
    csv_p = str(tmp_path / "bench.csv")
    shot = str(tmp_path / "shot")
    cfg = sample_app.merge_config(
        sample_app.DEFAULT_CONFIG,
        {
            "globals": {"width": 128, "height": 64, "preset": "performance"},
            "scenes": [{"BenchmarkSettings": {
                "fps": 2, "warmUpFrames": 1,
                "resultsFilename": csv_p, "screenShotName": shot,
            }}],
        },
    )
    # list merge keeps the base scene's keyframes
    assert "keyFrames" in cfg["scenes"][0]["BenchmarkSettings"]
    app = sample_app.SampleApp(cfg, device=CPU)
    assert app.render_hw == (32, 64)  # display / 2.0, truncated
    rows = sample_app.run_benchmark(app, cfg["scenes"][0]["BenchmarkSettings"])
    assert len(rows) == 5  # 2 s * 2 fps + 1
    lines = open(csv_p).read().strip().splitlines()
    assert lines[0] == "frame,time,ms,screenshot" and len(lines) == 6
    assert os.path.exists(shot + "_0.png") and os.path.exists(shot + "_1.png")
    # screenshots land on the screenShot-flagged keyframes (t=0 and t=2)
    assert rows[0]["screenshot"] == "shot_0.png"
    assert rows[-1]["screenshot"] == "shot_1.png"


def test_sample_app_camera_interp(jax_examples):
    kfs = [
        {"time": 0.0, "cy": 0.0, "cx": 0.0, "zoom": 1.0},
        {"time": 2.0, "cy": 1.0, "cx": 2.0, "zoom": 3.0},
    ]
    mid = sample_app.camera_at(kfs, 1.0)
    assert abs(mid["cy"] - 0.5) < 1e-9 and abs(mid["zoom"] - 2.0) < 1e-9
    assert sample_app.camera_at(kfs, -1.0)["zoom"] == 1.0
    assert sample_app.camera_at(kfs, 9.0)["zoom"] == 3.0
    jsa = jax_examples["sample_app"]
    kfs = sample_app.DEFAULT_CONFIG["scenes"][0]["BenchmarkSettings"]["keyFrames"]
    for t in (-0.5, 0.0, 0.3, 1.0, 1.7, 2.0, 2.5):
        assert sample_app.camera_at(kfs, t) == jsa.camera_at(kfs, t)
    over = {"globals": {"preset": "balanced"}, "scenes": [{"exposure": 0.5}, {"name": "second"}]}
    base = sample_app.DEFAULT_CONFIG
    assert sample_app.merge_config(base, over) == jsa.merge_config(base, over)


def test_sample_app_hdr_mode_chain():
    """HDR globals: tonemap+TEPD10 feeds FSR's gamma2 (Sample.x==1) chain;
    output is linear and in range."""
    cfg = sample_app.merge_config(
        sample_app.DEFAULT_CONFIG,
        {"globals": {"width": 128, "height": 64, "hdr": True,
                     "preset": "quality"}},
    )
    app = sample_app.SampleApp(cfg, device=CPU)
    cam = {"cy": 0.5, "cx": 0.5, "zoom": 1.0}
    out = app.render_frame(cam, 0.0, 3).numpy()
    assert out.shape == (3, 64, 128)
    assert np.isfinite(out).all() and out.min() >= 0.0 and out.max() <= 1.0


@pytest.mark.parametrize("mode,shape", [("bilinear", (3, 64, 128)), ("native", (3, 64, 128))])
def test_sample_app_other_modes(mode, shape):
    cfg = sample_app.merge_config(sample_app.DEFAULT_CONFIG,
                                  {"globals": {"width": 128, "height": 64, "mode": mode}})
    app = sample_app.SampleApp(cfg, device=CPU)
    out = app.render_frame({"cy": 0.5, "cx": 0.5, "zoom": 1.0}, 0.0, 1)
    assert tuple(out.shape) == shape and torch.isfinite(out).all()


def test_sample_app_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sample_app.SampleApp(sample_app.DEFAULT_CONFIG)
    assert sample_app.main([]) == 2


@pytest.mark.parametrize("cam,frame", [((0.52, 0.34, 1.0), 0), ((0.46, 0.5, 1.7), 5), ((0.55, 0.66, 2.4), 23)])
def test_sample_app_scene_matches_jax(jax_examples, cam, frame):
    jsa = jax_examples["sample_app"]
    hw = (72, 128)
    want = np.asarray(jsa.render_scene(hw, tuple(jnp.float32(c) for c in cam), jnp.float32(frame)))
    got = sample_app.render_scene(hw, tuple(torch.tensor(c, dtype=torch.float32) for c in cam),
                                  torch.tensor(float(frame), dtype=torch.float32)).numpy()
    assert got.shape == want.shape == (3, *hw) and got.dtype == want.dtype == np.float32
    assert (np.abs(got - want) <= SCENE_TOL).mean() >= SCENE_SHARE


@pytest.mark.parametrize("hdr", [False, True])
def test_sample_app_frame_tail_matches_jax(jax_examples, monkeypatch, hdr):
    jsa = jax_examples["sample_app"]
    over = {"globals": {"width": 128, "height": 64, "preset": "quality", "hdr": hdr}}
    render_hw = (42, 85)
    scene = np.random.default_rng(4).uniform(0, 6, (3, *render_hw)).astype(np.float32)
    monkeypatch.setattr(jsa, "render_scene", lambda hw, cam, f: jnp.asarray(scene))
    monkeypatch.setattr(sample_app, "render_scene", lambda hw, cam, f: torch.from_numpy(scene))
    japp = jsa.SampleApp(jsa.merge_config(jsa.DEFAULT_CONFIG, over))
    app = sample_app.SampleApp(sample_app.merge_config(sample_app.DEFAULT_CONFIG, over), device=CPU)
    assert app.render_hw == japp.render_hw == render_hw
    cam = {"cy": 0.5, "cx": 0.5, "zoom": 1.0}
    for frame in (0, 3):
        want = np.asarray(japp.render_frame(cam, 0.0, frame))
        got = app.render_frame(cam, 0.0, frame).numpy()
        assert got.shape == want.shape == (3, 64, 128)
        d = np.abs(got - want)
        if hdr:
            # gamma2 of a 10-bit code: a flipped code moves an output by
            # at most ~2 * 2/1023 through EASU+RCAS.
            assert (d > TAIL_TOL).mean() <= CODE_SHARE and d.max() <= 8.0 / 1023
        else:
            assert d.max() <= TAIL_TOL


def test_frame_graph_scene_and_tail(jax_examples):
    jfg = jax_examples["frame_graph"]
    for frame, jitter, seed in [(7, True, 0), (0, False, 3), (12, True, 1)]:
        a = frame_graph.render_scene((36, 64), frame, jitter, seed)
        b = jfg.render_scene((36, 64), frame, jitter, seed)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    scene = frame_graph.render_scene((36, 64), 7)
    got = frame_graph.frame_tail(torch.from_numpy(scene), (72, 128)).numpy()
    from fsr_tpu import api as japi
    from fsr_tpu.core import tonemap as jtm

    want = np.asarray(japi.upscale(jtm.tonemap(jnp.asarray(scene), exposure=0.7, tonemapper="amd"),
                                   out_size=(72, 128), sharpness=0.25, impl="xla"))
    assert np.abs(got - want).max() <= TAIL_TOL


def test_video_clip_and_process_match_jax(jax_examples):
    jvu = jax_examples["video_upscale"]
    clip = video_upscale.synthetic_clip(4, (32, 48))
    jclip = jvu.synthetic_clip(4, (32, 48))
    assert clip.dtype == jclip.dtype
    np.testing.assert_array_equal(clip, jclip)
    out_hw = (64, 96)
    up = video_upscale.VideoUpscaler(out_hw, CPU)
    grain = np.random.default_rng(1).uniform(-0.5, 0.5, (3, *out_hw)).astype(np.float32)
    np.testing.assert_array_equal(up.grain.numpy(), grain)
    jpipe = fsr_tpu.UpscalePipeline(out_hw, sharpness=0.25, grain_amount=0.15, dither_bits=8)
    video = up.run(clip, 2)
    assert video.shape == (4, 3, *out_hw)
    for b0 in (0, 2):
        got = up.process(torch.from_numpy(clip[b0 : b0 + 2]), b0).numpy()
        np.testing.assert_array_equal(got, video[b0 : b0 + 2])
        want = np.asarray(jpipe(jnp.asarray(clip[b0 : b0 + 2]), grain=jnp.asarray(grain), frame=b0))
        _codes(got, want)


def test_dataset_preprocessing_matches_jax(jax_examples):
    jdp = jax_examples["dataset_preprocessing"]
    in_hw, out_hw = (32, 48), (64, 96)
    for a, b in zip(dataset_preprocessing.synthetic_corpus(2, 4, in_hw), jdp.synthetic_corpus(2, 4, in_hw)):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    outs, _, n_dev = dataset_preprocessing.run(2, 2, in_hw, out_hw, devices=[CPU] * 2)
    assert n_dev == 2 and len(outs) == 2
    for i, (out, frames) in enumerate(zip(outs, jdp.synthetic_corpus(2, 4, in_hw))):
        # The outputs stay sharded over the mesh, as the JAX example's do.
        assert isinstance(out, fsr_tpu_torch.Sharded) and out.spec == ("batch", None, None, None)
        assert out.dtype == torch.uint8 and [s.device for s in out.shards] == [CPU] * 2
        want = np.asarray(fsr_tpu.upscale(jnp.asarray(frames), out_size=out_hw, sharpness=0.25, impl="xla",
                                          epilogue=JEpilogue(dither_bits=8), frame=i, out_dtype=jnp.uint8))
        _codes(out.gather().numpy(), want, scale=None)


def test_dataset_preprocessing_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dataset_preprocessing.run(1, 1, (8, 8), (16, 16))
    assert dataset_preprocessing.main([]) == 2


def test_quality_study_matches_jax(jax_examples):
    jqs = jax_examples["quality_study"]
    hw = (128, 128)
    ours, theirs = quality_study.test_images(hw), jqs.test_images(hw)
    assert list(ours) == list(theirs)
    for name in ours:
        np.testing.assert_array_equal(ours[name], theirs[name])
        np.testing.assert_array_equal(quality_study.box_down2(ours[name]), jqs.box_down2(theirs[name]))
    rows = quality_study.study(CPU, hw)
    for (name, *got), ref in zip(rows, theirs.values()):
        low = jnp.asarray(jqs.box_down2(ref))
        con = JEasu.create((low.shape[-1], low.shape[-2]), None, (hw[1], hw[0]))
        want = [jpsnr(np.asarray(jeasu.bilinear(low, hw, con)), ref),
                jpsnr(np.asarray(fsr_tpu.upscale(low, out_size=hw, apply_rcas=False)), ref),
                jpsnr(np.asarray(fsr_tpu.upscale(low, out_size=hw, sharpness=0.25)), ref)]
        np.testing.assert_allclose(got, want, atol=0.01, err_msg=name)
