"""FSRSample application analog: config-driven demo + benchmark flythrough.

Counterpart of ``examples/sample_app.py``.  The reference ships a full
sample application around the FSR passes (sample/src/DX12/FSRSample.{h,cpp})
whose L3 behaviors are:

- two-level JSON configuration — a config file plus a JSON override string
  on the command line (OnParseCommandLine, FSRSample.cpp:46-126);
- scenes with "BenchmarkSettings": a keyframed camera flythrough with
  warm-up frames, a per-frame results CSV and screenshots at keyframes
  (FSRSample.json:33-56, driven by Cauldron's BenchmarkLoop);
- upscale modes {fsr, bilinear, native} and the quality presets with the
  sample's per-preset mip-bias defaults (FSRSample.h:79-97,
  FSRSample.cpp:34-38);
- the per-frame graph: scene render at render resolution -> tonemap
  (+TEPD 10-bit dither when HDR, FSR_Tonemapping.hlsl:86-88) -> the
  "FSR 1.0" upscale to display resolution -> magnifier
  (SampleRenderer.cpp:398-767);
- a per-pass profiler table from GPU timestamps (FSRSample.cpp:767-843).

This module reproduces all of that on the card.  The glTF/Cauldron game
renderer is replaced by a procedural camera-driven scene in torch ops on
the device.  The frame (scene, tonemap, upscale; the FSR pass one K1 or K2
launch, K2 at the default Quality preset) is captured once as a CUDA graph
when the app is built and replayed per frame, with the camera and the frame
index as its inputs: the counterpart of the JAX sample's ``jax.jit`` of its
frame tail (``utils/capture.py``).  ``--cpu`` runs the same frame eagerly
on the CPU (the plain-torch path) and prints no profiler table.

    python examples_torch/sample_app.py --benchmark            # flythrough + CSV
    python examples_torch/sample_app.py                        # one frame + profile
    python examples_torch/sample_app.py --config my.json \\
        --override '{"globals": {"preset": "balanced"}}'
"""

from __future__ import annotations

import argparse
import copy
import csv
import json
import os
import sys
import time

if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

_OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_out")

# Default config, mirroring the structure of sample/src/Common/FSRSample.json
# (globals + scenes[], each scene optionally carrying BenchmarkSettings with
# keyframes, warm-up and result-file names).
DEFAULT_CONFIG = {
    "globals": {
        "width": 1920,
        "height": 1080,
        "mode": "fsr",            # State::m_nUpscaleType {fsr,bilinear,native}
        "preset": "quality",      # FSRSample.h:79-93
        "sharpness": 0.25,        # rcasAttenuation default, SampleRenderer.h:49
        "rcas": True,             # bUseRcas default
        "hdr": False,             # freesyncHDR analog: TEPD10 + gamma2 chain
        "vsync": False,
    },
    "scenes": [
        {
            "name": "ProceduralFlyover",
            "exposure": 0.85,
            "toneMapper": "amd",
            "BenchmarkSettings": {
                "timeStart": 0.0,
                "timeEnd": 2.0,
                "fps": 12,
                "warmUpFrames": 4,   # FSRSample.json warmUpFrames analog
                "resultsFilename": os.path.join(_OUT_DIR, "benchmark.csv"),
                "screenShotName": os.path.join(_OUT_DIR, "shot"),
                "keyFrames": [
                    {"time": 0.0, "cy": 0.52, "cx": 0.34, "zoom": 1.0,
                     "screenShot": True},
                    {"time": 1.0, "cy": 0.46, "cx": 0.50, "zoom": 1.7},
                    {"time": 2.0, "cy": 0.55, "cx": 0.66, "zoom": 2.4,
                     "screenShot": True},
                ],
            },
        }
    ],
}


def merge_config(base: dict, override: dict) -> dict:
    """Recursive JSON merge — the OnParseCommandLine override semantics
    (FSRSample.cpp:60-126: the command-line JSON wins key-by-key)."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_config(out[k], v)
        elif isinstance(v, list) and isinstance(out.get(k), list):
            out[k] = [
                merge_config(a, b) if isinstance(a, dict) and isinstance(b, dict)
                else copy.deepcopy(b)
                for a, b in zip(out[k], v)
            ] + copy.deepcopy(out[k][len(v):] if len(out[k]) > len(v) else v[len(out[k]):])
        else:
            out[k] = copy.deepcopy(v)
    return out


def camera_at(keyframes, t: float) -> dict:
    """Linear keyframe interpolation (the BenchmarkLoop camera sequence)."""
    kfs = sorted(keyframes, key=lambda k: k["time"])
    if t <= kfs[0]["time"]:
        return kfs[0]
    for a, b in zip(kfs, kfs[1:]):
        if t <= b["time"]:
            u = (t - a["time"]) / max(b["time"] - a["time"], 1e-9)
            return {
                k: (1 - u) * a[k] + u * b[k] for k in ("cy", "cx", "zoom")
            }
    return kfs[-1]


def render_scene(hw, cam, frame_f):
    """Procedural linear-HDR scene at render resolution, camera-driven.

    Stands in for the shadow/gbuffer/skydome chain; world-space coordinates
    make camera pans/zooms resolution-independent, and the golden-angle
    sub-pixel jitter mirrors the TAA-jittered projection
    (SampleRenderer.cpp:411-414).  cam = (cy, cx, zoom) and frame_f are
    float32 0-d tensors on the device the scene is rendered on.
    """
    h, w = hw
    cy, cx, zoom = cam
    dev = frame_f.device
    jx = 0.5 * torch.sin(2.399963 * frame_f) / w  # golden-angle TAA jitter
    jy = 0.5 * torch.cos(2.399963 * frame_f) / h
    # World coordinates: the visible window is 1/zoom wide, centered at cam.
    u = cx + ((torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w - 0.5 + jx) / zoom
    v = cy + (((torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h - 0.5 + jy)
              * (h / w)) / zoom
    u, v = u[None, :], v[:, None]
    # Sky: bright HDR band + sun disc (drives SRTM/tonemap range).
    sky = 3.0 * torch.exp(-((v - 0.18) ** 2) * 40.0)
    sun = 24.0 * torch.exp(-(((u - 0.62) ** 2 + (v - 0.14) ** 2)) * 3000.0)
    # Ground: high-frequency checks (the content FSR's edge adaptivity and
    # RCAS are judged on) + a dim base gradient.
    checks = 0.55 + 0.45 * torch.sign(torch.sin(u * 110.0) * torch.sin(v * 110.0))
    fine = 0.5 + 0.5 * torch.sin(u * 700.0) * torch.sin(v * 700.0)
    ground = checks * (0.25 + 0.5 * fine) * torch.clamp((v - 0.3) * 3.0, 0.0, 1.0)
    # Emissive spheres.
    blobs = (
        2.0 * torch.exp(-(((u - 0.45) ** 2 + (v - 0.55) ** 2)) * 900.0)
        + 1.2 * torch.exp(-(((u - 0.58) ** 2 + (v - 0.62) ** 2)) * 1600.0)
    )
    r = sky * 0.9 + sun + ground * 0.9 + blobs * 1.0
    g = sky * 0.95 + sun + ground * 0.8 + blobs * 0.6
    b = sky * 1.1 + sun + ground * 0.6 + blobs * 0.3
    return torch.clamp(torch.stack([r, g, b]), 0.0, 64.0)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SampleApp:
    """FSRSample analog: owns the frame graph for one (mode, preset) state
    on ``device`` (default: the CUDA device; raises when there is none).

    Like the sample, a mode/preset change rebuilds the size-dependent state
    (RefreshRenderResolution + OnCreateWindowSizeDependentResources,
    FSRSample.cpp:229): here that is a new ``SampleApp``.  Building it
    captures the frame (``frame_tail``) as one CUDA graph on a CUDA device
    (``utils.capture.CapturedFrame``, which calls it eagerly on the CPU),
    and ``render_frame`` replays it.
    """

    def __init__(self, cfg: dict, device=None):
        from fsr_tpu_torch import api
        from fsr_tpu_torch.core.constants import EasuConstants
        from fsr_tpu_torch.core.presets import PRESETS, render_resolution

        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("SampleApp found no CUDA device; pass device='cpu'")
            device = "cuda"
        self.device = torch.device(device)
        g = cfg["globals"]
        scene = cfg["scenes"][0]
        self.cfg = cfg
        self.scene = scene
        self.mode = g["mode"]
        self.preset = PRESETS[g["preset"]]
        self.display_hw = (int(g["height"]), int(g["width"]))
        self.render_hw = (
            self.display_hw if self.mode == "native"
            else render_resolution(self.display_hw, self.preset.scale)
        )
        self.hdr = bool(g.get("hdr", False))
        self.exposure = float(scene.get("exposure", 1.0))
        self.tonemapper = scene.get("toneMapper", "amd")

        self.pipe = None
        if self.mode == "fsr":
            # HDR chain: tonemap+TEPD10 writes gamma-2.0 codes (the RGB10A2
            # render target); FSR consumes them and squares back to linear
            # (the shader's Sample.x==1 path, FSR_Pass.hlsl:78-79).
            self.pipe = api.UpscalePipeline(
                self.display_hw,
                sharpness=float(g.get("sharpness", 0.25)),
                apply_rcas=bool(g.get("rcas", True)),
                gamma2_out=self.hdr,
            )
        self.bil_con = EasuConstants.create(
            (self.render_hw[1], self.render_hw[0]),
            None,
            (self.display_hw[1], self.display_hw[0]),
        )
        from fsr_tpu_torch.utils.capture import CapturedFrame

        inputs = self.frame_inputs({"cy": 0.5, "cx": 0.5, "zoom": 1.0}, 0)
        self._run = CapturedFrame(self.frame_tail, *(x.to(self.device) for x in inputs))

    @staticmethod
    def frame_inputs(cam: dict, frame: int):
        """The frame's inputs on the host, as the JAX sample passes them
        (examples/sample_app.py:233-234): the camera (cy, cx, zoom) as a (3,)
        float32 tensor, the frame index as a float32 and an int32 0-d tensor."""
        return (torch.tensor([cam[k] for k in ("cy", "cx", "zoom")], dtype=torch.float32),
                torch.tensor(frame, dtype=torch.float32), torch.tensor(frame, dtype=torch.int32))

    def frame_tail(self, cam: torch.Tensor, frame_f: torch.Tensor, frame_i: torch.Tensor) -> torch.Tensor:
        """One frame of the graph, eagerly, from ``frame_inputs`` on the
        app's device (not synchronised): what the captured graph records,
        and the ``--cpu`` frame.  Reads no device value back to the host."""
        from fsr_tpu_torch.core import tonemap as tm
        from fsr_tpu_torch.ops import easu as easu_ops
        from fsr_tpu_torch.utils.profiling import trace_annotation

        with trace_annotation("Scene render"):
            hdr_img = render_scene(self.render_hw, tuple(cam), frame_f)
        with trace_annotation("Tonemapping"):
            ldr = tm.tonemap_pass(
                hdr_img, self.exposure, self.tonemapper,
                hdr10_dither_frame=frame_i if self.hdr else None,
            )
        if self.mode == "bilinear":
            with trace_annotation("Upscale (bilinear)"):
                return easu_ops.bilinear(ldr, self.display_hw, self.bil_con)
        if self.mode == "native":
            return ldr
        with trace_annotation("FSR 1.0"):
            return self.pipe(ldr, frame=frame_i)

    def render_frame(self, cam: dict, t: float, frame: int) -> torch.Tensor:
        """One frame, on the device (not synchronised): on the card a replay
        of the captured frame, whose output tensor the next frame overwrites
        (clone what you keep); on the CPU ``frame_tail``, called eagerly."""
        return self._run(*self.frame_inputs(cam, frame))

    def profile(self, cam: dict, frame: int = 0) -> dict:
        """Per-kernel device ms of one frame — the GPUTimestamps profiler
        table, from a ``torch.profiler`` trace of replays (needs a CUDA
        device)."""
        from fsr_tpu_torch.utils.profiling import device_trace

        return device_trace(lambda: self.render_frame(cam, 0.0, frame))["kernels"]


def run_benchmark(app: SampleApp, bench: dict) -> list:
    """BenchmarkLoop analog: keyframed flythrough with warm-up, per-frame
    CSV rows and screenshots at keyframes (FSRSample.cpp:871-877).  Each
    frame's clock stops after the device has finished it.  A screenshot
    copies the frame to the host before the next replay overwrites it."""
    from fsr_tpu_torch.utils import image as im

    kfs = bench["keyFrames"]
    fps = float(bench.get("fps", 12))
    t0, t1 = float(bench["timeStart"]), float(bench["timeEnd"])
    n = max(int(round((t1 - t0) * fps)) + 1, 1)
    warm = int(bench.get("warmUpFrames", 0))

    # Warm-up frames (allocator, clocks), not timed — warmUpFrames analog.
    for i in range(warm):
        app.render_frame(camera_at(kfs, t0), t0, i)
    _sync(app.device)

    shot_times = {k["time"] for k in kfs if k.get("screenShot")}
    rows, shots = [], 0
    for i in range(n):
        t = t0 + (t1 - t0) * (i / max(n - 1, 1))
        cam = camera_at(kfs, t)
        w0 = time.perf_counter()
        out = app.render_frame(cam, t, i)
        _sync(app.device)
        ms = (time.perf_counter() - w0) * 1e3
        rows.append({"frame": i, "time": round(t, 4), "ms": round(ms, 4)})
        if any(abs(t - st) < 0.5 / fps for st in shot_times):
            name = f"{bench['screenShotName']}_{shots}.png"
            os.makedirs(os.path.dirname(name) or ".", exist_ok=True)
            im.save_image(name, np.clip(out.to(torch.float32).cpu().numpy(), 0, 1))
            rows[-1]["screenshot"] = os.path.basename(name)
            shots += 1
    if bench.get("resultsFilename"):
        path = bench["resultsFilename"]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", newline="") as f:
            wr = csv.DictWriter(f, ["frame", "time", "ms", "screenshot"])
            wr.writeheader()
            wr.writerows(rows)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", help="JSON config file (FSRSample.json analog)")
    p.add_argument("--override", help="JSON override string "
                   "(the sample's command-line JSON)")
    p.add_argument("--benchmark", action="store_true",
                   help="run the keyframed flythrough + CSV")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain-torch path), not the card")
    args = p.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("sample_app: no CUDA device; pass --cpu", file=sys.stderr)
        return 2

    cfg = DEFAULT_CONFIG
    if args.config:
        with open(args.config) as f:
            cfg = merge_config(cfg, json.load(f))
    if args.override:
        cfg = merge_config(cfg, json.loads(args.override))

    from fsr_tpu_torch.core.presets import recommended_mip_bias
    from fsr_tpu_torch.utils import image as im

    app = SampleApp(cfg, device="cpu" if args.cpu else "cuda")
    print(
        f"mode={app.mode} preset={app.preset.name} ({app.preset.scale}x) "
        f"render {app.render_hw} -> display {app.display_hw}  hdr={app.hdr}  device={app.device}"
    )
    print(
        f"mip bias: sample default {app.preset.mip_bias:+.3f}, "
        f"doc-recommended {recommended_mip_bias(app.preset.scale):+.3f} "
        "(PDF p.24 / FSRSample.cpp:34-38)"
    )

    scene = cfg["scenes"][0]
    bench = scene.get("BenchmarkSettings")
    if args.benchmark and bench:
        rows = run_benchmark(app, bench)
        ms = [r["ms"] for r in rows]
        print(
            f"benchmark '{scene['name']}': {len(rows)} frames, wall median "
            f"{np.median(ms):.3f} ms, min {min(ms):.3f} ms -> "
            f"{bench['resultsFilename']}"
        )
        return 0

    # Single-frame mode: profiler table + display/magnifier images
    # (the sample's default interactive view + ImGui profiler window).
    kfs = bench["keyFrames"] if bench else [
        {"time": 0, "cy": 0.5, "cx": 0.5, "zoom": 1.0}]
    cam = camera_at(kfs, kfs[0]["time"])
    out = app.render_frame(cam, 0.0, 0).to(torch.float32).cpu().numpy()
    if app.device.type == "cuda":
        times = app.profile(cam)
        print(f"{'kernel':<44} {'ms':>8}")
        top = sorted(times.items(), key=lambda kv: -kv[1])[:12]
        for name, t in top:
            print(f"{name[:44]:<44} {t:>8.4f}")
        print(f"{'TOTAL (device)':<44} {sum(times.values()):>8.4f}")
    else:
        print("no profiler table: device times need a CUDA device (--cpu given)")
    os.makedirs(_OUT_DIR, exist_ok=True)
    im.save_image(os.path.join(_OUT_DIR, "sample_display.png"),
                  np.clip(out, 0, 1))
    mag = im.magnify(out, (app.display_hw[0] // 2, app.display_hw[1] // 2),
                     zoom=8)
    im.save_image(os.path.join(_OUT_DIR, "sample_magnifier.png"),
                  np.clip(mag, 0, 1))
    print(f"wrote {_OUT_DIR}/sample_display.png (+magnifier)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
