"""Frame-graph demo: the SampleRenderer::OnRender analog on the card.

Counterpart of ``examples/frame_graph.py``.  The reference's sample
renderer records a frame as a fixed graph of passes with GPU timestamps
around each (SampleRenderer.cpp:398-767 — shadow/PBR render at render
resolution, tonemap (+TEPD when HDR), the "FSR 1.0" upscale, magnifier,
UI, present — profiled in an ImGui window, FSRSample.cpp:767-843).  The
game renderer itself rides Cauldron and is out of scope here; this demo
reproduces the *post-render frame tail* and its orchestration idioms:

- passes are functions run in stream order on the device (the stream
  replaces command-list barriers), and on the card the tail is captured
  once as a CUDA graph and replayed, as the JAX demo jits it
  (``utils/capture.py``; ``--cpu`` runs it eagerly);
- the FSR pass is one kernel launch (K1 at 2x), with tonemap/TEPD
  expressible either as separate passes (this file, for per-pass timing)
  or folded into the kernel prologue/epilogue (UpscalePipeline — the
  production path);
- per-pass device times come from a ``torch.profiler`` trace
  (``utils.profiling.device_trace``), the GPUTimestamps analog, printed as
  the profiler-window table; each pass is named with ``trace_annotation``;
- a camera-jittered synthetic scene stands in for the glTF renderer, and
  the magnifier (``utils.image.magnify``) reproduces the sample's
  pixel-level inspection tool.

    python examples_torch/frame_graph.py            # on the card
    python examples_torch/frame_graph.py --cpu      # no profiler table
"""

from __future__ import annotations

import argparse
import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

_OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_out")


def render_scene(hw, frame: int, jitter: bool = True, seed: int = 0):
    """Synthetic linear-HDR 'scene render' at render resolution.

    Stands in for the shadow/gbuffer/skydome/TAA chain; the sub-pixel
    camera jitter mirrors the TAA-jittered projection the sample applies
    when TAA is on (SampleRenderer.cpp:411-414).
    """
    h, w = hw
    jx = 0.5 * np.sin(2.399963 * frame) if jitter else 0.0  # golden-angle
    jy = 0.5 * np.cos(2.399963 * frame) if jitter else 0.0
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    x = x + jx
    y = y + jy
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (3, h, w)).astype(np.float32) * 0.05
    sky = 4.0 * np.exp(-((y / h - 0.2) ** 2) * 8.0)  # bright HDR sky band
    checks = 0.6 + 0.4 * np.sign(np.sin(x / 9.0) * np.sin(y / 9.0))
    return np.clip(base + (sky * checks)[None], 0.0, 64.0).astype(np.float32)


def frame_tail(hdr: torch.Tensor, display_hw) -> torch.Tensor:
    """The frame tail as named passes (``trace_annotation`` is the
    UserMarker/SetPerfMarker analog): tonemap, then the FSR upscale."""
    from fsr_tpu_torch import api
    from fsr_tpu_torch.core import tonemap as tm
    from fsr_tpu_torch.utils.profiling import trace_annotation

    with trace_annotation("Tonemapping"):
        ldr = tm.tonemap(hdr, exposure=0.7, tonemapper="amd")
    with trace_annotation("FSR 1.0"):
        out = api.upscale(ldr, out_size=display_hw, sharpness=0.25)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the plain-torch path), not the card")
    ap.add_argument("--render", type=int, nargs=2, default=(540, 960), metavar=("H", "W"))
    ap.add_argument("--display", type=int, nargs=2, default=(1080, 1920), metavar=("H", "W"))
    ap.add_argument("--out-dir", default=_OUT_DIR)
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("frame_graph: no CUDA device; pass --cpu", file=sys.stderr)
        return 2
    device = torch.device("cpu" if args.cpu else "cuda")

    from fsr_tpu_torch.utils import image as im

    from fsr_tpu_torch.utils.capture import CapturedFrame

    render_hw, display_hw = tuple(args.render), tuple(args.display)
    frame = 7
    scene = torch.from_numpy(render_scene(render_hw, frame)).to(device)
    run = CapturedFrame(lambda hdr: frame_tail(hdr, display_hw), scene)
    out = run(scene).cpu().numpy()

    print(f"render {render_hw} -> display {display_hw}   (frame {frame}, {device})")
    if device.type == "cuda":
        # Profiler window analog: per-kernel device times from a trace of
        # replays.
        from fsr_tpu_torch.utils.profiling import device_trace

        times = device_trace(lambda: run(scene))["kernels"]
        print(f"{'pass':<40} {'ms':>8}")
        for name, ms in sorted(times.items(), key=lambda kv: -kv[1]):
            print(f"{name[:40]:<40} {ms:>8.4f}")
        print(f"{'TOTAL (device)':<40} {sum(times.values()):>8.4f}")
    else:
        print("no profiler table: device times need a CUDA device (--cpu given)")

    # The production form of this tail is ONE kernel launch (tonemap stays
    # render-res, SRTM/LFGA/TEPD ride the kernel prologue/epilogue: see
    # UpscalePipeline); here, the magnifier, the sample's pixel-inspection
    # tool (MagnifierPS analog).
    mag = im.magnify(out, center=(display_hw[0] // 2, display_hw[1] // 2), zoom=8)
    os.makedirs(args.out_dir, exist_ok=True)
    im.save_image(os.path.join(args.out_dir, "frame_graph_display.png"), np.clip(out, 0, 1))
    im.save_image(os.path.join(args.out_dir, "frame_graph_magnifier.png"), np.clip(mag, 0, 1))
    print(f"wrote {args.out_dir}/frame_graph_display.png (+magnifier)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
