"""Video upscaling: batched fused kernel + temporally-animated dither/grain.

Counterpart of ``examples/video_upscale.py``.  Shows the per-frame temporal
controls the reference exposes (TEPD's frame counter,
FSRTonemapping.h:39-41, and LFGA's temporally-changing grain): a clip is
processed in device batches through ONE kernel launch per batch (frames
are a grid dimension, not a Python loop; grain and the TEPD dither fuse
into K1's store, K5), with the dither pattern advancing per batch so
quantization error is temporally energy-preserving.

    python examples_torch/video_upscale.py          # on the card
    python examples_torch/video_upscale.py --cpu    # the plain-torch path
"""

from __future__ import annotations

import argparse
import os
import sys
import time

if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch


def synthetic_clip(n: int, hw, seed: int = 0):
    """A moving-gradient clip (stand-in for decoded video frames)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = rng.uniform(0, 1, (3, h, w)).astype(np.float32) * 0.1
    frames = []
    for t in range(n):
        wave = 0.45 + 0.45 * np.sin((x + 3.0 * t) / 17.0) * np.cos(y / 11.0)
        frames.append(np.clip(base + wave[None], 0, 1).astype(np.float32))
    return np.stack(frames)


class VideoUpscaler:
    """The clip's frame tail on ``device``: EASU+RCAS, grain 0.15 from a
    fixed texture (seeded), and the 8-bit TEPD dither.  All frames of a
    batch share a dither page (the sample advances its blue-noise page per
    present, frame%8, the same granularity)."""

    def __init__(self, out_hw, device, seed: int = 1):
        import fsr_tpu_torch

        rng = np.random.default_rng(seed)
        self.grain = torch.from_numpy(rng.uniform(-0.5, 0.5, (3, *out_hw)).astype(np.float32)).to(device)
        self.device = torch.device(device)
        self.pipe = fsr_tpu_torch.UpscalePipeline(out_hw, sharpness=0.25, grain_amount=0.15, dither_bits=8)

    def process(self, frames: torch.Tensor, first_index: int) -> torch.Tensor:
        """One batch (B, 3, H, W) on the device: one K1 launch on a card."""
        return self.pipe(frames, grain=self.grain, frame=first_index)

    def run(self, clip: np.ndarray, batch: int) -> np.ndarray:
        """The whole clip, batch by batch, back on the host."""
        outs = []
        for b0 in range(0, clip.shape[0], batch):
            out = self.process(torch.from_numpy(clip[b0 : b0 + batch]).to(self.device), b0)
            outs.append(out.cpu().numpy())
        return np.concatenate(outs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the plain-torch path), not the card")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("video_upscale: no CUDA device; pass --cpu", file=sys.stderr)
        return 2
    device = torch.device("cpu" if args.cpu else "cuda")

    in_hw, out_hw = (270, 480), (540, 960)
    batch = 8
    clip = synthetic_clip(2 * batch, in_hw)
    up = VideoUpscaler(out_hw, device)

    t0 = time.perf_counter()
    video = up.run(clip, batch)  # each batch copied back: synchronised
    dt = time.perf_counter() - t0
    assert video.shape == (2 * batch, 3, *out_hw)
    # Temporal energy preservation: averaging the dithered gamma-2 frames in
    # linear space approaches the undithered signal.
    mean_err = abs(float(np.mean(video[:batch] ** 2) - np.mean(video[batch:] ** 2)))
    print(
        f"{video.shape[0]} frames {in_hw}->{out_hw} on {device} in {dt:.2f}s "
        f"({video.shape[0]/dt:.1f} fps incl. transfers); batch-energy drift {mean_err:.2e}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
