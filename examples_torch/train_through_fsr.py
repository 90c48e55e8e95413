"""Training THROUGH the upscaler: FSR as a differentiable layer (PyTorch).

Counterpart of ``examples/train_through_fsr.py``.  The reference is a
forward-only shader; the port carries gradients (the bit tricks' ideal
derivatives, and on the card the kernel forward with the torch twin's
backward, ``fsr_tpu_torch.autodiff``), so a loss can be measured on the
*post-FSR displayed frame*.  On a CUDA tensor each ``upscale`` is one K1
launch forward; the backward launches no kernel.

Two demos:

  inverse   (default)  Gradient-descend the low-res *render itself* so that
                       ``upscale(render)`` matches a high-res target: "what
                       should the game render so that the displayed frame is
                       closest to the ground truth".
  prefilter            Train a 5x5 conv pre-filter F (identity-initialised)
                       on *blurred* renders so that ``upscale(F(blurred))``
                       approaches the sharp target: a learned deblur stage in
                       front of FSR.

    python examples_torch/train_through_fsr.py [inverse|prefilter] [--steps N]
    python examples_torch/train_through_fsr.py --cpu   # the CPU, plain torch path

Exit code 0 when the trained loss beats the baseline (inverse: below 0.9
times the box-downsample baseline; prefilter: below the unfiltered one).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import fsr_tpu_torch  # noqa: E402
from fsr_tpu_torch.utils import capture  # noqa: E402


def make_scene(rng, hw, noise=0.0):
    """Procedural high-res ground truth: soft gradients + hard edges (the
    content classes EASU treats differently).  ``noise`` adds per-pixel
    texture that a half-res render cannot reproduce: an irreducible floor
    on any displayed-frame MSE."""
    h, w = hw
    yy, xx = np.meshgrid(np.arange(h) / h, np.arange(w) / w, indexing="ij")
    base = np.stack([
        0.5 + 0.35 * np.sin(6.0 * xx + 2.0 * yy),
        0.5 + 0.35 * np.cos(4.0 * yy),
        0.5 + 0.35 * np.sin(3.0 * (xx + yy)),
    ])
    for _ in range(24):
        c = rng.uniform(0.1, 0.9)
        y0, x0 = rng.integers(0, h - 16), rng.integers(0, w - 16)
        hh, ww = rng.integers(4, 16), rng.integers(4, 16)
        base[:, y0:y0 + hh, x0:x0 + ww] = c
    if noise:
        base += noise * rng.standard_normal((3, h, w))
    return np.clip(base, 0.02, 0.98).astype(np.float32)


def downsample(img, q=2):
    """Box-filtered render at 1/q resolution (the "game render")."""
    c, h, w = img.shape
    return img.reshape(c, h // q, q, w // q, q).mean(axis=(2, 4))


def gaussian_blur(img, sigma=0.8):
    """Separable gaussian: stands in for TAA's temporal softening, the
    degradation the reference's integration guide flags on FSR inputs."""
    r = 2
    xs = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k /= k.sum()
    out = np.apply_along_axis(lambda v: np.convolve(np.pad(v, r, mode="edge"), k, "valid"), 1, img)
    out = np.apply_along_axis(lambda v: np.convolve(np.pad(v, r, mode="edge"), k, "valid"), 2, out)
    return out.astype(np.float32)


def displayed_mse(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """MSE of the displayed frame ``upscale(lo, scale=2)`` against ``hi``."""
    return torch.mean((fsr_tpu_torch.upscale(lo, scale=2.0) - hi) ** 2)


def _adam(params, lr: float) -> torch.optim.Adam:
    """Adam on ``params``; on a card ``capturable``, so that its step can be
    captured (``capture.CapturedStep``) and an eager step runs the same
    update."""
    return torch.optim.Adam(params, lr=lr, capturable=params[0].device.type == "cuda")


class Inverse:
    """The inverse problem: Adam on the render ``lo``, kept in [0, 1]."""

    def __init__(self, hi: torch.Tensor, lr: float):
        self.hi = hi
        self.lo = torch.from_numpy(downsample(hi.cpu().numpy())).to(hi.device).requires_grad_()
        self.params = [self.lo]
        self.opt = _adam(self.params, lr)

    def loss(self) -> float:
        """The displayed MSE at the current render."""
        with torch.no_grad():
            return float(displayed_mse(self.lo, self.hi))

    def step(self) -> torch.Tensor:
        """One Adam step; returns the displayed MSE before it as a 0-d
        tensor, with no host sync (the caller floats it where it prints)."""
        self.opt.zero_grad()
        loss = displayed_mse(self.lo, self.hi)
        loss.backward()
        self.opt.step()
        with torch.no_grad():
            self.lo.clamp_(0.0, 1.0)
        return loss.detach()


def prefilter_scenes(rng, size: int):
    """The prefilter demo's four frames: blurred renders (4, 3, size, 2
    size) and their sharp targets (4, 3, 2 size, 4 size), float32."""
    frames_hi = [make_scene(rng, (size * 2, size * 4), noise=0.02) for _ in range(4)]
    frames_lo = [gaussian_blur(downsample(f)) for f in frames_hi]
    return np.stack(frames_lo), np.stack(frames_hi)


class Prefilter:
    """The prefilter problem: Adam on one linear 5x5 conv (``k``, ``b``),
    identity-initialised (a delta kernel), in front of the upscale of the
    blurred renders ``lo`` (N, 3, h, w), against ``hi``."""

    def __init__(self, lo: torch.Tensor, hi: torch.Tensor, lr: float):
        self.lo, self.hi = lo, hi  # batch dims ride through upscale natively
        k = torch.zeros((3, 3, 5, 5), device=lo.device)
        for c in range(3):
            k[c, c, 2, 2] = 1.0
        self.k = k.requires_grad_()
        self.b = torch.zeros((3,), device=lo.device, requires_grad=True)
        self.params = [self.k, self.b]
        self.opt = _adam(self.params, lr)

    def _loss(self) -> torch.Tensor:
        filt = F.conv2d(self.lo, self.k, self.b, padding=2)
        shown = fsr_tpu_torch.upscale(torch.clamp(filt, 0.0, 1.0), scale=2.0)
        return torch.mean((shown - self.hi) ** 2)

    def loss(self) -> float:
        """The displayed MSE at the current filter."""
        with torch.no_grad():
            return float(self._loss())

    def step(self) -> torch.Tensor:
        """One Adam step; returns the loss before it as a 0-d tensor, with
        no host sync."""
        self.opt.zero_grad()
        loss = self._loss()
        loss.backward()
        self.opt.step()
        return loss.detach()


def _train(prob, steps: int, what: str) -> None:
    """``steps`` steps of ``prob``, captured as one graph on a card and
    eager on the CPU (``capture.CapturedStep``); the loss is read on the
    host only at the steps it prints, as the JAX example reads it."""
    step = capture.CapturedStep(prob.step, prob.params, prob.opt)
    for i in range(steps):
        loss = step()
        if i % 50 == 0 or i == steps - 1:
            print(f"step {i:4d}  {what} {float(loss):.4e}")


def run_inverse(args, rng, device) -> int:
    hi = torch.from_numpy(make_scene(rng, (args.size * 2, args.size * 4))).to(device)
    prob = Inverse(hi, args.lr)
    base = prob.loss()
    print(f"baseline (box downsample) displayed MSE: {base:.4e}")
    _train(prob, args.steps, "displayed MSE")
    final = prob.loss()
    print(f"optimized render MSE: {final:.4e}  ({base / final:.1f}x lower)")
    return 0 if final < 0.9 * base else 1


def run_prefilter(args, rng, device) -> int:
    lo, hi = (torch.from_numpy(a).to(device) for a in prefilter_scenes(rng, args.size))
    prob = Prefilter(lo, hi, args.lr)
    with torch.no_grad():
        base = float(torch.mean((fsr_tpu_torch.upscale(lo, scale=2.0) - hi) ** 2))
    print(f"baseline (blurred, no prefilter) MSE: {base:.4e}")
    _train(prob, args.steps, "loss")
    final = prob.loss()
    print(f"trained deblur prefilter MSE:         {final:.4e} ({(1 - final / base) * 100:.1f}% lower)")
    return 0 if final < base else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", nargs="?", default="inverse", choices=("inverse", "prefilter"))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--size", type=int, default=96, help="low-res height")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the plain torch path), not the card")
    args = ap.parse_args(argv)
    if args.lr is None:
        args.lr = 3e-3 if args.mode == "inverse" else 1e-3
    if not args.cpu and not torch.cuda.is_available():
        print("train_through_fsr: no CUDA device; pass --cpu", file=sys.stderr)
        return 2
    device = torch.device("cpu" if args.cpu else "cuda")

    rng = np.random.default_rng(0)
    if args.mode == "inverse":
        return run_inverse(args, rng, device)
    return run_prefilter(args, rng, device)


if __name__ == "__main__":
    raise SystemExit(main())
