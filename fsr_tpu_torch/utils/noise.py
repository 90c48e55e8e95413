"""Blue-noise dither texture generation (void-and-cluster); numpy copy of
``fsr_tpu/utils/noise.py``.

The reference sample dithers its HDR tonemap output with a 128x128x64
temporal blue-noise texture, page-indexed by frame
(sample/src/DX12/FSR_Tonemapping.hlsl:86-88, loaded from disk at
SampleRenderer.cpp:122).  The texture asset itself is not in the snapshot,
so this module *generates* equivalent textures with the classic
void-and-cluster method (Ulichney 1993): iteratively place samples at the
location least covered by a toroidal Gaussian energy field, producing the
even isotropic distribution that makes blue noise visually quieter than
white noise or ordered dithers at the same bit depth.

Textures are generated once on the host (numpy) and reused; pass the result
to UpscalePipeline(dither_texture=...) or ops.extras.texture_dither.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

__all__ = ["blue_noise", "temporal_blue_noise"]


def _energy_kernel(h: int, w: int, sigma: float) -> np.ndarray:
    """Toroidal Gaussian energy footprint centered at (0, 0)."""
    y = np.arange(h, dtype=np.float64)
    x = np.arange(w, dtype=np.float64)
    dy = np.minimum(y, h - y)[:, None]
    dx = np.minimum(x, w - x)[None, :]
    return np.exp(-(dy * dy + dx * dx) / (2.0 * sigma * sigma))


@functools.lru_cache(maxsize=8)
def _blue_noise_ranks(h: int, w: int, seed: int, sigma: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = h * w
    kern = _energy_kernel(h, w, sigma)

    # Phase 0: random initial pattern, relaxed so samples are evenly spread.
    count = max(1, n // 10)
    placed = np.zeros((h, w), bool)
    idx = rng.choice(n, count, replace=False)
    placed[np.unravel_index(idx, (h, w))] = True
    energy = np.zeros((h, w))
    for (py, px) in np.argwhere(placed):
        energy += np.roll(np.roll(kern, py, 0), px, 1)
    for _ in range(10 * count):
        # Move the tightest-cluster sample into the largest void.
        masked = np.where(placed, energy, -np.inf)
        cy, cx = np.unravel_index(np.argmax(masked), (h, w))
        energy -= np.roll(np.roll(kern, cy, 0), cx, 1)
        placed[cy, cx] = False
        voidm = np.where(placed, np.inf, energy)
        vy, vx = np.unravel_index(np.argmin(voidm), (h, w))
        if (vy, vx) == (cy, cx):  # converged: cluster == void
            energy += np.roll(np.roll(kern, cy, 0), cx, 1)
            placed[cy, cx] = True
            break
        placed[vy, vx] = True
        energy += np.roll(np.roll(kern, vy, 0), vx, 1)

    ranks = np.full((h, w), -1, np.int64)
    # Phase 1: rank the initial samples by removing tightest clusters.
    pat = placed.copy()
    en = energy.copy()
    for r in range(count - 1, -1, -1):
        masked = np.where(pat, en, -np.inf)
        cy, cx = np.unravel_index(np.argmax(masked), (h, w))
        pat[cy, cx] = False
        en -= np.roll(np.roll(kern, cy, 0), cx, 1)
        ranks[cy, cx] = r
    # Phase 2: fill the remaining ranks into the largest voids.
    pat = placed.copy()
    en = energy.copy()
    for r in range(count, n):
        voidm = np.where(pat, np.inf, en)
        vy, vx = np.unravel_index(np.argmin(voidm), (h, w))
        pat[vy, vx] = True
        en += np.roll(np.roll(kern, vy, 0), vx, 1)
        ranks[vy, vx] = r
    return ranks


def blue_noise(shape: Tuple[int, int] = (128, 128), seed: int = 0,
               sigma: float = 1.9) -> np.ndarray:
    """A (H, W) float32 blue-noise dither texture with values in [0, 1).

    Every value k/(H*W) appears exactly once (a complete threshold ramp),
    ordered so that any threshold slice is an even, isotropic point set.
    """
    h, w = shape
    ranks = _blue_noise_ranks(int(h), int(w), int(seed), float(sigma))
    return (ranks.astype(np.float32) + np.float32(0.5)) / np.float32(h * w)


def temporal_blue_noise(pages: int = 8, shape: Tuple[int, int] = (128, 128),
                        seed: int = 0) -> np.ndarray:
    """(pages, H, W) stack of independent blue-noise pages (the analog of the
    sample's 128x128x64 temporal texture; page-index by frame)."""
    return np.stack([blue_noise(shape, seed=seed + 7919 * p) for p in range(pages)])
