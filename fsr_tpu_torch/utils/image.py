"""Byte <-> float codecs (numpy copy of the codecs in ``fsr_tpu/utils/image.py``).

The D3D UNORM rules the kernels' byte I/O follows: decode v/255 (v/1023 for
10-bit codes), encode floor(sat(x)*255 + 0.5).  Image files and the CLI
come with their slice.
"""

from __future__ import annotations

import numpy as np

__all__ = ["to_uint8", "from_uint8", "to_uint10", "from_uint10"]


def to_uint8(img: np.ndarray) -> np.ndarray:
    """float {0..1} -> uint8, D3D UNORM rule: floor(sat(x)*255 + 0.5)."""
    x = np.clip(np.nan_to_num(np.asarray(img, np.float32)), 0.0, 1.0)
    return np.floor(x * 255.0 + 0.5).astype(np.uint8)


def from_uint8(img: np.ndarray) -> np.ndarray:
    return np.asarray(img, np.float32) * np.float32(1.0 / 255.0)


def to_uint10(img: np.ndarray) -> np.ndarray:
    x = np.clip(np.nan_to_num(np.asarray(img, np.float32)), 0.0, 1.0)
    return np.floor(x * 1023.0 + 0.5).astype(np.uint16)


def from_uint10(img: np.ndarray) -> np.ndarray:
    return np.asarray(img, np.float32) * np.float32(1.0 / 1023.0)
