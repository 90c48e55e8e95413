"""Image utilities: layout conversion, 8-bit codecs, metrics, IO, magnifier.

Numpy copy of ``fsr_tpu/utils/image.py``: the byte <-> float codecs (the D3D
UNORM rules the kernels' byte I/O follows: decode v/255, v/1023 for 10-bit
codes; encode floor(sat(x)*255 + 0.5)), PSNR and max-abs, the screenshot
path (SaveTexture -> ``save_image``), and the sample's magnifier
(MagnifierPS -> ``magnify``) used for visual A/B comparison of upscale
modes.  Images are numpy arrays; move them to a device with
``torch.from_numpy(np.ascontiguousarray(img))`` (``load_image`` returns a
view).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "hwc_to_chw", "chw_to_hwc",
    "to_uint8", "from_uint8", "to_uint10", "from_uint10",
    "psnr", "max_abs_error",
    "load_image", "save_image",
    "magnify", "side_by_side",
]


def hwc_to_chw(img: np.ndarray) -> np.ndarray:
    return np.moveaxis(img, -1, -3)


def chw_to_hwc(img: np.ndarray) -> np.ndarray:
    return np.moveaxis(img, -3, -1)


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


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0.0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def max_abs_error(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def load_image(path: str, layout: str = "CHW") -> np.ndarray:
    """Load an image file to float32 {0..1}; PNG/JPEG via PIL, .npy raw.
    With layout="CHW" the result is a view of the HWC pixels."""
    if path.endswith(".npy"):
        img = np.load(path).astype(np.float32)
    else:
        from PIL import Image

        img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    if layout == "CHW" and img.ndim == 3 and img.shape[-1] in (3, 4):
        img = hwc_to_chw(img)
    return img


def save_image(path: str, img: np.ndarray, layout: str = "CHW") -> None:
    """Save float {0..1} image; PNG via PIL, .npy raw (screenshot path)."""
    img = np.asarray(img)
    if path.endswith(".npy"):
        np.save(path, img)
        return
    if layout == "CHW" and img.ndim == 3 and img.shape[0] in (3, 4):
        img = chw_to_hwc(img)
    from PIL import Image

    Image.fromarray(to_uint8(img)).save(path)


def magnify(
    img: np.ndarray,
    center: Tuple[int, int],
    size: int = 32,
    zoom: int = 8,
    layout: str = "CHW",
) -> np.ndarray:
    """Nearest-neighbor zoom of a crop around `center` (y, x) — the
    pixel-level inspection tool (MagnifierPS analog)."""
    if layout == "HWC":
        img = hwc_to_chw(img)
    h, w = img.shape[-2:]
    cy = int(np.clip(center[0], size // 2, h - size // 2))
    cx = int(np.clip(center[1], size // 2, w - size // 2))
    crop = img[..., cy - size // 2 : cy + size // 2, cx - size // 2 : cx + size // 2]
    out = np.repeat(np.repeat(crop, zoom, axis=-2), zoom, axis=-1)
    return chw_to_hwc(out) if layout == "HWC" else out


def side_by_side(*imgs: np.ndarray, pad: int = 4) -> np.ndarray:
    """Concatenate CHW images horizontally with a white separator."""
    h = max(i.shape[-2] for i in imgs)
    parts = []
    for i, img in enumerate(imgs):
        if img.shape[-2] < h:
            padh = h - img.shape[-2]
            img = np.pad(img, [(0, 0)] * (img.ndim - 2) + [(0, padh), (0, 0)])
        parts.append(img)
        if i != len(imgs) - 1:
            parts.append(np.ones(img.shape[:-1] + (pad,), img.dtype))
    return np.concatenate(parts, axis=-1)
