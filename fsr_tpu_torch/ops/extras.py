"""SRTM / LFGA / TEPD auxiliary passes (plain torch, dtype-generic).

Counterpart of ``fsr_tpu/ops/extras.py``, op for op in the same order.
References: FsrSrtm* (ffx_fsr1.h:1043-1055), FsrLfga* (ffx_fsr1.h:1014-1023),
FsrTepdDit/C8/C10 (ffx_fsr1.h:1086-1121).  These are the torch path's
post-ops, the kernels' plain epilogue (``kernels/epilogue.apply``) and
``UpscalePipeline``'s dither after-pass.

Constants are float32 values held as Python floats, so that an operation
with a float32 tensor computes with exactly the float32 constant the JAX
package and the CUDA kernels use.
"""

from __future__ import annotations

import numpy as np
import torch

from fsr_tpu_torch.core import approx

__all__ = [
    "frame_index",
    "srtm",
    "srtm_inv",
    "lfga",
    "tepd_dither",
    "texture_dither",
    "select_page",
    "tepd_quantize",
]

# Golden-ratio ordered dither constants (FsrTepdDitF, ffx_fsr1.h:1086-1094).
DIT_A = float(np.float32((1.0 + np.sqrt(np.float64(5.0))) / 2.0))
DIT_B = float(np.float32(1.0 / 3.69))
_U32 = 1 << 32


def frame_index(frame, device=None):
    """The temporal frame index as the dither functions and the kernels take
    it: a Python int, or a 0-d int32 tensor on ``device`` (default the CPU),
    JAX's traced ``frame`` (``jnp.asarray(frame, jnp.int32)``).

    An integer tensor on ``device`` is used as it stands (a wider one is cast
    to int32 there, wrapping as JAX's cast does), so that a frame on the card
    costs no host read and a captured graph reads it at replay; a tensor on
    the CPU is read as a host int; a tensor on another device raises."""
    if not isinstance(frame, torch.Tensor):
        return int(frame)
    if frame.numel() != 1 or frame.dtype.is_floating_point or frame.dtype.is_complex or frame.dtype == torch.bool:
        raise ValueError(f"frame must be an integer scalar, got a {frame.dtype} tensor of shape {tuple(frame.shape)}")
    device = torch.device("cpu") if device is None else torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if frame.device == device:
        return frame.reshape(()).to(torch.int32)
    if frame.device.type == "cpu":
        return int(frame)
    raise ValueError(f"frame lies on {frame.device}, the image on {device}: pass it on the image's device or as an int")


def _max3(c):
    return torch.maximum(torch.maximum(c[..., 0, :, :], c[..., 1, :, :]), c[..., 2, :, :])


def srtm(c: torch.Tensor) -> torch.Tensor:
    """Reversible tonemap: HDR {0..fp16max} -> {0..1}; c *= rcp(max3(c)+1)."""
    return c * approx.rcp(_max3(c) + 1.0)[..., None, :, :]


def srtm_inv(c: torch.Tensor) -> torch.Tensor:
    """Inverse tonemap: {0..1} -> {0..32768}; guard at c==1 (ffx_fsr1.h:1044)."""
    den = torch.clamp(1.0 - _max3(c), min=1.0 / 32768.0)
    return c * approx.rcp(den)[..., None, :, :]


def lfga(c: torch.Tensor, grain: torch.Tensor, amount) -> torch.Tensor:
    """Film grain limited by distance to signal limits (energy preserving).

    grain: broadcastable to c (3-channel, {-0.5..0.5}); amount: scalar {0..1}.
    """
    a = float(torch.tensor(float(amount), dtype=c.dtype))
    return c + (grain.to(c.dtype) * a) * torch.minimum(1.0 - c, c)


def tepd_dither(shape, frame, origin=(0, 0), device=None) -> torch.Tensor:
    """Golden-ratio ordered dither positions, {0..<1} (FsrTepdDitF), float32.

    shape: (H, W); frame: temporal frame index, an int or an integer tensor
    (``frame_index``); origin: (row0, col0) global coordinate of the top-left
    pixel.  Coordinates wrap as uint32, as the JAX version's do; the
    reference notes only 32-bit has enough precision (ffx_fsr1.h:1084).
    """
    h, w = shape
    r0, c0 = (int(v) for v in origin)
    cols = (torch.arange(w, device=device) + c0 + frame_index(frame, device)) % _U32
    rows = (torch.arange(h, device=device) + r0) % _U32
    x = cols.to(torch.float32)[None, :]
    y = rows.to(torch.float32)[:, None]
    v = x * DIT_A + (y * DIT_B)
    return v - torch.floor(v)


def texture_dither(shape, frame, texture, origin=(0, 0)) -> torch.Tensor:
    """Dither positions from a texture (the sample's temporal blue noise,
    FSR_Tonemapping.hlsl:86-88; make one with
    ``fsr_tpu_torch.utils.noise.temporal_blue_noise``).

    shape: output (H, W); frame: temporal index, an int or an integer
    tensor (``frame_index``); texture: (pages, th, tw) or (th, tw) with
    values in [0, 1), on the device of the result.  The page is selected by
    frame mod pages (``page``) and tiled over the output: position (y, x)
    reads page[(y + row0) % th, (x + col0) % tw].
    """
    h, w = shape
    tex = torch.as_tensor(texture)
    if tex.dim() == 2:
        tex = tex[None]
    _, th, tw = tex.shape
    page = select_page(tex, frame)
    r0, c0 = (int(v) for v in origin)
    rows = (torch.arange(h, device=tex.device) + r0) % th
    cols = (torch.arange(w, device=tex.device) + c0) % tw
    return page[rows[:, None], cols[None, :]]


def select_page(tex: torch.Tensor, frame) -> torch.Tensor:
    """Page frame mod pages of a (pages, th, tw) texture, floor-mod as
    ``jnp``'s ``%``: a view for an int frame; for a frame tensor (on the
    texture's device, ``frame_index``) the page is gathered there, with no
    host read."""
    f = frame_index(frame, tex.device)
    if isinstance(f, int):
        return tex[f % tex.shape[0]]
    return tex.index_select(0, f.remainder(tex.shape[0]).reshape(1))[0]


def tepd_quantize(c: torch.Tensor, dit: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """Temporal energy-preserving dithered linear -> gamma-2.0 quantize.

    c: (..., 3, H, W) in {0..1}; dit: (H, W) from tepd_dither; bits: 8 or 10.
    Chooses the *linear*-nearest quantization step (not perceptual-nearest) so
    that temporally averaged dither preserves energy (FsrTepdC8F/C10F).
    """
    if bits not in (8, 10):
        raise ValueError("TEPD supports 8- or 10-bit output")
    dt = c.dtype
    # 0-d tensors of c's dtype, filled on its device (no host copy: a
    # captured graph may hold them).
    steps = torch.full((), 255.0 if bits == 8 else 1023.0, dtype=dt, device=c.device)
    inv = torch.full((), 1.0, dtype=dt, device=c.device) / steps
    n = torch.sqrt(c)
    n = torch.floor(n * steps) * inv
    a = n * n
    b = n + inv
    b = b * b
    if dt == torch.bfloat16:
        r = (c - b) * approx.rcp(a - b)
    else:
        r = (c - b) * approx.prx_med_rcp(a - b)
    gt = (dit[..., None, :, :] - r > 0.0).to(dt)
    return approx.sat(n + gt * inv)
