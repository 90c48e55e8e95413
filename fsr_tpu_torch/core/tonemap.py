"""Tonemapping operators for the pre-EASU pass (torch).

Counterpart of ``fsr_tpu/core/tonemap.py``.  The sample tonemaps at render
resolution before EASU (sample/src/DX12/FSR_Tonemapping.hlsl:56-70:
exposure times one of {AMD/Lottes, DX11DSK, Reinhard, Uncharted2,
ACES-film, passthrough}), then TEPD-dithers when it outputs HDR10.  The
operators are the standard published forms (their bodies live in the
sample's Cauldron submodule).  ``tonemap`` is the sample's dispatch;
``tonemap_pass`` the whole render-resolution pass (tonemap, then the
optional TEPD 10-bit dither of ``ops.extras``), FSRToneMapping::Draw.

Every constant enters the arithmetic rounded to the tensor's dtype, as in
the JAX package.
"""

from __future__ import annotations

import torch

from fsr_tpu_torch.ops import extras

__all__ = [
    "amd_lottes", "dx11dsk", "reinhard", "uncharted2", "aces_film",
    "tonemap", "tonemap_pass", "TONEMAPPERS",
]


def _c(x: torch.Tensor, v: float) -> torch.Tensor:
    # A 0-d tensor of x's dtype filled on x's device: no host copy, so a
    # captured graph may hold it.
    return torch.full((), v, dtype=x.dtype, device=x.device)


def _max3(c):
    return torch.maximum(torch.maximum(c[..., 0, :, :], c[..., 1, :, :]), c[..., 2, :, :])


def amd_lottes(color: torch.Tensor) -> torch.Tensor:
    """AMD/Timothy Lottes "max3"-based tonemapper (luma-preserving ratio)."""
    peak = _max3(color)[..., None, :, :]
    peak = torch.maximum(peak, _c(color, 1.0 / 256.0))
    ratio = color / peak
    # The Lottes curve on the peak channel.
    a, d, mid_in, mid_out, hdr_max = 1.6, 0.977, 0.18, 0.267, 16.0
    pow_a = torch.pow(peak, _c(color, a))
    pow_ad = torch.pow(peak, _c(color, a * d))
    hdr_a = hdr_max ** a
    hdr_ad = hdr_max ** (a * d)
    mid_a = mid_in ** a
    mid_ad = mid_in ** (a * d)
    b = (-mid_a + hdr_a * mid_out) / ((hdr_ad - mid_ad) * mid_out)
    c2 = (hdr_ad * mid_a - hdr_a * mid_ad * mid_out) / ((hdr_ad - mid_ad) * mid_out)
    mapped = pow_a / (pow_ad * _c(color, b) + _c(color, c2))
    return torch.clamp(ratio * mapped, 0.0, 1.0)


def dx11dsk(color: torch.Tensor) -> torch.Tensor:
    """DirectX 11 SDK sample tonemapper: x / (x + 1) per channel."""
    return torch.clamp(color / (color + _c(color, 1.0)), 0.0, 1.0)


def reinhard(color: torch.Tensor) -> torch.Tensor:
    """Luma-based Reinhard."""
    lum = (
        color[..., 0, :, :] * _c(color, 0.2126)
        + color[..., 1, :, :] * _c(color, 0.7152)
        + color[..., 2, :, :] * _c(color, 0.0722)
    )[..., None, :, :]
    scale = (lum / (_c(color, 1.0) + lum)) / torch.maximum(lum, _c(color, 1e-6))
    return torch.clamp(color * scale, 0.0, 1.0)


def _uncharted2_curve(x):
    a, b, c, d, e, f = (_c(x, v) for v in (0.15, 0.50, 0.10, 0.20, 0.02, 0.30))
    cb, de, df, ef = (_c(x, v) for v in (0.10 * 0.50, 0.20 * 0.02, 0.20 * 0.30, 0.02 / 0.30))
    return ((x * (a * x + cb) + de) / (x * (a * x + b) + df)) - ef


def uncharted2(color: torch.Tensor) -> torch.Tensor:
    """Hable's Uncharted 2 filmic operator (W = 11.2)."""
    cur = _uncharted2_curve(color * _c(color, 2.0))
    white = _uncharted2_curve(_c(color, 11.2))
    return torch.clamp(cur / white, 0.0, 1.0)


def aces_film(color: torch.Tensor) -> torch.Tensor:
    """Narkowicz's ACES filmic approximation."""
    a, b, c, d, e = (_c(color, v) for v in (2.51, 0.03, 2.43, 0.59, 0.14))
    return torch.clamp((color * (a * color + b)) / (color * (c * color + d) + e), 0.0, 1.0)


TONEMAPPERS = {
    0: amd_lottes,
    1: dx11dsk,
    2: reinhard,
    3: uncharted2,
    4: aces_film,
    5: lambda c: c,  # passthrough
}

_NAMES = {"amd": 0, "dx11dsk": 1, "reinhard": 2, "uncharted2": 3, "aces": 4, "none": 5}


def tonemap(color: torch.Tensor, exposure: float = 1.0, tonemapper="amd") -> torch.Tensor:
    """Exposure + operator dispatch (FSR_Tonemapping.hlsl:56-70).

    color: (..., 3, H, W) linear HDR.  tonemapper: index 0-5 or name.
    """
    idx = _NAMES.get(tonemapper, tonemapper) if isinstance(tonemapper, str) else int(tonemapper)
    if idx not in TONEMAPPERS:
        raise ValueError(f"unknown tonemapper {tonemapper!r}")
    return TONEMAPPERS[idx](color * _c(color, exposure))


def tonemap_pass(
    color: torch.Tensor,
    exposure: float = 1.0,
    tonemapper="amd",
    hdr10_dither_frame=None,
) -> torch.Tensor:
    """The whole render-resolution tonemap pass (FSRToneMapping::Draw).

    hdr10_dither_frame: when given, the TEPD 10-bit energy-preserving
    dither after the tonemap (the sample's HDR output path,
    FSR_Tonemapping.hlsl:86-88, with the golden-ratio dither in place of the
    blue-noise texture the sample loads), in float32; an int or an integer
    tensor on the color's device (``ops.extras.frame_index``).
    """
    out = tonemap(color, exposure, tonemapper)
    if hdr10_dither_frame is not None:
        dit = extras.tepd_dither(tuple(out.shape[-2:]), hdr10_dither_frame, device=out.device)
        out = extras.tepd_quantize(out.to(torch.float32), dit, bits=10)
    return out
