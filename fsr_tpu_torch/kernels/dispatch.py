"""Kernel dispatch: pick the kernel that takes a configuration.

Counterpart of ``fsr_tpu/kernels/dispatch.py``.  K1 (the fused kernel,
``kernels/fused.py``, with the edge pad folded into its loads) takes the integer phase structures of the
coordinate mapping (the 2x Performance preset); K2 (``kernels/easu_gather.py``)
takes every other upscale (the other presets, native 1x, DRS ratios).  Both
take the byte source, the SRTM prologue, the K5 epilogue and the integer
outputs, and RGB or RGBA, in one launch.  This
module owns the choice and the call, so ``api.upscale`` stays
device-agnostic.  A configuration neither kernel takes (a downscale,
float16 or another dtype) raises: the kernel path never falls back to
plain torch on its own.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import easu_gather, fused

__all__ = ["supported", "upscale_fused"]


def supported(image: torch.Tensor, out_size, con: EasuConstants, compute_dtype,
              out_dtype=None) -> bool:
    """True when the kernel path (K1 or K2) takes this configuration."""
    shape = tuple(image.shape)
    return fused.supported(shape, out_size, con, compute_dtype, out_dtype) or easu_gather.supported(
        shape, out_size, con, compute_dtype, out_dtype
    )


def upscale_fused(
    image: torch.Tensor,
    out_size: Tuple[int, int],
    con: EasuConstants,
    rcon: RcasConstants,
    apply_rcas: bool,
    denoise: bool,
    compute_dtype,
    epilogue=None,
    frame=None,
    grain=None,
    prologue: str = "none",
    out_dtype=None,
    dither_page=None,
) -> torch.Tensor:
    """Run the kernel path: K1 at an integer phase structure, else K2; on a
    CPU tensor their plain versions.  ``grain`` is plain
    output-space (3, Hout, Wout) for both kernels."""
    shape = tuple(image.shape)
    kw = dict(epilogue=epilogue, frame=frame, grain=grain, prologue=prologue,
              out_dtype=out_dtype, dither_page=dither_page)
    if fused.supported(shape, out_size, con, compute_dtype, out_dtype):
        return fused.upscale_fused(image, out_size, con, rcon, apply_rcas, denoise, compute_dtype, **kw)
    if easu_gather.supported(shape, out_size, con, compute_dtype, out_dtype):
        return easu_gather.easu_gather(image, out_size, con, rcon, apply_rcas, denoise, compute_dtype, **kw)
    raise NotImplementedError(
        "the kernel path takes RGB and RGBA upscales (1x to 4x area) in float32/bfloat16 storage "
        "with float32/bfloat16/uint8 sources and uint8/uint16 or storage-type outputs; "
        f"got in={shape} out={tuple(out_size)} dtype={compute_dtype} out_dtype={out_dtype}. "
        "Pass impl='torch' for the plain-torch path."
    )
