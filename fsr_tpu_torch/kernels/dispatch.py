"""Kernel dispatch: decide when the fused kernel path applies.

Counterpart of ``fsr_tpu/kernels/dispatch.py``.  K1 specialises on the
phase structure of the coordinate mapping (see ``kernels/fused.py``); this
module owns the eligibility check and the call, so ``api.upscale`` stays
device-agnostic.  A configuration K1 does not take raises: the kernel path
never falls back to plain torch on its own.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import fused

__all__ = ["supported", "upscale_fused"]


def supported(image: torch.Tensor, out_size, con: EasuConstants, compute_dtype) -> bool:
    """True when the kernel path (K4 then K1) takes this configuration."""
    return fused.supported(tuple(image.shape), out_size, con, compute_dtype)


def upscale_fused(
    image: torch.Tensor,
    out_size: Tuple[int, int],
    con: EasuConstants,
    rcon: RcasConstants,
    apply_rcas: bool,
    denoise: bool,
    compute_dtype,
) -> torch.Tensor:
    """Run the kernel path: K4 then K1 on a CUDA tensor, their plain
    versions on a CPU tensor."""
    if not supported(image, out_size, con, compute_dtype):
        raise NotImplementedError(
            "the kernel path takes RGB float32/bfloat16 images at integer "
            "per-axis ratios (1, 2 or 4) only; other ratios need kernel K2 "
            "(ROADMAP.md queue item 4: K2 for presets and DRS). "
            f"Got in={tuple(image.shape)} out={tuple(out_size)} dtype={compute_dtype}; "
            "pass impl='torch' for the plain-torch path."
        )
    return fused.upscale_fused(
        image, out_size, con, rcon,
        apply_rcas=apply_rcas, denoise=denoise, compute_dtype=compute_dtype,
    )
