"""Top-level user API: ``upscale()`` and ``sharpen()``.

Counterpart of ``fsr_tpu/api.py``.  ``upscale``: constant setup on the host,
then EASU and RCAS either fused in the hand-written CUDA kernels (K4 pad and
K1 at integer ratios, K2 at any other upscale; no intermediate image in
device memory) or as two plain-torch ops.  ``sharpen``: RCAS alone, in the
CUDA kernel K3 or as the plain-torch op.

Layouts: planar channels-first (..., C, H, W) as in ``fsr_tpu``; (..., H,
W, C) inputs are accepted with ``layout="HWC"``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.core.presets import PRESETS
from fsr_tpu_torch.kernels import dispatch
from fsr_tpu_torch.kernels import rcas as rcas_kernel
from fsr_tpu_torch.ops import easu as easu_ops
from fsr_tpu_torch.ops import rcas as rcas_ops

__all__ = ["upscale", "sharpen"]


def _resolve_out_size(
    in_size: Tuple[int, int],
    out_size: Optional[Tuple[int, int]],
    scale: Optional[float],
    preset: Optional[str],
) -> Tuple[int, int]:
    if out_size is not None:
        return (int(out_size[0]), int(out_size[1]))
    if preset is not None:
        if preset not in PRESETS:
            raise ValueError(f"unknown preset {preset!r}; available: {sorted(PRESETS)}")
        scale = PRESETS[preset].scale
    if scale is None:
        raise ValueError("provide one of out_size=, scale=, or preset=")
    return (round(in_size[0] * scale), round(in_size[1] * scale))


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md queue item {item})")


def upscale(
    image: torch.Tensor,
    out_size: Optional[Tuple[int, int]] = None,
    scale: Optional[float] = None,
    preset: Optional[str] = None,
    sharpness: float = 0.25,
    apply_rcas: bool = True,
    denoise: bool = False,
    compute_dtype=torch.float32,
    impl: str = "auto",
    layout: str = "CHW",
    input_viewport: Optional[Tuple[int, int]] = None,
    input_offset: Tuple[int, int] = (0, 0),
    epilogue=None,
    frame=None,
    grain=None,
    grain_planar=None,
    prologue: str = "none",
    out_dtype=None,
    dither_page=None,
) -> torch.Tensor:
    """FSR 1.0 upscale: EASU + optional RCAS.

    image: (..., 3, H, W) planar (layout="CHW", default) or (..., H, W, 3)
      (layout="HWC"), float32 or bfloat16, values in [0, 1].
    out_size / scale / preset: target size (one of the three).  Presets:
      ultra_quality 1.3x, quality 1.5x, balanced 1.7x, performance 2.0x.
    sharpness: RCAS sharpness in stops (0 = maximum; sample default 0.25).
    compute_dtype: float32 | bfloat16.  On the kernel path bfloat16 is the
      storage type and the math runs in float32; on the torch path colour
      accumulation runs in bfloat16.
    impl: "auto" | "torch" | "kernel".  "auto" takes the kernel path for a
      CUDA tensor and the plain-torch path for a CPU tensor; "torch" is the
      plain-torch path on any device; "kernel" forces the kernel path (on
      CPU tensors the kernels' plain versions).  The kernel path runs K4
      then K1 at integer per-axis ratios (1, 2 or 4: the Performance
      preset) and K2 at every other upscale (the other presets, native 1x,
      DRS ratios, odd extents); a downscale raises NotImplementedError.
    input_viewport / input_offset: Dynamic Resolution Scaling — the viewport
      (h, w) actually rendered inside the container image, and its offset
      (FsrEasuConOffset, ffx_fsr1.h:205-225).

    epilogue/frame/grain/grain_planar/dither_page, prologue, out_dtype,
    RGBA and byte inputs, float16, and inputs that require grad raise
    NotImplementedError naming their ROADMAP queue item.

    Returns the upscaled image in compute_dtype, in the input's layout.
    """
    if impl not in ("auto", "torch", "kernel"):
        raise ValueError(f"impl must be 'auto', 'torch' or 'kernel', got {impl!r}")
    if layout == "HWC":
        image = image.movedim(-1, -3)
    elif layout != "CHW":
        raise ValueError(f"unknown layout {layout!r}")

    if any(v is not None for v in (epilogue, frame, grain, grain_planar, dither_page)):
        raise _not_ported("the output epilogue (K5: SRTM^-1/gamma2, LFGA grain, TEPD dither)", "3")
    if prologue != "none":
        raise _not_ported(f"prologue={prologue!r}", "3")
    if out_dtype is not None:
        raise _not_ported("out_dtype (uint8/uint16 output)", "2")
    if image.dtype in (torch.uint8, torch.uint16):
        raise _not_ported(f"{image.dtype} input", "2")
    if image.dtype == torch.float16 or compute_dtype == torch.float16:
        raise _not_ported("float16", "5")
    if image.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"image must be float32 or bfloat16, got {image.dtype}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    if image.dim() < 3:
        raise ValueError(f"image must be (..., C, H, W), got {tuple(image.shape)}")
    if image.shape[-3] == 4:
        raise _not_ported("RGBA input", "2")
    if image.shape[-3] != 3:
        raise ValueError(f"image must have 3 channels, got {image.shape[-3]}")

    hin, win = image.shape[-2:]
    vp = input_viewport if input_viewport is not None else (hin, win)
    out_hw = _resolve_out_size(vp, out_size, scale, preset)
    con = EasuConstants.create(
        input_viewport_in_pixels=(vp[1], vp[0]),
        input_size_in_pixels=(win, hin),
        output_size_in_pixels=(out_hw[1], out_hw[0]),
        input_offset_in_pixels=(input_offset[1], input_offset[0]),
    )
    rcon = RcasConstants(sharpness_stops=float(sharpness))

    if image.requires_grad:
        # The bit tricks have no derivative through their integer views; the
        # ideal-derivative backward passes come with autodiff.
        raise _not_ported("autodiff", "4")

    use_kernel = impl == "kernel" or (impl == "auto" and image.device.type == "cuda")
    if use_kernel:
        out = dispatch.upscale_fused(
            image, out_hw, con, rcon,
            apply_rcas=apply_rcas, denoise=denoise, compute_dtype=compute_dtype,
        )
    else:
        out = easu_ops.easu(image, out_hw, con, compute_dtype=compute_dtype)
        if apply_rcas:
            out = rcas_ops.rcas(out, rcon, denoise=denoise, compute_dtype=compute_dtype)

    if layout == "HWC":
        out = out.movedim(-3, -1)
    return out


def sharpen(
    image: torch.Tensor,
    sharpness: float = 0.25,
    denoise: bool = False,
    compute_dtype=None,
    impl: str = "auto",
    layout: str = "CHW",
    border: str = "clamp",
) -> torch.Tensor:
    """Standalone RCAS sharpening (no scaling): the reference supports RCAS
    as an independent pass (ffx_fsr1.h:602-608).

    image: (..., 3, H, W) or (..., 4, H, W) with alpha (layout="CHW"), or
      channels last (layout="HWC"); float32 or bfloat16, values in [0, 1].
    compute_dtype: float32 | bfloat16 | None (the image's dtype).  On the
      kernel path it is the storage type and the math runs in float32; on
      the torch path the arithmetic runs in it.
    impl: "auto" | "torch" | "kernel".  "auto" runs K3 for a CUDA tensor and
      the plain-torch op for a CPU tensor; "torch" the plain-torch op on any
      device; "kernel" K3 (on a CPU tensor its plain version).
    border: "clamp" (edge replication) or "zero" (the sample's out-of-bounds
      imageLoad, which darkens the 1-pixel border; kept for A/B parity).

    Alpha is passed through verbatim.  Byte images, float16 and inputs that
    require grad raise NotImplementedError naming their ROADMAP queue item.
    """
    if impl not in ("auto", "torch", "kernel"):
        raise ValueError(f"impl must be 'auto', 'torch' or 'kernel', got {impl!r}")
    if layout == "HWC":
        image = image.movedim(-1, -3)
    elif layout != "CHW":
        raise ValueError(f"unknown layout {layout!r}")
    if image.dtype in (torch.uint8, torch.uint16):
        raise _not_ported(f"{image.dtype} input", "2")
    if image.dtype == torch.float16 or compute_dtype == torch.float16:
        raise _not_ported("float16", "5")
    if image.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"image must be float32 or bfloat16, got {image.dtype}")
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    if image.dim() < 3 or image.shape[-3] not in (3, 4):
        raise ValueError(f"image must be (..., 3 or 4, H, W), got {tuple(image.shape)}")
    if image.requires_grad:
        raise _not_ported("autodiff", "4")
    rcon = RcasConstants(sharpness_stops=float(sharpness))

    if impl == "kernel" or (impl == "auto" and image.device.type == "cuda"):
        out = rcas_kernel.rcas_fused(
            image[..., :3, :, :], rcon, denoise=denoise, compute_dtype=compute_dtype, border=border
        )
        if image.shape[-3] == 4:
            out = torch.cat([out, image[..., 3:4, :, :].to(out.dtype)], dim=-3)
    else:
        out = rcas_ops.rcas(image, rcon, denoise=denoise, compute_dtype=compute_dtype, border=border)

    if layout == "HWC":
        out = out.movedim(-3, -1)
    return out
