"""K3: standalone RCAS sharpening (CUDA kernel).

Counterpart of ``fsr_tpu/kernels/rcas_pallas.py:rcas_fused``: RCAS as an
independent pass at the image's own size (ffx_fsr1.h:602-608), which
``api.sharpen`` runs.  Storage is ``compute_dtype`` (default: the image's
dtype): float32, bfloat16 or float16; the math is float32
(``rcas_resolve(fast=True)``, the float32 sharpness) with one rounding at
the store.  float16 is the TPU kernel's rule (``rcas_pallas.py:66-67``:
f32 math on the widened half), but the result stays float16 on every
device, as every other path returns the input's dtype (the TPU kernel
returns float32 there).  ``border="clamp"`` replicates the edge; ``border="zero"``
reads zeros outside the image, as the sample's imageLoad does.

A uint8 image sharpens byte in, byte out, whatever ``compute_dtype`` says
(``fsr_tpu/kernels/rcas_pallas.py:64-73``): decoded v * float32(1/255) at
load, float32 math, UNORM8 codes at the store.

``rcas_fused`` launches ``csrc/rcas.cu`` for a CUDA tensor and records the
launch as an ``fsr.launch`` span labelled ``kernel="K3"``
(``utils/profiling.py``; under CUDA graph capture at capture: a replay
records none); for a CPU tensor it runs ``rcas_fused_reference``.
"""

from __future__ import annotations

import torch

from fsr_tpu_torch.core import easu_math
from fsr_tpu_torch.core.constants import RcasConstants
from fsr_tpu_torch.kernels import epilogue as epilogue_mod
from fsr_tpu_torch.kernels import pad
from fsr_tpu_torch.ops.rcas import shift_clamped
from fsr_tpu_torch.utils import profiling

__all__ = ["rcas_fused", "rcas_fused_reference"]

# K3's float storage types.
FLOAT_DTYPES = pad.FLOAT_DTYPES + (torch.float16,)


def _prepare(image, compute_dtype, border):
    if border not in ("clamp", "zero"):
        raise ValueError(f"border must be 'clamp' or 'zero', got {border!r}")
    if image.dim() < 3 or image.shape[-3] != 3:
        raise ValueError(f"image must be (..., 3, H, W), got {tuple(image.shape)}")
    if image.dtype == torch.uint8:
        return torch.uint8
    dt = compute_dtype if compute_dtype is not None else image.dtype
    if dt not in FLOAT_DTYPES:
        raise ValueError(f"compute_dtype must be float32, bfloat16 or float16, got {dt}")
    return dt


def rcas_fused_reference(
    image: torch.Tensor,
    rcon: RcasConstants,
    denoise: bool = False,
    compute_dtype=None,
    border: str = "clamp",
) -> torch.Tensor:
    """Plain version of K3, on any device: the image rounded to the storage
    dtype (or a decoded byte), the float32 cross with the border rule,
    ``rcas_resolve(fast=True)``, one rounding (or UNORM8 encode) at the end."""
    dt = _prepare(image, compute_dtype, border)
    src = epilogue_mod.decode(image, dt)
    out = easu_math.rcas_resolve(
        shift_clamped(src, -1, 0, border),
        shift_clamped(src, 0, -1, border),
        src,
        shift_clamped(src, 0, 1, border),
        shift_clamped(src, 1, 0, border),
        float(rcon.sharpness),
        denoise=denoise,
        fast=True,
    )
    return epilogue_mod.store(out, dt)


def rcas_fused(
    image: torch.Tensor,
    rcon: RcasConstants,
    denoise: bool = False,
    compute_dtype=None,
    border: str = "clamp",
) -> torch.Tensor:
    """RCAS of a (..., 3, H, W) float32, bfloat16 or float16 image, returned
    in ``compute_dtype`` (default: the image's dtype), or of a uint8 image,
    returned in uint8.  CUDA tensors launch ``csrc/rcas.cu``; CPU tensors
    run ``rcas_fused_reference``."""
    if image.device.type == "cpu":
        return rcas_fused_reference(image, rcon, denoise, compute_dtype, border)
    if image.device.type != "cuda":
        raise ValueError(f"rcas_fused takes a CPU or CUDA tensor, got {image.device}")
    if image.dtype not in FLOAT_DTYPES + (torch.uint8,):
        raise TypeError(f"RCAS kernel takes float32/bfloat16/float16/uint8 images, got {image.dtype}")
    dt = _prepare(image, compute_dtype, border)
    image = image.contiguous()
    *lead, _, h, w = image.shape
    out = torch.empty((*lead, 3, h, w), dtype=dt, device=image.device)
    if out.numel() == 0:
        return out
    from fsr_tpu_torch.kernels import _build

    lib = _build.library()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        with profiling.trace_annotation("fsr.launch", "kernel", "K3"):
            err = lib.fsr_rcas(
                image.data_ptr(), out.data_ptr(), pad.DTYPE_CODES[image.dtype], pad.DTYPE_CODES[dt],
                image.numel() // (3 * h * w), h, w, float(rcon.sharpness), int(border == "zero"),
                int(denoise), stream,
            )
    if err != 0:
        raise RuntimeError(f"RCAS kernel launch failed: cudaError {err}")
    return out
