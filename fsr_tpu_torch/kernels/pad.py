"""K4: edge-replicating pad plus dtype convert, one pass (CUDA kernel).

Counterpart of ``fsr_tpu/kernels/pad.py:edge_pad``: the CLAMP sampler of
the reference (FSR_Filter.cpp:49-50) as a padded copy.  K1 does not read
one (it clamps each staged texel's index, which is this pad folded into
its loads); ``fused.upscale_padded`` and the measurement tools still run K1
on a copy this makes.

``edge_pad`` launches ``csrc/edge_pad.cu`` for a CUDA tensor and records
the launch as an ``fsr.launch`` span labelled ``kernel="K4"``
(``utils/profiling.py``); for a CPU tensor it runs the plain version
``edge_pad_reference``.  The kernel's source note says what bounds it.  A
uint8 image pads as bytes (uint8 to uint8), as the JAX package pads a byte
source for its fused kernel (fused.py:583-592); K1 decodes at its loads.
Any number of planes pads in one launch: an RGBA image's alpha with its
colour.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fsr_tpu_torch.utils import profiling

__all__ = ["edge_pad", "edge_pad_reference"]

# dtype codes of the kernels' C interfaces (csrc/fsr_pixel.cuh DType).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2, torch.uint16: 3, torch.float16: 4}
# The float storage types of K1, K2 and K4 (float16 math runs K6, as it runs
# the XLA path in the JAX package; K3 also stores float16).
FLOAT_DTYPES = (torch.float32, torch.bfloat16)


def edge_pad_reference(image: torch.Tensor, pads: Tuple[int, int, int, int], out_dtype) -> torch.Tensor:
    """Plain version: clamped-index gather of the last two axes of
    (..., H, W), then ``.to(out_dtype)``.  pads: (top, bottom, left, right),
    all >= 0.  Bit-equal to ``jnp.pad(image.astype(dt), mode="edge")``."""
    pt, pb, pl, pr = pads
    h, w = image.shape[-2:]
    dev = image.device
    r = torch.clamp(torch.arange(-pt, h + pb, device=dev), 0, h - 1)
    c = torch.clamp(torch.arange(-pl, w + pr, device=dev), 0, w - 1)
    return image.index_select(-2, r).index_select(-1, c).to(out_dtype)


def edge_pad(image: torch.Tensor, pads: Tuple[int, int, int, int], out_dtype) -> torch.Tensor:
    """Edge-pad the last two axes of (..., H, W) and convert to out_dtype
    (float32 or bfloat16 from either; uint8 from uint8).  pads: (top,
    bottom, left, right), all >= 0."""
    if image.device.type == "cpu":
        return edge_pad_reference(image, pads, out_dtype)
    if image.device.type != "cuda":
        raise ValueError(f"edge_pad takes a CPU or CUDA tensor, got {image.device}")
    floats = image.dtype in FLOAT_DTYPES and out_dtype in FLOAT_DTYPES
    if not (floats or image.dtype == out_dtype == torch.uint8):
        raise TypeError(
            f"edge_pad kernel takes float32/bfloat16 or uint8 -> uint8, got {image.dtype} -> {out_dtype}"
        )
    if image.dim() < 2 or not image.is_contiguous():
        raise ValueError("edge_pad kernel needs a contiguous (..., H, W) tensor")
    pt, pb, pl, pr = (int(p) for p in pads)
    if min(pt, pb, pl, pr) < 0:
        raise ValueError(f"pads must be >= 0, got {pads}")
    *lead, h, w = image.shape
    if h == 0 or w == 0:
        raise ValueError("edge_pad needs a non-empty image")
    out = torch.empty((*lead, h + pt + pb, w + pl + pr), dtype=out_dtype, device=image.device)
    if out.numel() == 0:
        return out
    from fsr_tpu_torch.kernels import _build

    lib = _build.library()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        with profiling.trace_annotation("fsr.launch", "kernel", "K4"):
            err = lib.fsr_edge_pad(
                image.data_ptr(), out.data_ptr(), DTYPE_CODES[image.dtype], DTYPE_CODES[out_dtype],
                image.numel() // (h * w), h, w, pt, pb, pl, pr, stream,
            )
    if err != 0:
        raise RuntimeError(f"edge_pad kernel launch failed: cudaError {err}")
    return out
