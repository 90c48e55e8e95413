"""Kernel dispatch: pick the kernel that takes a configuration.

Counterpart of ``fsr_tpu/kernels/dispatch.py``.  K1 (the fused kernel,
``kernels/fused.py``, with the edge pad folded into its loads) takes the integer phase structures of the
coordinate mapping (the 2x Performance preset); K2 (``kernels/easu_gather.py``)
takes every other upscale (the other presets, native 1x, DRS ratios).  Both
take the byte source, a float16 source, the SRTM prologue, the K5 epilogue
and the integer outputs, and RGB or RGBA, in one launch.  float16 math
(``compute_dtype``) goes to K6 (``kernels/easu_h.py``) at any upscale: EASU
"mixed" and FsrRcasH in one launch, RGB or RGBA, from a float16, float32,
bfloat16 or uint8 source, with the prologue, the epilogue and the uint8 or
uint16 outputs inside the same launch (its tail forms), as the JAX package
runs that chain inside one jitted XLA program.  A row strip of a
row-sharded frame (``parallel.spatial.Strip``) runs the strip form of the
same kernels: K1's on shard-local constants at an exact-phase ratio, else
K2's on the strip's row tables, K6's on those tables for float16 math.
This module owns the choice and the call, so ``api.upscale`` stays
device-agnostic.  A configuration no kernel takes (a
downscale, another dtype, a strip whose footprint does not fit) raises:
the kernel path never falls back to plain torch on its own; ``supported``
lets ``api.upscale(impl="auto")`` choose the torch path before any launch.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import easu_gather, easu_h, fused, halo
from fsr_tpu_torch.utils import profiling

__all__ = ["supported", "upscale_fused"]


def supported(image, out_size, con: EasuConstants, compute_dtype, out_dtype=None, strip=None) -> bool:
    """True when the kernel path (K1 or K2; K6 for float16 math) takes this
    configuration; for a row strip (``strip``, ``image`` its halo'd rows)
    when the strip form of its kernel takes the strip's plan."""
    with profiling.trace_annotation("fsr.dispatch"):
        return _supported(image, out_size, con, compute_dtype, out_dtype, strip)


def _supported(image, out_size, con, compute_dtype, out_dtype, strip) -> bool:
    """``supported`` inside this module, in its callers' spans."""
    shape = tuple(image.shape)
    rows = None if strip is None else strip.rows
    if compute_dtype == torch.float16:
        return easu_h.supported(shape, out_size, con, row_plan=rows, out_dtype=out_dtype)
    if strip is not None and strip.local_con is not None:
        return fused.supported(shape, out_size, strip.local_con, compute_dtype, out_dtype)
    return (strip is None and fused.supported(shape, out_size, con, compute_dtype, out_dtype)) or \
        easu_gather.supported(shape, out_size, con, compute_dtype, out_dtype, row_plan=rows)


def upscale_fused(
    image,
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
    strip=None,
) -> torch.Tensor:
    """Run the kernel path: K1 at an integer phase structure, else K2; K6
    for float16 math; on a CPU tensor their plain versions.  ``grain`` is
    plain output-space (3, Hout, Wout).  ``strip``: a
    ``parallel.spatial.Strip`` when ``image`` is one row strip's halo'd rows
    (a tensor or a ``halo.StripSource``) and ``out_size`` its output rows:
    the strip forms, the epilogue at the strip's global rows (``grain`` its
    rows).  A configuration no kernel takes raises, naming impl='torch'."""
    with profiling.trace_annotation("fsr.dispatch"):
        shape = tuple(image.shape)
        kw = dict(epilogue=epilogue, frame=frame, grain=grain, prologue=prologue,
                  out_dtype=out_dtype, dither_page=dither_page)
        if _supported(image, out_size, con, compute_dtype, out_dtype, strip):
            if compute_dtype == torch.float16:
                return _upscale_h(image, out_size, con, rcon, apply_rcas, denoise, strip=strip, **kw)
            args = (rcon, apply_rcas, denoise, compute_dtype)
            if strip is not None and strip.local_con is not None:
                return fused.upscale_fused(image, out_size, strip.local_con, *args, row_offset=strip.row0,
                                           global_rows=strip.global_rows, **kw)
            if strip is not None:
                return easu_gather.easu_gather(image, out_size, con, *args, row_plan=strip.rows, row_offset=strip.row0,
                                               **kw)
            if fused.supported(shape, out_size, con, compute_dtype, out_dtype):
                return fused.upscale_fused(image, out_size, con, *args, **kw)
            return easu_gather.easu_gather(image, out_size, con, *args, **kw)
        if compute_dtype == torch.float16:
            what = "the float16 kernel path (K6) takes RGB and RGBA upscales (1x to 4x area) to float16/uint8/uint16"
        else:
            what = ("the kernel path takes RGB and RGBA upscales (1x to 4x area) in float32/bfloat16 storage "
                    "with float32/bfloat16/float16/uint8 sources and uint8/uint16 or storage-type outputs")
        if strip is not None:
            what += f", a row strip where its blocks can stage the strip's footprint (strip at row {strip.row0})"
        raise NotImplementedError(
            f"{what}; got in={shape} out={tuple(out_size)} dtype={compute_dtype} out_dtype={out_dtype}. "
            "Pass impl='torch' for the plain-torch path."
        )


def _upscale_h(image, out_size, con, rcon, apply_rcas, denoise, *, epilogue, frame, grain, prologue, out_dtype,
               dither_page, strip=None):
    """float16 math: one K6 launch, with the prologue, the epilogue, the
    store as ``out_dtype`` and RGBA's alpha inside; a row strip (a tensor
    or a ``halo.StripSource``, read in place) one launch of K6's strip form
    on its row tables, the dither at its global rows."""
    with profiling.trace_annotation("fsr.dispatch"):
        src = image if isinstance(image, halo.StripSource) else image.contiguous()
        return easu_h.easu_h(src, out_size, con, rcon, apply_rcas, denoise,
                             row_plan=None if strip is None else strip.rows, prologue=prologue, epilogue=epilogue,
                             frame=frame, grain=grain, dither_page=dither_page, out_dtype=out_dtype,
                             row_offset=0 if strip is None else strip.row0)
