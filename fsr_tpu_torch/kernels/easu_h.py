"""K6: the float16 upscale, EASU "mixed" (+ FsrRcasH), in one CUDA kernel.

No TPU kernel of the JAX package computes this: a float16 upscale runs
there as two jitted XLA programs (``fsr_tpu/ops/easu.py:47`` ``easu`` with
``compute_dtype=float16``, precision "mixed", and ``fsr_tpu/ops/rcas.py:42``
``rcas`` in float16), because Mosaic has no float16 vector type on the TPU
(``fsr_tpu/kernels/fused.py:116-120``).  On the H100 the port's torch path
runs the same function as about 1,100 eager operations; K6 computes it in
one launch, bit for bit:

- the source (float16, float32, bfloat16 or uint8) rounded to half as
  ``src.to(torch.float16)`` rounds it, a byte first decoded as
  ``epilogue.decode`` decodes it;
- ``ops.easu(rgb, out_size, con, compute_dtype=float16)``: the direction
  and length estimate in float32 with the float32 bit tricks, the taps'
  weights (the non-fast forms), FsrEasuF's single accumulation chain, the
  reciprocal of the weight sum and the dering clamp in float16;
- with ``apply_rcas``, ``ops.rcas(out, rcon, denoise, float16)`` on those
  half values: FsrRcasH with ``sharpness_f16``, the exact reciprocal in the
  limiters, ``prx_med_rcp`` on halves, the border clamped in output
  coordinates;
- RGBA: alpha is ``ops.easu.bilinear`` of the alpha plane as stored (a byte
  decoded), rounded to float16, never sharpened, plane 3 of the output.

The frame tail runs in the same launch (the tail forms, ``csrc/
easu_h_tail.cu`` and ``csrc/easu_h_tail_strip.cu``), as K1 and K2 run it:
the SRTM ``prologue`` on each texel as it is staged (``extras.srtm`` on the
source as the torch path holds it: a float16 or bfloat16 source in its own
type, a float32 source or a decoded byte in float32), and at the store the
K5 ``epilogue`` on each pixel's float16 value widened to float32, rounded
back to float16, then stored as ``out_dtype``: float16, or the uint8 or
10-bit UNORM codes of that half; alpha from its float32 bilinear by the
same storage rule.  That is the torch path's float16 chain
(``api._upscale``), which the JAX package runs inside one jitted program
(``fsr_tpu/api.py:280-309``).  Without an option the bare kernel runs.

A row strip of a row-sharded frame (``parallel.spatial``) passes its
halo'd source, ``out_size`` (hl, Wout) and its ``row_plan``
(``easu_gather.shard_plan``: K2's row tables from the GLOBAL mapping for
its output rows -1 .. hl, clipped to the frame), as K2 takes a strip; the
source may be a ``halo.StripSource``, which K6's strip-source form
(``csrc/easu_h_strip.cu``) reads in place from its parts.  Its plain
version is the torch path's strip: ``ops.easu(rows=)`` over rows -1 .. hl,
then ``ops.rcas.rcas_strip``, so each strip's rows are the whole frame's.

K6 reads K2's host tables (``easu_gather.plan``) and stages each block's
source footprint by K2's rule (``easu_gather.footprint``) for its own tile,
``TILE``, so it takes what K2 takes: RGB or RGBA, an upscale on both axes.
Each block computes the quadrant responses of the direction estimate once
per texel and runs its pixels two a thread in half2; the arithmetic, and so
every bit, is the plain version's.
``easu_h`` launches ``csrc/easu_h.cu`` for a CUDA tensor and records the
launch as an ``fsr.launch`` span labelled ``kernel="K6"``
(``utils/profiling.py``; under CUDA graph capture at capture); for a CPU
tensor it runs ``easu_h_reference``, which calls the same ops.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import easu_gather, fused, halo
from fsr_tpu_torch.kernels import epilogue as epilogue_mod
from fsr_tpu_torch.kernels import pad
from fsr_tpu_torch.ops import easu as easu_ops
from fsr_tpu_torch.ops import extras
from fsr_tpu_torch.ops import rcas as rcas_ops
from fsr_tpu_torch.utils import capture, profiling

__all__ = ["supported", "easu_h", "easu_h_reference", "TILE"]

# csrc/easu_h.cu: one block per TILE = (TH, TW) output pixels; its ring of
# (TH + 2) x (TW + 2) is two pixels a thread.  An upscale's footprint of a
# block (its ring's taps) is at most (TH + 5, TW + 5) texels.
TILE = (30, 30)
# The outputs K6 stores (None: float16).
OUT_DTYPES = (None, torch.float16, torch.uint8, torch.uint16)


def supported(in_shape, out_size, con: EasuConstants, row_plan: Optional[easu_gather.GatherPlan] = None,
              out_dtype=None) -> bool:
    """True when K6 takes this configuration: K2's rule
    (``easu_gather.supported``) without its storage types: RGB or RGBA and
    an upscale on both axes whose per-block footprint fits; for a row strip
    (``row_plan``), the footprint of the strip's plan; an output of
    ``OUT_DTYPES`` (None: float16)."""
    return out_dtype in OUT_DTYPES and easu_gather.supported(in_shape, out_size, con, torch.float32,
                                                             row_plan=row_plan)


def _check(image, out_size, con, rcon, apply_rcas, row_plan, prologue, out_dtype) -> Tuple[int, int]:
    if apply_rcas and rcon is None:
        raise ValueError("apply_rcas=True requires rcon")
    if image.dim() < 3 or image.shape[-3] not in (3, 4):
        raise ValueError(f"image must be (..., 3 or 4, H, W), got {tuple(image.shape)}")
    if image.dtype not in fused.SOURCE_DTYPES:
        raise TypeError(f"K6 takes float16/float32/bfloat16/uint8 images, got {image.dtype}")
    if prologue not in ("none", "srtm"):
        raise ValueError(f"unknown prologue {prologue!r}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"K6 stores float16, uint8 or uint16, got out_dtype={out_dtype}")
    out_hw = (int(out_size[0]), int(out_size[1]))
    if not supported(tuple(image.shape), out_hw, con, row_plan):
        what = "upscales only (1x-4x area)" if row_plan is None else "a strip whose plan and footprint fit"
        raise ValueError(f"K6 takes {what}, got {tuple(image.shape[-2:])} -> {out_hw}")
    return out_hw


def easu_h_reference(
    image,
    out_size: Tuple[int, int],
    con: EasuConstants,
    rcon: Optional[RcasConstants] = None,
    apply_rcas: bool = True,
    denoise: bool = False,
    *,
    row_plan: Optional[easu_gather.GatherPlan] = None,
    prologue: str = "none",
    epilogue: Optional[epilogue_mod.Epilogue] = None,
    frame=None,
    grain=None,
    dither_page=None,
    out_dtype=None,
    row_offset: int = 0,
) -> torch.Tensor:
    """Plain version of K6, on any device: the torch path's float16 chain
    (``api._upscale``'s torch branch) in its order: alpha
    ``ops.easu.bilinear`` of the alpha plane (a byte decoded), the colour
    decoded (a byte), ``extras.srtm`` with the prologue, ``ops.easu`` in
    float16 "mixed" then ``ops.rcas`` in float16, the epilogue on the
    result widened to float32 and rounded back to float16, the store as
    ``out_dtype`` (``epilogue.store``), alpha stored by the same rule and
    stacked as plane 3.  A row strip (``row_plan``, its first global output
    row ``row_offset``; a ``halo.StripSource`` first read by
    ``halo.halo_rows_reference``): the same ops over the plan's rows -1 ..
    hl, RCAS by ``ops.rcas.rcas_strip``, the dither at global rows."""
    if isinstance(image, halo.StripSource):
        image = halo.halo_rows_reference(image)
    out_hw = _check(image, out_size, con, rcon, apply_rcas, row_plan, prologue, out_dtype)
    f16 = torch.float16
    args = epilogue_mod.bind(epilogue, out_hw, frame, grain, dither_page, image.device, row_offset)
    rows = None if row_plan is None else (row_plan.rows[1], row_plan.py)
    rgb, alpha = image, None
    if image.shape[-3] == 4:
        rgb, a_src = image[..., :3, :, :], image[..., 3:4, :, :]
        if a_src.dtype == torch.uint8:
            a_src = epilogue_mod.decode(a_src)
        alpha = easu_ops.bilinear(a_src, out_hw, con, rows=None if rows is None else (rows[0][1:-1], rows[1][1:-1]))
    if rgb.dtype == torch.uint8:
        rgb = epilogue_mod.decode(rgb)
    if prologue == "srtm":
        rgb = extras.srtm(rgb)
    if rows is None:
        out = easu_ops.easu(rgb, out_hw, con, compute_dtype=f16)
        if apply_rcas:
            out = rcas_ops.rcas(out, rcon, denoise=denoise, compute_dtype=f16)
    else:
        out = easu_ops.easu(rgb, (out_hw[0] + 2, out_hw[1]), con, compute_dtype=f16, rows=rows)
        out = rcas_ops.rcas_strip(out, rcon, denoise, f16) if apply_rcas else out[..., 1:-1, :]
    if args is not None:
        out = epilogue_mod.apply(out.to(torch.float32), args).to(f16)
    out = epilogue_mod.store(out, out_dtype or f16)
    if alpha is not None:
        out = torch.cat([out, epilogue_mod.store(alpha, out.dtype)], dim=-3)
    return out


def easu_h(
    image,
    out_size: Tuple[int, int],
    con: EasuConstants,
    rcon: Optional[RcasConstants] = None,
    apply_rcas: bool = True,
    denoise: bool = False,
    *,
    row_plan: Optional[easu_gather.GatherPlan] = None,
    prologue: str = "none",
    epilogue: Optional[epilogue_mod.Epilogue] = None,
    frame=None,
    grain=None,
    dither_page=None,
    out_dtype=None,
    row_offset: int = 0,
) -> torch.Tensor:
    """The float16 upscale of a contiguous (..., C, Hin, Win) image, C = 3
    or 4, float16, float32, bfloat16 or uint8, to (..., C, Hout, Wout) in
    ``out_dtype`` (float16, uint8 or uint16; default float16): EASU
    "mixed", then FsrRcasH when ``apply_rcas``, with the SRTM ``prologue``
    and the K5 ``epilogue`` (its ``frame``, ``grain`` (3, Hout, Wout) and
    ``dither_page``, as ``epilogue.bind`` takes them) inside the launch.  A
    row strip passes its halo'd source, ``row_plan`` and ``row_offset`` (its
    first global output row; ``grain`` is its own rows, read in place where
    they are a view of the frame's grain) (module note); its
    source may be a ``halo.StripSource``, read in place from its parts
    (K6's strip-source form, the parts checked by ``halo.check``).  CUDA
    tensors launch ``csrc/easu_h.cu`` (the bare kernel without an option,
    else a tail form); CPU tensors run ``easu_h_reference``."""
    kw = dict(row_plan=row_plan, prologue=prologue, epilogue=epilogue, frame=frame, grain=grain,
              dither_page=dither_page, out_dtype=out_dtype, row_offset=row_offset)
    if image.device.type == "cpu":
        return easu_h_reference(image, out_size, con, rcon, apply_rcas, denoise, **kw)
    if image.device.type != "cuda":
        raise ValueError(f"easu_h takes a CPU or CUDA tensor, got {image.device}")
    hout, wout = _check(image, out_size, con, rcon, apply_rcas, row_plan, prologue, out_dtype)
    strip = isinstance(image, halo.StripSource)
    if not strip and not image.is_contiguous():
        raise ValueError("easu_h takes a contiguous image")
    args = epilogue_mod.bind(epilogue, (hout, wout), frame, grain, dither_page, image.device, row_offset,
                             grain_rows=True)
    out_dt = out_dtype or torch.float16
    tail = prologue == "srtm" or args is not None or out_dt != torch.float16
    parts = halo.check(image) if strip else None
    *lead, nc, hin, win = image.shape
    out = torch.empty((*lead, nc, hout, wout), dtype=out_dt, device=image.device)
    if out.numel() == 0:
        return out
    gplan = easu_gather.plan((hin, win), (hout, wout), con) if row_plan is None else row_plan
    rows, cols, py, px = capture.keep(easu_gather._device_tables(gplan, image.device))
    sharp = float(rcon.sharpness_f16) if rcon is not None else 1.0
    from fsr_tpu_torch.kernels import _build

    lib = _build.library()
    first = ctypes.addressof(parts) if strip else image.data_ptr()
    src_code = pad.DTYPE_CODES[image.dtype]
    tables = (hin, win, hout, wout, rows.data_ptr(), cols.data_ptr(), py.data_ptr(), px.data_ptr(), sharp,
              int(apply_rcas), int(denoise))
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        if tail:
            cepi = epilogue_mod.c_params(args)
            entry = lib.fsr_easu_h_tail_strip if strip else lib.fsr_easu_h_tail
            gplane = args.grain.stride(0) if args is not None and args.grain is not None else 0
            with profiling.trace_annotation("fsr.launch", "kernel", "K6"):
                err = entry(first, out.data_ptr(), src_code, pad.DTYPE_CODES[out_dt], math.prod(lead), nc, *tables,
                            int(prologue == "srtm"), gplane, ctypes.addressof(cepi), stream)
        else:
            entry = lib.fsr_easu_h_strip if strip else lib.fsr_easu_h
            with profiling.trace_annotation("fsr.launch", "kernel", "K6"):
                err = entry(first, out.data_ptr(), src_code, math.prod(lead), nc, *tables, stream)
    if err != 0:
        raise RuntimeError(f"K6 launch failed: cudaError {err}")
    return out
