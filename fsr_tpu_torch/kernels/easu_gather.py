"""K2: EASU (+ fused RCAS) at any upscale ratio (CUDA kernel).

Counterpart of ``fsr_tpu/kernels/easu_gather.py:easu_gather``.  It takes
every configuration K1 does not: the 1.3x/1.5x/1.7x presets, native 1x,
non-integer Dynamic Resolution Scaling ratios and odd output extents.

The host builds per-axis tables from the float32 coordinate mapping
(``ops.easu.easu_coords``): for each output column the four source columns
``clip(fx + dx, 0, win - 1)`` (dx = -1..2) and the subpixel fraction, and the
same for rows, for output rows -1 .. Hout (the RCAS ring's; a row outside
the frame repeats its edge row).  The clip is the CLAMP sampler that ``ops.easu`` applies, so
the kernel reads the unpadded source (no K4 pass in front of it), and the
device never recomputes a coordinate.  ``easu_gather`` launches
``csrc/easu_gather.cu`` for a CUDA tensor and records the launch as an
``fsr.launch`` span labelled ``kernel="K2"`` (``utils/profiling.py``;
under CUDA graph capture at capture: a replay records none); for a CPU
tensor it runs ``easu_gather_reference``.

Each block of the kernel stages its source footprint in shared memory: the
rectangle of texels its TILE output pixels and their RCAS ring read, which
the tables' monotonicity bounds by the first ring pixel's first tap and the
last one's last tap.  ``footprint`` computes it as the device does, and
``easu_gather`` checks before the launch that every block's fits
``FOOTPRINT_MAX`` and holds every tap of its pixels.

Options, as K1 takes them (``kernels/fused.py``): a float16 image, a
uint8 image (decoded at each load, never rounded to the storage
type), the SRTM prologue, the
K5 epilogue with plain output-space grain (``kernels/epilogue.py``),
uint8/uint16 ``out_dtype``, and RGBA in one launch: alpha bilinear from the
plan's rows[1..2] and cols[1..2] at (px, py), as ``ops.easu.bilinear``
computes it (the JAX ``api`` splits alpha off for its gather kernel,
``fsr_tpu/kernels/dispatch.py:31-35``; the f32 results agree).

Row strips (``build_shard_plans``, easu_gather.py:216-311 in the JAX
package; ``parallel/spatial.py`` calls them): ``shard_plan`` builds strip
k's row tables from the GLOBAL mapping, for output rows k*hl - 1 .. (k+1)*hl
clipped to the frame (the global RCAS border), with source rows relative to
the strip and its halo rows; ``easu_gather(row_plan=, row_offset=)`` runs K2
on the strip with them, the epilogue's dither at global rows.  The kernel is
the same: only its tables differ.  The strip's source is one halo'd tensor,
or a ``halo.StripSource`` that K2's strip-source form reads in place (the
halo rows of H1 with no copy).

The TPU kernel's hybrid X-phase, one-hot row selectors, dynamic-roll column
gathers, tile sweeps and one-tile software pipeline, and the shard plans'
R selectors, ``tih`` windows and ``pad_bottom``, are TPU layout machinery
with no counterpart here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import epilogue as epilogue_mod
from fsr_tpu_torch.kernels import fused, halo, pad
from fsr_tpu_torch.ops.easu import easu_coords
from fsr_tpu_torch.utils import capture, profiling

__all__ = ["supported", "GatherPlan", "plan", "plan_fits", "shard_rows", "shard_plan", "Footprint", "footprint",
           "easu_gather", "easu_gather_reference", "TILE", "FOOTPRINT_MAX"]

# csrc/easu_gather.cu: one block per TILE = (TH, TILE_W) output pixels, and
# the largest source footprint a block stages, (TH + 5, TILE_W + 5): its
# tile and one-pixel RCAS ring, and their taps -1..2.  An upscale (at most
# one source texel per output pixel on each axis) always fits.
TILE = (32, 32)
FOOTPRINT_MAX = (TILE[0] + 5, TILE[1] + 5)


def supported(in_shape, out_size, con: EasuConstants, compute_dtype, out_dtype=None,
              row_plan: Optional["GatherPlan"] = None) -> bool:
    """True when K2 takes this configuration: RGB or RGBA, float32/bfloat16
    storage, an output of the storage type or uint8/uint16 codes, and an
    upscale on both axes (the EASU 1x-4x contract).  The JAX kernel's
    minimum output of 16 x 128 is a TPU tiling limit and does not apply.
    A row strip (``in_shape`` its halo'd rows, ``row_plan`` its
    ``shard_plan``): the plan fits the strip and its footprint fits."""
    if len(in_shape) < 3 or in_shape[-3] not in (3, 4):
        return False
    if compute_dtype not in pad.FLOAT_DTYPES or not fused.out_dtype_ok(out_dtype, compute_dtype):
        return False
    hout, wout = (int(v) for v in out_size)
    hin, win = (int(v) for v in in_shape[-2:])
    if row_plan is not None:
        return plan_fits(row_plan, (hin, win), (hout, wout)) and wout >= win and footprint(row_plan).fits
    if not (min(hin, win) >= 1 and hout >= hin and wout >= win):
        return False
    # The constants' own scale must be an upscale too (a viewport larger
    # than the output is a downscale whatever the image's size).
    return footprint(plan((hin, win), (hout, wout), con)).fits


def plan_fits(gplan: "GatherPlan", in_hw: Tuple[int, int], out_hw: Tuple[int, int]) -> bool:
    """Whether a strip's tables (``shard_plan``) fit its (halo'd) source and
    output: every tap inside the source, so the loads need no bounds."""
    return (gplan.rows.shape == (4, out_hw[0] + 2) and gplan.cols.shape == (4, out_hw[1])
            and gplan.rows.min() >= 0 and gplan.rows.max() < in_hw[0] and gplan.cols.max() < in_hw[1])


@dataclasses.dataclass(frozen=True, eq=False)
class GatherPlan:
    """Host tables for one K2 configuration.

    rows (4, Hout + 2) / cols (4, Wout) int32: the source row/column of the
    taps at offsets -1..2 around each output pixel's 'f' texel, clipped to
    the source, the rows for output rows -1 .. Hout (the RCAS ring's; a row
    outside the frame repeats its edge row); py (Hout + 2,) / px (Wout,)
    float32: the subpixel fractions.  Plans are cached and compared by
    identity.
    """

    rows: np.ndarray
    cols: np.ndarray
    py: np.ndarray
    px: np.ndarray


_D = np.arange(-1, 3, dtype=np.int64)[:, None]  # tap offsets around 'f'


@functools.lru_cache(maxsize=64)
def plan(in_hw: Tuple[int, int], out_size: Tuple[int, int], con: EasuConstants) -> GatherPlan:
    """The tables for an (Hin, Win) -> out_size upscale under ``con``; cached
    per configuration, so both size arguments must be int tuples."""
    profiling.count("plans_built")
    hin, win = in_hw
    fx, fy, px, py = easu_coords(con, out_size)
    idx = np.clip(np.arange(-1, out_size[0] + 1), 0, out_size[0] - 1)
    rows = np.clip(fy[idx].astype(np.int64)[None, :] + _D, 0, hin - 1).astype(np.int32)
    cols = np.clip(fx.astype(np.int64)[None, :] + _D, 0, win - 1).astype(np.int32)
    return GatherPlan(rows=rows, cols=cols, py=py[idx], px=px)


def shard_rows(in_hw, out_size, con: EasuConstants, n: int, k: int, halo: int):
    """Row strip k of n: the 'f' source row of each output row k*hl - 1 ..
    (k+1)*hl (hl = Hout / n), clipped to the frame, relative to the strip's
    halo'd source (global input rows k*Hin/n - halo ..), and its float32
    fraction, taken from the GLOBAL mapping (``build_shard_plans``'s
    ``rows_xla``/``py_xla``).  Raises when ``halo`` rows cannot host the
    taps."""
    (hin, _), (hout, wout) = in_hw, out_size
    if hout % n or hin % n:
        raise ValueError(f"row sharding needs n | sizes (h {hin}->{hout}, n={n})")
    hl, hin_l = hout // n, hin // n
    _, fy, _, py = easu_coords(con, (hout, wout))
    idx = np.clip(np.arange(k * hl - 1, (k + 1) * hl + 1), 0, hout - 1)
    base = fy[idx].astype(np.int64) - (k * hin_l - halo)
    if base.min() < 1 or base.max() + 2 >= hin_l + 2 * halo:
        raise ValueError(f"halo {halo} cannot host shard {k}'s taps "
                         f"(local rows {base.min()}..{base.max()} of {hin_l + 2 * halo})")
    return base.astype(np.int32), py[idx]


@functools.lru_cache(maxsize=256)
def shard_plan(in_hw: Tuple[int, int], out_size: Tuple[int, int], con: EasuConstants, n: int, k: int,
               halo: int) -> GatherPlan:
    """K2's tables for row strip k of n of an (Hin, Win) -> out_size upscale:
    the rows of ``shard_rows`` (taps -1..2 around each; the halo rows, which
    the caller edge-replicates at the frame's top and bottom, are the
    CLAMP) and the whole frame's columns; cached per strip."""
    profiling.count("plans_built")
    base, py = shard_rows(in_hw, out_size, con, n, k, halo)
    full = plan(in_hw, out_size, con)
    rows = (base.astype(np.int64)[None, :] + _D).astype(np.int32)
    return GatherPlan(rows=rows, cols=full.cols, py=py, px=full.px)


@dataclasses.dataclass(frozen=True, eq=False)
class Footprint:
    """The source rectangle each block of K2 stages, per axis: for block row
    i, source rows r0[i] .. r0[i] + h[i] - 1; for block column j, columns
    c0[j] .. c0[j] + w[j] - 1.  ``fits``: every block's is at most
    FOOTPRINT_MAX and holds every tap row and column of its tile and ring."""

    r0: np.ndarray
    h: np.ndarray
    c0: np.ndarray
    w: np.ndarray
    fits: bool


def _ring(n: int, size: int, lo: int, hi: int) -> np.ndarray:
    """(blocks, size + 2): each block's ring coordinates, one before its
    ``size`` pixels to one past them, clamped to lo..hi."""
    start = np.arange(0, n, size)[:, None] - 1
    return np.clip(start + np.arange(size + 2)[None, :], lo, hi)


@functools.lru_cache(maxsize=256)
def footprint(gplan: GatherPlan) -> Footprint:
    """The device's rule (csrc/easu_gather.cu:stage), block by block: rows
    from the first ring row's dy = -1 tap to the last ring row's dy = +2
    tap, columns likewise; ring rows clamped to the tables' -1..Hout, ring
    columns to the image.  The tables are non-decreasing, so the rule bounds
    every tap; ``fits`` checks that it does and that the rectangle fits."""
    profiling.count("plans_built")
    hout, wout = gplan.rows.shape[1] - 2, gplan.cols.shape[1]
    rows = _ring(hout, TILE[0], -1, hout) + 1  # row tables start at output row -1
    cols = _ring(wout, TILE[1], 0, wout - 1)
    r0, r1 = gplan.rows[0][rows[:, 0]], gplan.rows[3][rows[:, -1]]
    c0, c1 = gplan.cols[0][cols[:, 0]], gplan.cols[3][cols[:, -1]]
    taps_r, taps_c = gplan.rows[:, rows], gplan.cols[:, cols]  # (4, blocks, ring)
    fits = bool(
        (r1 - r0 + 1 <= FOOTPRINT_MAX[0]).all() and (c1 - c0 + 1 <= FOOTPRINT_MAX[1]).all()
        and (taps_r.min(axis=(0, 2)) >= r0).all() and (taps_r.max(axis=(0, 2)) <= r1).all()
        and (taps_c.min(axis=(0, 2)) >= c0).all() and (taps_c.max(axis=(0, 2)) <= c1).all())
    return Footprint(r0=r0, h=r1 - r0 + 1, c0=c0, w=c1 - c0 + 1, fits=fits)


@functools.lru_cache(maxsize=64)
def _device_tables(gplan: GatherPlan, device: torch.device):
    """The plan's tables on ``device`` (copied once per plan and device; a
    captured graph holds them, ``capture.keep``)."""
    profiling.count("plans_built")
    return tuple(torch.as_tensor(a, device=device) for a in (gplan.rows, gplan.cols, gplan.py, gplan.px))


def _prepare(image, out_size, con, rcon, apply_rcas, compute_dtype, prologue, out_dtype, row_plan):
    if apply_rcas and rcon is None:
        raise ValueError("apply_rcas=True requires rcon")
    if image.dim() < 3 or image.shape[-3] not in (3, 4):
        raise ValueError(f"image must be (..., 3 or 4, H, W), got {tuple(image.shape)}")
    if compute_dtype not in pad.FLOAT_DTYPES:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    if not fused.out_dtype_ok(out_dtype, compute_dtype):
        raise ValueError(f"out_dtype must be uint8/uint16 or match compute_dtype, got {out_dtype}")
    if prologue not in ("none", "srtm"):
        raise ValueError(f"unknown prologue {prologue!r}")
    out_hw = (int(out_size[0]), int(out_size[1]))
    in_hw = (int(image.shape[-2]), int(image.shape[-1]))
    sharp = float(rcon.sharpness) if rcon is not None else 1.0
    if row_plan is None:
        if not supported(tuple(image.shape), out_hw, con, compute_dtype):
            raise ValueError(f"K2 takes upscales only (1x-4x area), got {in_hw} -> {out_hw}")
        return plan(in_hw, out_hw, con), out_hw, sharp, out_dtype or compute_dtype
    # A strip's tables (shard_plan) must fit the strip: no bounds logic on the loads.
    if not plan_fits(row_plan, in_hw, out_hw):
        raise ValueError(f"row_plan does not fit a {in_hw} source and a {out_hw} output")
    return row_plan, out_hw, sharp, out_dtype or compute_dtype


def easu_gather_reference(
    image: torch.Tensor,
    out_size: Tuple[int, int],
    con: EasuConstants,
    rcon: Optional[RcasConstants] = None,
    apply_rcas: bool = False,
    denoise: bool = False,
    compute_dtype=torch.float32,
    *,
    epilogue=None,
    frame=None,
    grain=None,
    prologue: str = "none",
    out_dtype=None,
    dither_page=None,
    row_plan: Optional[GatherPlan] = None,
    row_offset: int = 0,
) -> torch.Tensor:
    """Plain version of K2, on any device: the source as the kernel loads
    it (rounded to the storage dtype, or a decoded byte; a
    ``halo.StripSource`` first read by ``halo.halo_rows_reference``), then
    ``fused.easu_rcas_reference`` on the plan's clipped tap indices, the
    epilogue and one store."""
    if isinstance(image, halo.StripSource):
        image = halo.halo_rows_reference(image)
    gplan, out_hw, sharp, out_dt = _prepare(image, out_size, con, rcon, apply_rcas, compute_dtype,
                                            prologue, out_dtype, row_plan)
    epi = epilogue_mod.bind(epilogue, out_hw, frame, grain, dither_page, image.device, row_offset)
    dev = image.device
    rows, cols, py, px = (torch.as_tensor(a, device=dev) for a in (gplan.rows, gplan.cols, gplan.py, gplan.px))
    res = fused.easu_rcas_reference(
        epilogue_mod.decode(image, compute_dtype), rows.long(), cols.long(), py, px, sharp,
        apply_rcas, denoise, prologue == "srtm",
    )
    return epilogue_mod.store(epilogue_mod.apply(res, epi), out_dt)


def easu_gather(
    image: torch.Tensor,
    out_size: Tuple[int, int],
    con: EasuConstants,
    rcon: Optional[RcasConstants] = None,
    apply_rcas: bool = False,
    denoise: bool = False,
    compute_dtype=torch.float32,
    *,
    epilogue=None,
    frame=None,
    grain=None,
    prologue: str = "none",
    out_dtype=None,
    dither_page=None,
    row_plan: Optional[GatherPlan] = None,
    row_offset: int = 0,
) -> torch.Tensor:
    """EASU (+ RCAS when ``apply_rcas``) of a (..., C, Hin, Win) float32,
    bfloat16, float16 or uint8 image, C = 3 or 4, to (..., C, Hout, Wout) in
    ``out_dtype`` (default compute_dtype, the storage; the math is float32),
    with the prologue, the epilogue and RGBA's bilinear alpha inside.  A row
    strip passes its halo'd source, ``out_size`` (hl, Wout), its
    ``row_plan`` (``shard_plan``) and ``row_offset`` (its first global output
    row; ``grain`` is the strip's own rows); its source may be a
    ``halo.StripSource``, read in place from its parts (K2's strip-source
    form, the parts checked by ``halo.check``).  CUDA tensors launch
    ``csrc/easu_gather.cu``; CPU tensors run ``easu_gather_reference``."""
    kw = dict(epilogue=epilogue, frame=frame, grain=grain, prologue=prologue,
              out_dtype=out_dtype, dither_page=dither_page, row_plan=row_plan, row_offset=row_offset)
    if image.device.type == "cpu":
        return easu_gather_reference(image, out_size, con, rcon, apply_rcas, denoise, compute_dtype, **kw)
    if image.device.type != "cuda":
        raise ValueError(f"easu_gather takes a CPU or CUDA tensor, got {image.device}")
    strip = isinstance(image, halo.StripSource)
    if image.dtype not in fused.SOURCE_DTYPES:
        raise TypeError(f"gather kernel takes float32/bfloat16/float16/uint8 images, got {image.dtype}")
    gplan, (hout, wout), sharp, out_dt = _prepare(image, out_size, con, rcon, apply_rcas,
                                                  compute_dtype, prologue, out_dtype, row_plan)
    if not footprint(gplan).fits:
        raise ValueError(f"K2's blocks cannot stage the source footprint of this plan ({tuple(image.shape[-2:])} -> "
                         f"{(hout, wout)}): the constants' scale is a downscale, or its tables decrease")
    epi = epilogue_mod.bind(epilogue, (hout, wout), frame, grain, dither_page, image.device, row_offset)
    parts = halo.check(image) if strip else None
    if not strip:
        image = image.contiguous()
    *lead, nc, hin, win = image.shape
    out = torch.empty((*lead, nc, hout, wout), dtype=out_dt, device=image.device)
    if out.numel() == 0:
        return out
    rows, cols, py, px = capture.keep(_device_tables(gplan, image.device))
    from fsr_tpu_torch.kernels import _build

    lib = _build.library()
    cepi = epilogue_mod.c_params(epi)
    if strip:
        entry, first = lib.fsr_easu_gather_strip, ctypes.addressof(parts)
    else:
        entry, first = lib.fsr_easu_gather, image.data_ptr()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        with profiling.trace_annotation("fsr.launch", "kernel", "K2"):
            err = entry(
                first, out.data_ptr(), pad.DTYPE_CODES[image.dtype],
                pad.DTYPE_CODES[compute_dtype], pad.DTYPE_CODES[out_dt],
                math.prod(lead), nc, hin, win, hout, wout,
                rows.data_ptr(), cols.data_ptr(), py.data_ptr(), px.data_ptr(),
                sharp, int(apply_rcas), int(denoise), int(prologue == "srtm"),
                ctypes.addressof(cepi), stream,
            )
    if err != 0:
        raise RuntimeError(f"gather kernel launch failed: cudaError {err}")
    return out
