"""Plain-torch EASU (any device, any scale factor).

Counterpart of ``fsr_tpu/ops/easu.py``: tap planes are materialised with
index-tensor gathers from separable per-axis index vectors (pp.x depends
only on the output column, pp.y only on the output row), then the shared
filter math (``fsr_tpu_torch.core.easu_math``) runs on them.  This is the
portable path; the hand-written kernels are the performance path.

Reference: FsrEasuF (ffx_fsr1.h:315-437).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from fsr_tpu_torch.core import easu_math
from fsr_tpu_torch.core.constants import EasuConstants
from fsr_tpu_torch.utils import capture, profiling

__all__ = ["easu", "easu_coords", "bilinear"]


def easu_coords(con: EasuConstants, out_size: Tuple[int, int]):
    """Per-axis coordinate vectors: ('f' texel index, subpixel frac).

    Numpy float32 on the host — identical arithmetic to the oracle
    (scalar.py:_easu_coords), so tap indices can never disagree, and no
    device recomputes ``x*sx+ox`` (an FMA contraction there flips floor()
    at integer positions).
    """
    hout, wout = out_size
    sx, sy = con.scale
    ox, oy = con.offset
    ppx = np.arange(wout, dtype=np.float32) * sx + ox
    ppy = np.arange(hout, dtype=np.float32) * sy + oy
    fx = np.floor(ppx)
    fy = np.floor(ppy)
    px = (ppx - fx).astype(np.float32)
    py = (ppy - fy).astype(np.float32)
    return fx.astype(np.int32), fy.astype(np.int32), px, py


def _index(v: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(v.astype(np.int64), device=device)


_OFFSETS = range(-1, 3)  # tap offsets around 'f'


def _tap_rows(row: np.ndarray, hin: int, device) -> dict:
    """Offset -> the rows of that tap, clamped to the source (the CLAMP
    sampler), as index tensors on ``device``."""
    return {d: _index(np.clip(row + d, 0, hin - 1), device) for d in _OFFSETS}


@functools.lru_cache(maxsize=64)
def _tables(con: EasuConstants, out_size: Tuple[int, int], in_hw: Tuple[int, int], device: torch.device):
    """The plan of an ``in_hw`` -> ``out_size`` upscale under ``con`` on
    ``device``: the tap columns and rows per offset (``_tap_rows``) and the
    (1, Wout) and (Hout, 1) fractions, built on the host and copied once per
    configuration and device, so that a call copies nothing to the device
    (a captured graph holds them, ``capture.keep``).  Read only."""
    profiling.count("plans_built")
    col, row, px, py = easu_coords(con, out_size)
    return (_tap_rows(col, in_hw[1], device), _tap_rows(row, in_hw[0], device),
            torch.as_tensor(px, device=device)[None, :], torch.as_tensor(py, device=device)[:, None])


def _plan(src: torch.Tensor, out_size, con: EasuConstants, rows):
    """(tap columns, tap rows, px, py) of ``_tables`` for ``src``; a row
    override (``easu(rows=)``) replaces the rows and their fractions."""
    hin, win = (int(v) for v in src.shape[-2:])
    cols, trows, ppx, ppy = capture.keep(_tables(con, (int(out_size[0]), int(out_size[1])), (hin, win), src.device))
    if rows is not None:
        row, ppy = _rows(rows, out_size[0], src.device)
        trows = _tap_rows(row, hin, src.device)
    return cols, trows, ppx, ppy


def _rows(rows, n: int, device):
    """The vertical plan: the 'f' row of each of the n output rows, as a
    host int array, and its float32 fractions as a (n, 1) tensor."""
    row, py = (np.asarray(torch.as_tensor(v).cpu()) for v in rows)
    if row.shape != (n,) or py.shape != (n,):
        raise ValueError(f"rows= needs two length-{n} vectors, got {row.shape} and {py.shape}")
    return row.astype(np.int64), torch.as_tensor(py.astype(np.float32), device=device)[:, None]


def easu(
    src: torch.Tensor,
    out_size: Tuple[int, int],
    con: EasuConstants,
    compute_dtype=torch.float32,
    precision: str = "mixed",
    rows=None,
) -> torch.Tensor:
    """EASU upscale.

    src: (..., 3, Hin, Win) planar image, values in [0, 1].
    out_size: (Hout, Wout).
    compute_dtype: float32 (FsrEasuF parity), float16 or bfloat16 (colour
      accumulation in that dtype).
    precision: "mixed" (default) keeps the direction/length estimation in
      float32 under a 16-bit compute_dtype; "strict" runs everything in
      compute_dtype, which with float16 is FsrEasuH (ffx_fsr1.h:505-593).
    rows: optional (row_idx, py_rows) override of the vertical plan: for
      each of the Hout output rows, its base source row (an index into
      ``src``) and its float32 fraction.  Row-sharded execution
      (``parallel/spatial.py``) passes values taken from the GLOBAL mapping,
      never recomputed from shard-local constants; tap rows still clamp into
      ``src`` (a strip at the frame's top or bottom carries edge-replicated
      halo rows, so the clamp is the sampler's CLAMP).

    Returns (..., 3, Hout, Wout) in compute_dtype.
    """
    if precision not in ("mixed", "strict"):
        raise ValueError(f"precision must be 'mixed' or 'strict', got {precision!r}")
    dir_dtype = compute_dtype if precision == "strict" else torch.float32
    cols, trows, ppx, ppy = _plan(src, out_size, con, rows)
    src = src.to(compute_dtype)
    taps = {name: src[..., trows[dy][:, None], cols[dx][None, :]]
            for name, (dx, dy) in easu_math.TAP_OFFSETS.items()}
    return easu_math.easu_resolve(taps, ppx, ppy, dtype=compute_dtype, dir_dtype=dir_dtype)


def bilinear(src: torch.Tensor, out_size: Tuple[int, int], con: EasuConstants, rows=None) -> torch.Tensor:
    """Bilinear fallback using the same coordinate mapping (the sample's
    SAMPLE_BILINEAR mode, FSR_Pass.hlsl:70-73).  rows: the vertical
    override of ``easu(rows=)``."""
    cols, trows, pxb, pyb = _plan(src, out_size, con, rows)
    c0, c1, r0, r1 = cols[0], cols[1], trows[0], trows[1]
    tl = src[..., r0[:, None], c0[None, :]]
    tr = src[..., r0[:, None], c1[None, :]]
    bl = src[..., r1[:, None], c0[None, :]]
    br = src[..., r1[:, None], c1[None, :]]
    top = tl + (tr - tl) * pxb
    bot = bl + (br - bl) * pxb
    return top + (bot - top) * pyb
