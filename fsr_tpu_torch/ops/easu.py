"""Plain-torch EASU (any device, any scale factor).

Counterpart of ``fsr_tpu/ops/easu.py``: tap planes are materialised with
index-tensor gathers from separable per-axis index vectors (pp.x depends
only on the output column, pp.y only on the output row), then the shared
filter math (``fsr_tpu_torch.core.easu_math``) runs on them.  This is the
portable path; the hand-written kernels are the performance path.

Reference: FsrEasuF (ffx_fsr1.h:315-437).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fsr_tpu_torch.core import easu_math
from fsr_tpu_torch.core.constants import EasuConstants

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
    hin, win = src.shape[-2:]
    col, row, px, py = easu_coords(con, out_size)
    dev = src.device
    if rows is None:
        ppy = torch.as_tensor(py, device=dev)[:, None]
    else:
        row, ppy = _rows(rows, out_size[0], dev)
    src = src.to(compute_dtype)
    taps = {}
    for name, (dx, dy) in easu_math.TAP_OFFSETS.items():
        r = _index(np.clip(row + dy, 0, hin - 1), dev)
        c = _index(np.clip(col + dx, 0, win - 1), dev)
        taps[name] = src[..., r[:, None], c[None, :]]
    ppx = torch.as_tensor(px, device=dev)[None, :]
    return easu_math.easu_resolve(taps, ppx, ppy, dtype=compute_dtype, dir_dtype=dir_dtype)


def bilinear(src: torch.Tensor, out_size: Tuple[int, int], con: EasuConstants, rows=None) -> torch.Tensor:
    """Bilinear fallback using the same coordinate mapping (the sample's
    SAMPLE_BILINEAR mode, FSR_Pass.hlsl:70-73).  rows: the vertical
    override of ``easu(rows=)``."""
    hin, win = src.shape[-2:]
    col, row, px, py = easu_coords(con, out_size)
    dev = src.device
    if rows is None:
        pyb = torch.as_tensor(py, device=dev)[:, None]
    else:
        row, pyb = _rows(rows, out_size[0], dev)
    c0 = _index(np.clip(col, 0, win - 1), dev)
    c1 = _index(np.clip(col + 1, 0, win - 1), dev)
    r0 = _index(np.clip(row, 0, hin - 1), dev)
    r1 = _index(np.clip(row + 1, 0, hin - 1), dev)
    pxb = torch.as_tensor(px, device=dev)[None, :]
    tl = src[..., r0[:, None], c0[None, :]]
    tr = src[..., r0[:, None], c1[None, :]]
    bl = src[..., r1[:, None], c0[None, :]]
    br = src[..., r1[:, None], c1[None, :]]
    top = tl + (tr - tl) * pxb
    bot = bl + (br - bl) * pxb
    return top + (bot - top) * pyb
