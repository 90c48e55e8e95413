"""K1: fused EASU+RCAS for integer per-axis ratios (CUDA kernel).

Counterpart of ``fsr_tpu/kernels/fused.py:upscale_fused``.  When the
output->input mapping ``x -> floor(x*sx + ox)`` advances by exactly one
source texel every q output pixels (true for the exact-binary 2x
Performance preset, and checked against the float32 coordinate tables on
the host), output pixels split into qy*qx phase classes with constant
subpixel fractions.  The kernel takes those per-phase source offsets and
fractions from the host and never recomputes coordinates on the device.

Data flow: ``upscale_fused`` plans the phases and launches K1 on the
image itself: K1 stages each block's source window in shared memory with
every texel index clamped to the image, which is K4's edge pad
(``pad.edge_pad``) folded into the load: no pad pass runs in front of it.  At the 2x Performance structure (``quad_ok``) K1 runs one
thread per 2x2 quad of outputs that share one 'f' texel; every other phase
structure runs its generic staged path (``path="generic"`` forces it).
``upscale_padded`` runs the same kernel on a source that K4 already padded
(the clamp never fires there; the measurement tools use it).  Every K1
launch, from either entry point, is counted in ``upscale_padded.launches``
when the wrapper launches it: under CUDA graph capture (``utils/capture.py``)
that is at capture, and a replay counts nothing (read its launches from a
trace).
The math is float32 throughout; bfloat16 is storage only (a float32 source
under bfloat16 storage rounds at its load, as K4's convert did).  A float16
image (``SOURCE_DTYPES``) widens exactly at its load, or rounds there to
bfloat16 storage, on whole frames and row strips alike.  For CPU
tensors both run their plain versions (``upscale_fused_reference``: K4's
and K1's plain versions; ``upscale_padded_reference``).

Options, as the JAX kernel takes them: a uint8 image (decoded at its
load), the SRTM prologue (``prologue="srtm"``, once per staged texel), the K5
epilogue (``kernels/epilogue.py``: ``epilogue``, ``frame``, ``grain`` in
plain output space, ``dither_page``) on the float32 result, and
``out_dtype`` uint8/uint16 (UNORM codes of the float32 value).  An RGBA
image (..., 4, H, W) goes through the same launch: alpha is resolved
bilinearly in the kernel's store pass from the staged window, never
sharpened, tonemapped or touched by the epilogue, and stored by the
colour's rule (``easu_rcas_reference`` is its plain version).

Row strips (``row_offset``/``global_rows``, fused.py:412-437 in the JAX
package; ``parallel/spatial.py`` calls them): the output is rows
``row_offset`` .. ``row_offset + Hout - 1`` of a frame of ``global_rows``
rows, from a source strip with halo rows around it and shard-local
constants (``parallel.spatial._local_constants``).  The RCAS ring computes
the neighbour rows from the halo, and clamps only at global row 0 and
``global_rows - 1``; the epilogue's dither takes global rows.  K1 stores
the strip's own rows, no ring rows.  The strip's source is one halo'd
tensor, or a ``halo.StripSource`` (the strip above's rows, its own, the
strip below's), which K1's strip-source form reads in place: the halo rows
of H1 with no copy, bit-equal to K1 on the halo'd tensor.

The TPU kernel's tile plans, riffles, row packing, in-kernel pad and
software pipeline are TPU layout machinery with no counterpart here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch

from fsr_tpu_torch.core import easu_math
from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import epilogue as epilogue_mod
from fsr_tpu_torch.kernels import halo, pad
from fsr_tpu_torch.ops import extras
from fsr_tpu_torch.ops.easu import easu_coords
from fsr_tpu_torch.ops.rcas import shift_clamped

__all__ = [
    "supported",
    "FusedPlan",
    "plan",
    "upscale_padded",
    "upscale_padded_reference",
    "easu_rcas_reference",
    "upscale_fused",
    "upscale_fused_reference",
    "ring_rows",
    "TILE",
    "WINDOW_MAX",
    "quad_ok",
    "source_plan",
    "window",
    "SOURCE_DTYPES",
]

# The image types K1 and K2 take, on a whole frame and on a row strip.
SOURCE_DTYPES = pad.FLOAT_DTYPES + (torch.float16, torch.uint8)

_QX_SUPPORTED = (1, 2, 4)
_QY_SUPPORTED = (1, 2, 4)


@functools.lru_cache(maxsize=64)
def _phase_structure(con: EasuConstants, out_size: Tuple[int, int]):
    """Validate unit-stride phase structure against the ground-truth coords.

    Returns (qy, qx, ry, rx, py_phase, px_phase) or None, with tuples for
    the per-phase values.  r*(b) is the integer source texel of phase b at
    block index 0; fx(qx*j + b) must equal j + rx(b) *exactly* (checked
    against easu_coords, not assumed).  Cached per configuration, as the
    JAX package's trace-time check runs once per compiled shape, so
    ``out_size`` must be a hashable (hout, wout) tuple.
    """
    hout, wout = out_size
    fx, fy, px, py = easu_coords(con, out_size)

    def axis(f, frac, n, qs):
        for q in qs:
            if n % q:
                continue
            j = np.arange(n // q)
            r, ph, ok = [], [], True
            for b in range(q):
                sel_f = f[b::q]
                sel_p = frac[b::q]
                if not (np.all(sel_f == sel_f[0] + j) and np.all(sel_p == sel_p[0])):
                    ok = False
                    break
                r.append(int(sel_f[0]))
                ph.append(np.float32(sel_p[0]))
            if ok:
                return q, tuple(r), tuple(ph)
        return None

    ax = axis(fx, px, wout, _QX_SUPPORTED)
    ay = axis(fy, py, hout, _QY_SUPPORTED)
    if ax is None or ay is None:
        return None
    qx, rx, px_phase = ax
    qy, ry, py_phase = ay
    if qx == 1 and qy == 1:
        return None  # 1x-ish: the ops path is fine and simpler
    return qy, qx, ry, rx, py_phase, px_phase


def out_dtype_ok(out_dtype, compute_dtype) -> bool:
    """The stores K1 and K2 make: the storage type, or uint8/uint16 codes."""
    return out_dtype in (None, torch.uint8, torch.uint16, compute_dtype)


def supported(in_shape, out_size, con: EasuConstants, compute_dtype, out_dtype=None) -> bool:
    """True when K1 takes this configuration: RGB or RGBA, float32/bfloat16
    storage, an output of the storage type or uint8/uint16 codes, and an
    integer phase structure (qy, qx in {1, 2, 4}, not both 1)."""
    if len(in_shape) < 3 or in_shape[-3] not in (3, 4):
        return False
    if compute_dtype not in pad.FLOAT_DTYPES or not out_dtype_ok(out_dtype, compute_dtype):
        return False
    if min(out_size) < 1:
        return False
    return _phase_structure(con, (int(out_size[0]), int(out_size[1]))) is not None


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """Host plan for one K1 configuration.

    ry/rx: padded-frame row/column of each phase's 'f' texel at plane
    index 0; py/px: each phase's constant subpixel fraction; pads: the K4
    pad (top, bottom, left, right) of the source.
    """

    qy: int
    qx: int
    ry: Tuple[int, ...]
    rx: Tuple[int, ...]
    py: Tuple[float, ...]
    px: Tuple[float, ...]
    pads: Tuple[int, int, int, int]


def plan(in_hw: Tuple[int, int], out_size: Tuple[int, int], con: EasuConstants) -> FusedPlan:
    """Phase structure and pad amounts of K1 on a K4-padded source
    (``upscale_padded``; ``source_plan`` shifts the offsets to the unpadded
    image that ``upscale_fused`` gives K1).

    As at fused.py:526-544, the leading pad per axis is lead = 2 - r_min
    (taps reach one texel before 'f' and the RCAS ring one plane row before
    the tile); the trailing pad covers the taps' reach of two texels after
    'f' of the plane row/column one past the last.  A negative lead (a DRS
    offset pushing the taps inside the image) pads nothing and shifts the
    phase offsets instead of cropping.
    """
    st = _phase_structure(con, (int(out_size[0]), int(out_size[1])))
    if st is None:
        raise ValueError("unsupported scale for the fused kernel (use impl='torch')")
    qy, qx, ry, rx, py, px = st
    hin, win = in_hw
    hpl, wpl = out_size[0] // qy, out_size[1] // qx
    pt = max(0, 2 - min(ry))
    pl = max(0, 2 - min(rx))
    pb = max(0, hpl + max(ry) + 3 - hin)
    pr = max(0, wpl + max(rx) + 3 - win)
    return FusedPlan(
        qy=qy,
        qx=qx,
        ry=tuple(r + pt for r in ry),
        rx=tuple(r + pl for r in rx),
        py=tuple(float(v) for v in py),
        px=tuple(float(v) for v in px),
        pads=(pt, pb, pl, pr),
    )


def ring_rows(hout: int, row_offset: int = 0, global_rows=None) -> Tuple[int, int]:
    """(ylo, yhi): the rows the RCAS ring of an ``hout``-row output clamps
    to, when the output is rows ``row_offset`` .. ``row_offset + hout - 1``
    of a ``global_rows``-row frame (default: the whole frame).  -1 and
    ``hout`` where the strip has a neighbour row, else its edge row."""
    global_rows = hout if global_rows is None else int(global_rows)
    row_offset = int(row_offset)
    if row_offset < 0 or row_offset + hout > global_rows:
        raise ValueError(f"rows {row_offset}..{row_offset + hout - 1} are not in a {global_rows}-row frame")
    return (0 if row_offset == 0 else -1), (hout - 1 if row_offset + hout == global_rows else hout)


def _taps(q, r, idx):
    """'f' index of each output position idx (may be -1): floor(idx / q) +
    r[idx mod q]."""
    return idx // q + np.asarray(r, np.int64)[idx % q]


def _axis_tables(q, r, frac, idx, device):
    """Per output row/column index in ``idx``: the padded-frame indices of
    the four taps around 'f' (offsets -1..2, shape (4, n)) and the subpixel
    fraction."""
    f = _taps(q, r, idx)
    p = np.asarray(frac, np.float32)[idx % q]
    taps = f[None, :] + np.arange(-1, 3)[:, None]
    return torch.as_tensor(taps, device=device), torch.as_tensor(p, device=device)


def _row_index(hout, ylo, yhi):
    """Output rows -1 .. hout, each clamped to the ring's [ylo, yhi]."""
    return np.clip(np.arange(-1, hout + 1), ylo, yhi)


def easu_rcas_reference(
    srcf: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    ppy: torch.Tensor,
    ppx: torch.Tensor,
    sharpness: float,
    apply_rcas: bool = True,
    denoise: bool = False,
    srtm: bool = False,
) -> torch.Tensor:
    """The float32 math of K1 and K2 on a (..., 3 or 4, H, W) source as the
    kernels load it (``epilogue.decode``): the SRTM prologue when ``srtm``,
    the kernels' ``fast`` forms, per-texel quad responses, RCAS on the
    unrounded EASU values with the border clamped in output coordinates.
    Returns the unrounded float32 result (the epilogue and the one store
    follow).  Alpha (channel 3) is the bilinear of ``ops.easu.bilinear``
    from the taps at offsets 0 and 1 of the same tables, in its op order;
    it is never tonemapped nor sharpened.

    rows (4, Hout + 2) / cols (4, Wout): the source row/column of the taps at
    offsets -1..2 around each output pixel's 'f' texel, the rows for output
    rows -1 .. Hout (the RCAS ring's, where the caller's border rule has
    made a row outside the frame repeat its edge row); ppy (Hout + 2,) /
    ppx (Wout,): the float32 subpixel fractions.  Returns Hout rows.
    """
    alpha = None
    if srcf.shape[-3] == 4:
        a = srcf[..., 3, :, :]
        r0, r1, c0, c1 = rows[1][1:-1, None], rows[2][1:-1, None], cols[1][None, :], cols[2][None, :]
        tl, tr, bl, br = a[..., r0, c0], a[..., r0, c1], a[..., r1, c0], a[..., r1, c1]
        top = tl + (tr - tl) * ppx[None, :]
        bot = bl + (br - bl) * ppx[None, :]
        alpha = (top + (bot - top) * ppy[1:-1, None])[..., None, :, :]
        srcf = srcf[..., :3, :, :]
    if srtm:
        srcf = extras.srtm(srcf)
    taps = {
        name: srcf[..., rows[dy + 1][:, None], cols[dx + 1][None, :]]
        for name, (dx, dy) in easu_math.TAP_OFFSETS.items()
    }
    lum = {k: v[..., 2, :, :] * 0.5 + (v[..., 0, :, :] * 0.5 + v[..., 1, :, :]) for k, v in taps.items()}
    quad_g = {
        qk: easu_math.easu_texel_response(*(lum[n] for n in names), fast=True)
        for qk, names in easu_math.EASU_QUADS
    }
    out = easu_math.easu_resolve(
        taps, ppx[None, :], ppy[:, None], dtype=torch.float32, fast=True, quad_g=quad_g
    )
    e = out[..., 1:-1, :]
    if apply_rcas:
        e = easu_math.rcas_resolve(
            out[..., :-2, :],
            shift_clamped(e, 0, -1),
            e,
            shift_clamped(e, 0, 1),
            out[..., 2:, :],
            sharpness,
            denoise=denoise,
            fast=True,
        )
    return e if alpha is None else torch.cat([e, alpha], dim=-3)


def _check_prologue(prologue):
    if prologue not in ("none", "srtm"):
        raise ValueError(f"unknown prologue {prologue!r}")


def _out_dtype(padded_dtype, out_dtype):
    """K1's output type for a padded source: the source's float type by
    default; a byte source stores float32, bfloat16 or codes."""
    if padded_dtype == torch.float16:
        raise TypeError("K4 pads to float32/bfloat16/uint8: K1 takes a float16 image through upscale_fused")
    if out_dtype is None:
        if padded_dtype == torch.uint8:
            raise ValueError("a uint8 source needs an explicit out_dtype")
        return padded_dtype
    ok = (torch.float32, torch.bfloat16) if padded_dtype == torch.uint8 else (padded_dtype,)
    if out_dtype not in ok + (torch.uint8, torch.uint16):
        raise ValueError(f"K1 stores {padded_dtype} as {ok} or uint8/uint16 codes, not {out_dtype}")
    return out_dtype


def upscale_padded_reference(
    padded: torch.Tensor,
    fplan: FusedPlan,
    out_size: Tuple[int, int],
    sharpness: float,
    apply_rcas: bool = True,
    denoise: bool = False,
    *,
    prologue: str = "none",
    epi=None,
    out_dtype=None,
    row_offset: int = 0,
    global_rows=None,
) -> torch.Tensor:
    """Plain version of K1: ``easu_rcas_reference`` with the phase plan's
    padded-frame tap indices (the ring's rows clamped by ``ring_rows``),
    then ``epilogue.apply`` (``epi``: bound ``EpilogueArgs``) and one store
    in ``out_dtype`` (default: the padded source's float type)."""
    _check_prologue(prologue)
    out_dtype = _out_dtype(padded.dtype, out_dtype)
    hout, wout = out_size
    ylo, yhi = ring_rows(hout, row_offset, global_rows)
    dev = padded.device
    rows, ppy = _axis_tables(fplan.qy, fplan.ry, fplan.py, _row_index(hout, ylo, yhi), dev)
    cols, ppx = _axis_tables(fplan.qx, fplan.rx, fplan.px, np.arange(wout), dev)
    res = easu_rcas_reference(epilogue_mod.decode(padded), rows, cols, ppy, ppx, sharpness,
                              apply_rcas, denoise, prologue == "srtm")
    return epilogue_mod.store(epilogue_mod.apply(res, epi), out_dtype)


# K1's output tile (csrc/fused.cu FSR_K1_TILE_H, FSR_K1_TILE_W) and the
# largest source window a block stages on each path: quad, its ring's 16 x 16
# quads and their taps; generic, one 'f' per ring position and its taps.
TILE = (30, 30)
WINDOW_MAX = {"quad": ((TILE[0] + 2) // 2 + 3, (TILE[1] + 2) // 2 + 3),
              "generic": (TILE[0] + 5, TILE[1] + 5)}
# The quad path's fractions: 'f' phase 0 (even outputs) and phase 1 (odd).
QUAD_FRACTIONS = (np.float32(0.75), np.float32(0.25))


def _quad_axis(q, r, frac) -> bool:
    return (q == 2 and r[1] == r[0] + 1
            and all(np.float32(f).view(np.uint32) == c.view(np.uint32) for f, c in zip(frac, QUAD_FRACTIONS)))


def quad_ok(fplan: FusedPlan) -> bool:
    """True when K1 takes its quad path for this plan: 2x on both axes, the
    fractions 0.75 and 0.25 bit for bit and 'f' of phase 1 one past phase
    0's, so that outputs 2j+1 and 2j+2 share 'f' j + r[1] at fractions 0.25
    and 0.75 (csrc/fused.cu:quad_axis)."""
    return _quad_axis(fplan.qy, fplan.ry, fplan.py) and _quad_axis(fplan.qx, fplan.rx, fplan.px)


def source_plan(fplan: FusedPlan) -> FusedPlan:
    """The plan with its 'f' offsets in the unpadded source (the padded
    offsets less the leading pads; they may be negative) and no pads: what
    K1 takes on the image itself, every texel index clamped to it."""
    pt, _, pl, _ = fplan.pads
    return dataclasses.replace(fplan, ry=tuple(r - pt for r in fplan.ry), rx=tuple(r - pl for r in fplan.rx),
                               pads=(0, 0, 0, 0))


def window(q, r, n_out, tile) -> Tuple[np.ndarray, np.ndarray]:
    """The numpy mirror of csrc/fused.cu:stage on one axis: per block of
    ``tile`` outputs of ``n_out``, the first source index of its window (the
    'f' of ring position y0 - 1, less one) and its extent (to the 'f' of
    ring position y0 + tile, plus two).  Source indices, before the clamp."""
    y0 = np.arange(0, n_out, tile)
    lo = _taps(q, r, y0 - 1) - 1
    return lo, _taps(q, r, y0 + tile) + 2 - lo + 1


def _check_window(fplan: FusedPlan, out_size, path: str) -> None:
    """Raise unless every block's window fits the kernel's maximum for the
    path (the kernel traps otherwise)."""
    for axis, (q, r, n, t) in enumerate(((fplan.qy, fplan.ry, out_size[0], TILE[0]),
                                         (fplan.qx, fplan.rx, out_size[1], TILE[1]))):
        ext = int(window(q, r, n, t)[1].max())
        if ext > WINDOW_MAX[path][axis]:
            raise ValueError(f"K1's {path} window needs {ext} source {'rows' if axis == 0 else 'columns'} "
                             f"per block, more than its {WINDOW_MAX[path][axis]}")


def _pick_path(fplan: FusedPlan, path: str) -> str:
    if path not in ("auto", "generic"):
        raise ValueError(f"path must be 'auto' or 'generic', got {path!r}")
    return "quad" if path == "auto" and quad_ok(fplan) else "generic"


@functools.lru_cache(maxsize=64)
def _checked_path(fplan: FusedPlan, out_size: Tuple[int, int], path: str) -> str:
    """The path K1 takes for this plan and output, after the window check:
    once per configuration, off the per-call host work."""
    path = _pick_path(fplan, path)
    _check_window(fplan, out_size, path)
    return path


def _launch(src, fplan, dtype, out_size, sharpness, apply_rcas, denoise, prologue, epi, out_dtype,
            row_offset, global_rows, path) -> torch.Tensor:
    """Launch K1 on ``src``: a CUDA tensor (..., C, H, W), whose texels the
    plan's 'f' offsets index (clamped to its extent), or a
    ``halo.StripSource`` on a card (its virtual halo'd strip, read in place);
    ``dtype`` the storage type a float32 source rounds to."""
    strip = isinstance(src, halo.StripSource)
    if src.device.type != "cuda":
        raise ValueError(f"K1 takes a CPU or CUDA tensor, got {src.device}")
    if src.dtype not in SOURCE_DTYPES:
        raise TypeError(f"fused kernel takes float32/bfloat16/float16/uint8 sources, got {src.dtype}")
    if src.dim() < 3 or src.shape[-3] not in (3, 4) or not (strip or src.is_contiguous()):
        raise ValueError(f"fused kernel needs a contiguous (..., 3 or 4, H, W) tensor, got {tuple(src.shape)}")
    parts = halo.check(src) if strip else None
    _check_prologue(prologue)
    hout, wout = (int(v) for v in out_size)
    ylo, yhi = ring_rows(hout, row_offset, global_rows)
    path = _checked_path(fplan, (hout, wout), path)
    *lead, nc, hin, win = src.shape
    if hin == 0 or win == 0:
        raise ValueError("fused kernel needs a non-empty source")
    out = torch.empty((*lead, nc, hout, wout), dtype=out_dtype, device=src.device)
    nb = math.prod(lead)
    if out.numel() == 0:
        return out
    from fsr_tpu_torch.kernels import _build

    lib = _build.library()
    ry = (ctypes.c_int * 4)(*fplan.ry)
    rx = (ctypes.c_int * 4)(*fplan.rx)
    py = (ctypes.c_float * 4)(*fplan.py)
    px = (ctypes.c_float * 4)(*fplan.px)
    cepi = epilogue_mod.c_params(epi)
    codes = pad.DTYPE_CODES
    if strip:
        entry, first = lib.fsr_upscale_fused_strip, ctypes.addressof(parts)
    else:
        entry, first = lib.fsr_upscale_fused, src.data_ptr()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = entry(
            first, out.data_ptr(), codes[src.dtype], codes[dtype], codes[out_dtype], nb, nc, hin, win,
            hout, wout, fplan.qy, fplan.qx, ry, rx, py, px, float(sharpness), int(apply_rcas), int(denoise),
            int(prologue == "srtm"), ylo, yhi, int(path == "quad"), ctypes.addressof(cepi), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused kernel launch failed: cudaError {err}")
    upscale_padded.launches += 1
    return out


def upscale_padded(
    padded: torch.Tensor,
    fplan: FusedPlan,
    out_size: Tuple[int, int],
    sharpness: float,
    apply_rcas: bool = True,
    denoise: bool = False,
    *,
    prologue: str = "none",
    epi=None,
    out_dtype=None,
    row_offset: int = 0,
    global_rows=None,
    path: str = "auto",
) -> torch.Tensor:
    """K1 on the K4-padded source (..., C, Hp, Wp), C = 3 or 4, of float32,
    bfloat16 or uint8 -> (..., C, Hout, Wout) in ``out_dtype``; the output
    is rows ``row_offset`` .. of a ``global_rows``-row frame (default: the
    whole frame).  CUDA tensors launch ``csrc/fused.cu`` (``path``: "auto",
    the quad path where ``quad_ok``, or "generic"); CPU tensors run
    ``upscale_padded_reference``.
    ``upscale_padded.launches`` counts every K1 launch the wrapper makes
    (a captured graph's at capture, none at its replays)."""
    if padded.device.type == "cpu":
        return upscale_padded_reference(padded, fplan, out_size, sharpness, apply_rcas, denoise,
                                        prologue=prologue, epi=epi, out_dtype=out_dtype,
                                        row_offset=row_offset, global_rows=global_rows)
    out_dtype = _out_dtype(padded.dtype, out_dtype)
    hout, wout = (int(v) for v in out_size)
    ylo, yhi = ring_rows(hout, row_offset, global_rows)
    hp, wp = padded.shape[-2:]
    # The plan's reach must fit the padded extent, so that the clamp never fires.
    if not (_covers(fplan.qy, fplan.ry, ylo, yhi, hp) and _covers(fplan.qx, fplan.rx, 0, wout - 1, wp)):
        raise ValueError("padded source does not cover the plan's tap reach")
    dtype = padded.dtype if padded.dtype in pad.FLOAT_DTYPES else torch.float32
    return _launch(padded, fplan, dtype, (hout, wout), sharpness, apply_rcas, denoise, prologue, epi, out_dtype,
                   row_offset, global_rows, path)


upscale_padded.launches = 0


def _covers(q, r, lo, hi, n) -> bool:
    """True when the taps (offsets -1..2 around 'f') of output positions
    lo..hi all lie in [0, n).  'f' advances by one every q positions, so its
    least and greatest values lie in the first and the last q positions."""
    idx = np.concatenate([np.arange(lo, min(lo + q, hi + 1)), np.arange(max(hi - q + 1, lo), hi + 1)])
    f = _taps(q, r, idx)
    return int(f.min()) >= 1 and int(f.max()) + 2 < n


def _prepare(image, out_size, con, compute_dtype, out_dtype):
    if image.dim() < 3 or image.shape[-3] not in (3, 4):
        raise ValueError(f"image must be (..., 3 or 4, H, W), got {tuple(image.shape)}")
    if compute_dtype not in pad.FLOAT_DTYPES:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    if not out_dtype_ok(out_dtype, compute_dtype):
        raise ValueError(f"out_dtype must be uint8/uint16 or match compute_dtype, got {out_dtype}")
    storage = torch.uint8 if image.dtype == torch.uint8 else compute_dtype
    return plan(tuple(image.shape[-2:]), out_size, con), storage, out_dtype or compute_dtype


def upscale_fused(
    image: torch.Tensor,
    out_size: Tuple[int, int],
    con: EasuConstants,
    rcon: RcasConstants,
    apply_rcas: bool = True,
    denoise: bool = False,
    compute_dtype=torch.float32,
    *,
    epilogue=None,
    frame=None,
    grain=None,
    prologue: str = "none",
    out_dtype=None,
    dither_page=None,
    row_offset: int = 0,
    global_rows=None,
    path: str = "auto",
) -> torch.Tensor:
    """Fused EASU(+RCAS): K1 upscales the (..., C, Hin, Win) image, C = 3 or
    4, float32, bfloat16, float16 or uint8, with the edge clamp, the storage rounding (a uint8 image stays bytes),
    the prologue, the epilogue and RGBA's alpha inside: one launch on a CUDA
    tensor (``path``: "auto", the quad path where ``quad_ok``, or
    "generic"), the plain version on a CPU tensor.  Returns (..., C, Hout, Wout) in ``out_dtype`` (default
    compute_dtype, the storage; the math is float32).  A row strip passes
    its halo'd source, shard-local constants, ``row_offset`` and
    ``global_rows`` (``grain`` is then the strip's own rows); its source may
    be a ``halo.StripSource``, its rows read in place from their parts (on
    a card, K1's strip-source form, the parts checked by ``halo.check``; on
    the CPU, ``halo.halo_rows_reference`` then the plain version)."""
    if image.device.type == "cpu":
        return upscale_fused_reference(image, out_size, con, rcon, apply_rcas, denoise, compute_dtype,
                                       epilogue=epilogue, frame=frame, grain=grain, prologue=prologue,
                                       out_dtype=out_dtype, dither_page=dither_page, row_offset=row_offset,
                                       global_rows=global_rows)
    fplan, storage, out_dt = _prepare(image, out_size, con, compute_dtype, out_dtype)
    epi = epilogue_mod.bind(epilogue, out_size, frame, grain, dither_page, image.device, row_offset)
    sharp = float(rcon.sharpness) if rcon is not None else 1.0
    dtype = storage if storage in pad.FLOAT_DTYPES else torch.float32
    src = image if isinstance(image, halo.StripSource) else image.contiguous()
    return _launch(src, source_plan(fplan), dtype, out_size, sharp, apply_rcas, denoise, prologue, epi, out_dt,
                   row_offset, global_rows, path)


def upscale_fused_reference(
    image: torch.Tensor,
    out_size: Tuple[int, int],
    con: EasuConstants,
    rcon: RcasConstants,
    apply_rcas: bool = True,
    denoise: bool = False,
    compute_dtype=torch.float32,
    *,
    epilogue=None,
    frame=None,
    grain=None,
    prologue: str = "none",
    out_dtype=None,
    dither_page=None,
    row_offset: int = 0,
    global_rows=None,
) -> torch.Tensor:
    """Plain version of ``upscale_fused`` (K4 and K1 plain versions), on
    any device; a ``halo.StripSource`` is first read by its plain version,
    ``halo.halo_rows_reference``."""
    if isinstance(image, halo.StripSource):
        image = halo.halo_rows_reference(image)
    fplan, storage, out_dt = _prepare(image, out_size, con, compute_dtype, out_dtype)
    epi = epilogue_mod.bind(epilogue, out_size, frame, grain, dither_page, image.device, row_offset)
    padded = pad.edge_pad_reference(image, fplan.pads, storage)
    sharp = float(rcon.sharpness) if rcon is not None else 1.0
    return upscale_padded_reference(padded, fplan, out_size, sharp, apply_rcas, denoise, prologue=prologue,
                                    epi=epi, out_dtype=out_dt, row_offset=row_offset, global_rows=global_rows)
