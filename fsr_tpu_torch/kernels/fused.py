"""K1: fused EASU+RCAS for integer per-axis ratios (CUDA kernel).

Counterpart of ``fsr_tpu/kernels/fused.py:upscale_fused``.  When the
output->input mapping ``x -> floor(x*sx + ox)`` advances by exactly one
source texel every q output pixels (true for the exact-binary 2x
Performance preset, and checked against the float32 coordinate tables on
the host), output pixels split into qy*qx phase classes with constant
subpixel fractions.  The kernel takes those per-phase source offsets and
fractions from the host and never recomputes coordinates on the device.

Data flow: ``upscale_fused`` plans the phases and the pad, runs K4
(``pad.edge_pad``) to make the padded storage-dtype source, then K1
(``upscale_padded``), whose launches are counted in
``upscale_padded.launches``.  The math is float32 throughout; bfloat16 is
storage only.  For CPU tensors both steps run their plain versions
(``edge_pad_reference``, ``upscale_padded_reference``).

The TPU kernel's tile plans, riffles, row packing, in-kernel pad and
software pipeline are TPU layout machinery with no counterpart here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from fsr_tpu_torch.core import easu_math
from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import pad
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
]

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


def supported(in_shape, out_size, con: EasuConstants, compute_dtype) -> bool:
    """True when K1 takes this configuration: RGB, float32/bfloat16, and an
    integer phase structure (qy, qx in {1, 2, 4}, not both 1)."""
    if len(in_shape) < 3 or in_shape[-3] != 3:
        return False
    if compute_dtype not in (torch.float32, torch.bfloat16):
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
    """Phase structure and pad amounts for K4+K1.

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


def _axis_tables(q, r, frac, n, device):
    """Per output row/column: the padded-frame indices of the four taps
    around 'f' (offsets -1..2, shape (4, n)) and the subpixel fraction."""
    idx = np.arange(n)
    f = idx // q + np.asarray(r, np.int64)[idx % q]
    p = np.asarray(frac, np.float32)[idx % q]
    taps = f[None, :] + np.arange(-1, 3)[:, None]
    return torch.as_tensor(taps, device=device), torch.as_tensor(p, device=device)


def easu_rcas_reference(
    src: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    ppy: torch.Tensor,
    ppx: torch.Tensor,
    sharpness: float,
    apply_rcas: bool = True,
    denoise: bool = False,
) -> torch.Tensor:
    """The float32 math of K1 and K2 on a (..., 3, H, W) source in its
    storage dtype: the kernels' ``fast`` forms, per-texel quad responses,
    RCAS on the unrounded EASU values with the border clamped in output
    coordinates, one rounding at the end to ``src.dtype``.

    rows (4, Hout) / cols (4, Wout): the source row/column of the taps at
    offsets -1..2 around each output pixel's 'f' texel; ppy (Hout,) / ppx
    (Wout,): the float32 subpixel fractions.
    """
    srcf = src.to(torch.float32)
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
    if apply_rcas:
        out = easu_math.rcas_resolve(
            shift_clamped(out, -1, 0),
            shift_clamped(out, 0, -1),
            out,
            shift_clamped(out, 0, 1),
            shift_clamped(out, 1, 0),
            sharpness,
            denoise=denoise,
            fast=True,
        )
    return out.to(src.dtype)


def upscale_padded_reference(
    padded: torch.Tensor,
    fplan: FusedPlan,
    out_size: Tuple[int, int],
    sharpness: float,
    apply_rcas: bool = True,
    denoise: bool = False,
) -> torch.Tensor:
    """Plain version of K1 (``easu_rcas_reference`` with the phase plan's
    padded-frame tap indices); the result is in ``padded.dtype``."""
    hout, wout = out_size
    dev = padded.device
    rows, ppy = _axis_tables(fplan.qy, fplan.ry, fplan.py, hout, dev)
    cols, ppx = _axis_tables(fplan.qx, fplan.rx, fplan.px, wout, dev)
    return easu_rcas_reference(padded, rows, cols, ppy, ppx, sharpness, apply_rcas, denoise)


def upscale_padded(
    padded: torch.Tensor,
    fplan: FusedPlan,
    out_size: Tuple[int, int],
    sharpness: float,
    apply_rcas: bool = True,
    denoise: bool = False,
) -> torch.Tensor:
    """K1 on the K4-padded source (..., 3, Hp, Wp) -> (..., 3, Hout, Wout)
    in the source's dtype (float32 or bfloat16).  CUDA tensors launch
    ``csrc/fused.cu``; CPU tensors run ``upscale_padded_reference``."""
    if padded.device.type == "cpu":
        return upscale_padded_reference(padded, fplan, out_size, sharpness, apply_rcas, denoise)
    if padded.device.type != "cuda":
        raise ValueError(f"upscale_padded takes a CPU or CUDA tensor, got {padded.device}")
    if padded.dtype not in pad.DTYPE_CODES:
        raise TypeError(f"fused kernel takes float32/bfloat16 storage, got {padded.dtype}")
    if padded.dim() < 3 or padded.shape[-3] != 3 or not padded.is_contiguous():
        raise ValueError(f"fused kernel needs a contiguous (..., 3, H, W) tensor, got {tuple(padded.shape)}")
    hout, wout = (int(v) for v in out_size)
    *lead, _, hp, wp = padded.shape
    # The plan's reach must fit the padded extent: no bounds logic on the loads.
    if (max(fplan.ry) + (hout - 1) // fplan.qy + 2 >= hp or min(fplan.ry) < 1
            or max(fplan.rx) + (wout - 1) // fplan.qx + 2 >= wp or min(fplan.rx) < 1):
        raise ValueError("padded source does not cover the plan's tap reach")
    out = torch.empty((*lead, 3, hout, wout), dtype=padded.dtype, device=padded.device)
    nb = padded.numel() // (3 * hp * wp)
    if out.numel() == 0:
        return out
    from fsr_tpu_torch.kernels import _build

    lib = _build.library()
    ry = (ctypes.c_int * 4)(*fplan.ry)
    rx = (ctypes.c_int * 4)(*fplan.rx)
    py = (ctypes.c_float * 4)(*fplan.py)
    px = (ctypes.c_float * 4)(*fplan.px)
    with torch.cuda.device(padded.device):
        stream = torch.cuda.current_stream(padded.device).cuda_stream
        err = lib.fsr_upscale_fused(
            padded.data_ptr(), out.data_ptr(), pad.DTYPE_CODES[padded.dtype], nb, hp, wp,
            hout, wout, fplan.qy, fplan.qx, ry, rx, py, px, float(sharpness),
            int(apply_rcas), int(denoise), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused kernel launch failed: cudaError {err}")
    upscale_padded.launches += 1
    return out


upscale_padded.launches = 0


def _prepare(image, out_size, con, compute_dtype):
    if image.dim() < 3 or image.shape[-3] != 3:
        raise ValueError(f"image must be (..., 3, H, W), got {tuple(image.shape)}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    return plan(tuple(image.shape[-2:]), out_size, con)


def upscale_fused(
    image: torch.Tensor,
    out_size: Tuple[int, int],
    con: EasuConstants,
    rcon: RcasConstants,
    apply_rcas: bool = True,
    denoise: bool = False,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Fused EASU(+RCAS): K4 pads the (..., 3, Hin, Win) image into the
    storage dtype, K1 upscales it.  Returns (..., 3, Hout, Wout) in
    compute_dtype (storage; the math is float32)."""
    fplan = _prepare(image, out_size, con, compute_dtype)
    padded = pad.edge_pad(image.contiguous(), fplan.pads, compute_dtype)
    sharp = float(rcon.sharpness) if rcon is not None else 1.0
    return upscale_padded(padded, fplan, out_size, sharp, apply_rcas, denoise)


def upscale_fused_reference(
    image: torch.Tensor,
    out_size: Tuple[int, int],
    con: EasuConstants,
    rcon: RcasConstants,
    apply_rcas: bool = True,
    denoise: bool = False,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Plain version of ``upscale_fused`` (K4 and K1 plain versions), on
    any device."""
    fplan = _prepare(image, out_size, con, compute_dtype)
    padded = pad.edge_pad_reference(image, fplan.pads, compute_dtype)
    sharp = float(rcon.sharpness) if rcon is not None else 1.0
    return upscale_padded_reference(padded, fplan, out_size, sharp, apply_rcas, denoise)
