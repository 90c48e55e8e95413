"""Plain-torch RCAS (FsrRcasF semantics, ffx_fsr1.h:684-769).

Counterpart of ``fsr_tpu/ops/rcas.py``.  The 5-tap cross is materialised
with shifted planes, then the shared resolve math runs on them.

Border note: the reference *sample* reads out-of-bounds via imageLoad, which
returns zeros; that darkens the 1-pixel border.  The default is edge-clamp;
``border="zero"`` reproduces the sample's behaviour for A/B parity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fsr_tpu_torch.core import easu_math
from fsr_tpu_torch.core.constants import RcasConstants

__all__ = ["rcas", "rcas_strip", "shift_clamped"]


def shift_clamped(img: torch.Tensor, dy: int, dx: int, border: str = "clamp") -> torch.Tensor:
    """result[..., y, x] = img[..., clamp(y+dy), clamp(x+dx)] (border
    "clamp"), or 0 outside the image (border "zero")."""
    if border not in ("clamp", "zero"):
        raise ValueError(f"border must be 'clamp' or 'zero', got {border!r}")
    h, w = img.shape[-2:]
    if border == "zero":
        out = F.pad(img, (max(0, -dx), max(0, dx), max(0, -dy), max(0, dy)))
        return out[..., max(0, dy) : max(0, dy) + h, max(0, dx) : max(0, dx) + w]
    out = img
    if dy:
        r = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
        out = out.index_select(-2, r)
    if dx:
        c = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
        out = out.index_select(-1, c)
    return out


def rcas(
    img: torch.Tensor,
    con: RcasConstants,
    denoise: bool = False,
    compute_dtype=None,
    border: str = "clamp",
) -> torch.Tensor:
    """RCAS sharpen.

    img: (..., C, H, W) with C=3, or C=4 for alpha passthrough
    (FSR_RCAS_PASSTHROUGH_ALPHA, ffx_fsr1.h:688-705).
    compute_dtype: the arithmetic's dtype (default: the image's); float16
    is FsrRcasH, with the sharpness read as a half (ffx_fsr1.h:857).
    """
    dt = compute_dtype if compute_dtype is not None else img.dtype
    rgb = img[..., :3, :, :].to(dt)
    b = shift_clamped(rgb, -1, 0, border)
    d = shift_clamped(rgb, 0, -1, border)
    f = shift_clamped(rgb, 0, 1, border)
    h = shift_clamped(rgb, 1, 0, border)
    sharp = con.sharpness_f16 if dt == torch.float16 else con.sharpness
    out = easu_math.rcas_resolve(b, d, rgb, f, h, float(sharp), denoise=denoise)
    if img.shape[-3] == 4:
        out = torch.cat([out, img[..., 3:4, :, :].to(dt)], dim=-3)
    return out


def rcas_strip(easu_out: torch.Tensor, con: RcasConstants, denoise: bool, compute_dtype) -> torch.Tensor:
    """RCAS over a row strip's rows given its EASU rows -1 .. hl (the torch
    path of a row-sharded call).  The row plans repeat the frame's edge row
    outside it, so the global top and bottom rows see e in place of their
    missing neighbour, as ``rcas`` clamps them."""
    e = easu_out[..., 1:-1, :]
    sharp = con.sharpness_f16 if compute_dtype == torch.float16 else con.sharpness
    return easu_math.rcas_resolve(easu_out[..., :-2, :], shift_clamped(e, 0, -1), e, shift_clamped(e, 0, 1),
                                  easu_out[..., 2:, :], float(sharp), denoise=denoise)
