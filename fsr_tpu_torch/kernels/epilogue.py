"""K5: the output epilogue fused into the stores of K1 and K2.

Counterpart of ``fsr_tpu/kernels/epilogue.py``.  The reference ships
SRTM^-1, LFGA and TEPD as inline shader helpers meant to run inside the
caller's passes (ffx_fsr1.h:990-1199; the sample ends its tonemapping pass
with FsrTepdC10F, FSR_Tonemapping.hlsl:86-88).  Here they run on each
output pixel's float32 result just before the kernel's single store
(``epilogue()`` in ``csrc/fsr_pixel.cuh``), followed by the UNORM encode
when the output is uint8 or uint16: no extra pass over the frame.

``Epilogue`` is the frozen configuration; ``bind`` validates the call-time
operands (frame, grain, dither page) into an ``EpilogueArgs`` that the
plain versions and the torch path pass to ``apply`` and the CUDA wrappers
turn into the C struct (``c_params``).  ``apply`` is the plain torch
version of the per-pixel epilogue: the ``ops.extras`` chain in float32.
The frame may be a 0-d integer tensor on the output's device, as JAX's
traced ``frame``: the kernels then read it through a device pointer
(``EpilogueParams.frame_dev``), so a captured graph reads each replay's
frame and no call reads it back to the host.

The grain is plain output-space (3, Hout, Wout) and a dither page of any
shape (th, tw) tiles the output as page[y % th, x % tw]; the TPU's
phase-planar grain and its 128-wide page restriction have no counterpart.
A row strip of a row-sharded frame (``parallel/spatial.py``) binds its
global row origin ``row0``: the TEPD hash and the page then take global rows
(y + row0), while the grain is the strip's own rows.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from fsr_tpu_torch.ops import extras

__all__ = [
    "Epilogue",
    "EpilogueArgs",
    "bind",
    "apply",
    "decode",
    "store",
    "c_params",
    "encode_unorm_codes",
    "encode_unorm8",
    "encode_unorm10",
]

_TRANSFORMS = {"none": 0, "srtm_inv": 1, "gamma2": 2}
# float32(1/255), held exactly as a Python float (utils.image.from_uint8).
INV255 = float(np.float32(1.0 / 255.0))


def encode_unorm_codes(x: torch.Tensor, max_code: int) -> torch.Tensor:
    """D3D UNORM integer codes floor(sat(x)*max_code + 0.5) as int32,
    bit-equal to ``utils.image.to_uint8``/``to_uint10`` (NaN encodes as 0)."""
    v = torch.clamp(torch.nan_to_num(x.to(torch.float32)), 0.0, 1.0) * float(max_code)
    return torch.floor(v + 0.5).to(torch.int32)


def encode_unorm8(x: torch.Tensor) -> torch.Tensor:
    """uint8 UNORM encode."""
    return encode_unorm_codes(x, 255).to(torch.uint8)


def encode_unorm10(x: torch.Tensor) -> torch.Tensor:
    """10-bit UNORM codes in uint16 (the RGB10A2 render-target analog, the
    sample's HDR output format, SampleRenderer.cpp:193)."""
    return encode_unorm_codes(x, 1023).to(torch.uint16)


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Output-side post-ops fused into the kernel store.

    transform: "none" | "srtm_inv" (HDR out, FsrSrtmInvF ffx_fsr1.h:1044)
      | "gamma2" (gamma-2.0 -> linear squaring, FSR_Pass.hlsl:78-79).
    grain_amount: LFGA film grain strength (FsrLfgaF ffx_fsr1.h:1014);
      nonzero requires a grain operand at call time.
    dither_bits: 8 or 10 enables the TEPD golden-ratio dithered quantize
      (FsrTepdDitF/C8F/C10F ffx_fsr1.h:1086-1121); the hash takes a frame
      index at call time.  Exclusive with transform="srtm_inv" (TEPD
      expects {0..1} input, not HDR).
    dither_texture: dither positions from a texture page operand (the
      sample's temporal blue noise) instead of the hash.
    """

    transform: str = "none"
    grain_amount: float = 0.0
    dither_bits: Optional[int] = None
    dither_texture: bool = False

    def __post_init__(self):
        if self.transform not in _TRANSFORMS:
            raise ValueError(f"unknown epilogue transform {self.transform!r}")
        if self.dither_bits not in (None, 8, 10):
            raise ValueError("TEPD supports 8- or 10-bit output")
        if self.dither_bits is not None and self.transform == "srtm_inv":
            raise ValueError("TEPD dithering expects {0..1} input, not HDR out")
        if self.dither_texture and self.dither_bits is None:
            raise ValueError("dither_texture requires dither_bits")

    @property
    def needs_grain(self) -> bool:
        return self.grain_amount != 0.0

    @property
    def needs_frame(self) -> bool:
        return self.dither_bits is not None and not self.dither_texture

    @property
    def needs_dither_tex(self) -> bool:
        return self.dither_texture

    @property
    def is_noop(self) -> bool:
        return self.transform == "none" and not self.needs_grain and self.dither_bits is None


class _CEpilogue(ctypes.Structure):
    """``fsr::EpilogueParams`` in ``csrc/fsr_pixel.cuh``, field for field."""

    _fields_ = [
        ("grain", ctypes.c_void_p),
        ("page", ctypes.c_void_p),
        ("grain_amount", ctypes.c_float),
        ("transform", ctypes.c_int),
        ("dither_bits", ctypes.c_int),
        ("frame", ctypes.c_uint),
        ("page_h", ctypes.c_int),
        ("page_w", ctypes.c_int),
        ("row0", ctypes.c_int),
        ("frame_dev", ctypes.c_void_p),
    ]


@dataclasses.dataclass(frozen=True)
class EpilogueArgs:
    """An epilogue with its validated call-time operands.

    frame: the TEPD hash's frame index (0 when unused), a host int or a 0-d
    int32 tensor on the output's device (``extras.frame_index``); grain: float32
    (3, Hout, Wout) contiguous (``bind(grain_rows=True)``: its rows), or None;
    page: float32 (th, tw) contiguous dither positions, or None for the hash;
    row0: the global output row of the result's row 0 (a row strip's
    offset), for the dither positions.
    """

    epi: Epilogue
    frame: Union[int, torch.Tensor] = 0
    grain: Optional[torch.Tensor] = None
    page: Optional[torch.Tensor] = None
    row0: int = 0


def bind(epi: Optional[Epilogue], out_hw, frame=None, grain=None, dither_page=None,
         device=None, row0: int = 0, grain_rows: bool = False) -> Optional[EpilogueArgs]:
    """Validate an epilogue's operands for an (Hout, Wout) output on
    ``device`` whose row 0 is global output row ``row0``; None when there is
    nothing to apply.  grain_rows: a float32 grain whose rows are contiguous
    (a row strip's rows of the whole frame's grain, a view) is kept as it
    stands, for a kernel that reads it at its plane stride (K6's tail
    forms); any other grain is made contiguous."""
    if epi is None:
        return None
    if not isinstance(epi, Epilogue):
        raise TypeError(f"epilogue must be an Epilogue, got {type(epi).__name__}")
    if epi.is_noop:
        return None
    hout, wout = out_hw
    g = page = None
    if epi.needs_grain:
        if grain is None:
            raise ValueError("epilogue.grain_amount != 0 requires grain")
        g = torch.as_tensor(grain, device=device).to(torch.float32)
        if not (grain_rows and g.dim() == 3 and g.stride(-1) == 1 and g.stride(-2) == wout):
            g = g.contiguous()
        if tuple(g.shape) != (3, hout, wout):
            raise ValueError(f"grain must be (3, {hout}, {wout}), got {tuple(g.shape)}")
    if epi.needs_dither_tex:
        if dither_page is None:
            raise ValueError("epilogue.dither_texture requires dither_page")
        page = torch.as_tensor(dither_page, device=device).to(torch.float32).contiguous()
        if page.dim() != 2 or min(page.shape) < 1:
            raise ValueError(f"dither_page must be a (th, tw) page, got {tuple(page.shape)}")
    f = extras.frame_index(frame, device) if (epi.needs_frame and frame is not None) else 0
    if int(row0) < 0:
        raise ValueError(f"row0 must be >= 0, got {row0}")
    return EpilogueArgs(epi, f, g, page, int(row0))


def apply(res: torch.Tensor, args: Optional[EpilogueArgs]) -> torch.Tensor:
    """The epilogue on a float32 (..., 3, Hout, Wout) result, as the kernels
    run it per pixel: the transform, LFGA grain, then the TEPD quantize
    with hash or page dither positions at the pixel's output coordinates
    (rows from ``args.row0``).
    On (..., 4, Hout, Wout) the ops run on RGB and alpha rides through
    (fsr_tpu/kernels/fused.py:1052-1056, easu_gather.py:757-761)."""
    if args is None:
        return res
    if res.shape[-3] == 4:
        return torch.cat([apply(res[..., :3, :, :], args), res[..., 3:, :, :]], dim=-3)
    epi = args.epi
    x = res
    if epi.transform == "srtm_inv":
        x = extras.srtm_inv(x)
    elif epi.transform == "gamma2":
        x = x * x
    if epi.needs_grain:
        x = extras.lfga(x, args.grain, epi.grain_amount)
    if epi.dither_bits is not None:
        shape = tuple(x.shape[-2:])
        origin = (args.row0, 0)
        if epi.dither_texture:
            dit = extras.texture_dither(shape, 0, args.page, origin=origin)
        else:
            dit = extras.tepd_dither(shape, args.frame, origin=origin, device=x.device)
        x = extras.tepd_quantize(x, dit, bits=epi.dither_bits)
    return x


def c_params(args: Optional[EpilogueArgs]) -> _CEpilogue:
    """The C struct the CUDA wrappers pass by pointer (device pointers
    inside: a frame tensor goes in as ``frame_dev``, the host ``frame`` then
    0); all zeros, no epilogue, for None."""
    if args is None:
        return _CEpilogue()
    e = args.epi
    return _CEpilogue(
        grain=args.grain.data_ptr() if args.grain is not None else None,
        page=args.page.data_ptr() if args.page is not None else None,
        grain_amount=float(e.grain_amount) if e.needs_grain else 0.0,
        transform=_TRANSFORMS[e.transform],
        dither_bits=e.dither_bits or 0,
        frame_dev=args.frame.data_ptr() if isinstance(args.frame, torch.Tensor) else None,
        frame=args.frame % (1 << 32) if isinstance(args.frame, int) else 0,
        page_h=int(args.page.shape[0]) if args.page is not None else 0,
        page_w=int(args.page.shape[1]) if args.page is not None else 0,
        row0=args.row0,
    )


def decode(src: torch.Tensor, storage_dtype=None) -> torch.Tensor:
    """A kernel source as the kernels load it, in float32: a byte decodes
    v * float32(1/255) and is never rounded to the storage type; a float
    source rounds to ``storage_dtype`` (when given) first."""
    if src.dtype == torch.uint8:
        return src.to(torch.float32) * INV255
    if storage_dtype is not None:
        src = src.to(storage_dtype)
    return src.to(torch.float32)


def store(res: torch.Tensor, out_dtype) -> torch.Tensor:
    """A float32 result as the kernels store it: UNORM codes for uint8 and
    uint16, else one rounding to the float storage type; alpha, where there
    is one, by the same rule."""
    if out_dtype == torch.uint8:
        return encode_unorm8(res)
    if out_dtype == torch.uint16:
        return encode_unorm10(res)
    return res.to(out_dtype)
