"""Host-side constant setup for the FSR algorithms (numpy, no framework).

Copy of ``fsr_tpu/core/constants.py``: the reference's constant-buffer
packing (``FsrEasuCon`` / ``FsrEasuConOffset`` / ``FsrRcasCon``,
ffx_fsr1.h:156-225,662-672) kept as plain float32 values.  ``as_uint4()``
reproduces the reference's bit-packed layout for parity tests.

``constants_from_jax`` turns the JAX package's constants (passed as the
plain dicts ``dataclasses.asdict`` gives) into this package's, so a caller
that built its constants with ``fsr_tpu`` carries them across unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import numpy as np

__all__ = [
    "EasuConstants",
    "RcasConstants",
    "FSR_RCAS_LIMIT",
    "constants_from_jax",
    "f32_to_f16_bits",
    "pack_h2",
]


def _f32(x) -> np.float32:
    return np.float32(x)


def _rcp(x) -> np.float32:
    # A_CPU ARcpF1 is 1/x computed in float32 (ffx_a.h CPU scalar ops).
    return np.float32(np.float32(1.0) / np.float32(x))


def f32_to_f16_bits(x: float) -> int:
    """float32 -> IEEE fp16 bit pattern (round-to-nearest-even)."""
    return int(np.float16(np.float32(x)).view(np.uint16))


def pack_h2(lo: float, hi: float) -> int:
    """Pack two fp16 values into a uint32 (lo in low bits), as AU1_AH2_AF2."""
    return f32_to_f16_bits(lo) | (f32_to_f16_bits(hi) << 16)


@dataclasses.dataclass(frozen=True)
class EasuConstants:
    """EASU coordinate-mapping constants (the float values of FsrEasuCon).

    - ``scale``  = con0.xy : output pixel -> input viewport pixel scale
    - ``offset`` = con0.zw : center alignment (+ optional DRS input offset)
    - ``inv_size`` = con1.xy : 1 / input container size
    """

    viewport: Tuple[float, float]  # (w, h) of the rendered region being upscaled
    input_size: Tuple[float, float]  # (w, h) of the resource holding it (DRS)
    output_size: Tuple[float, float]  # (w, h) of the upscaled output
    input_offset: Tuple[float, float] = (0.0, 0.0)  # DRS offset into resource

    @classmethod
    def create(
        cls,
        input_viewport_in_pixels: Tuple[int, int],  # (w, h)
        input_size_in_pixels: Tuple[int, int] | None = None,
        output_size_in_pixels: Tuple[int, int] = (0, 0),
        input_offset_in_pixels: Tuple[int, int] = (0, 0),
    ) -> "EasuConstants":
        if input_size_in_pixels is None:
            input_size_in_pixels = input_viewport_in_pixels
        return cls(
            viewport=(float(input_viewport_in_pixels[0]), float(input_viewport_in_pixels[1])),
            input_size=(float(input_size_in_pixels[0]), float(input_size_in_pixels[1])),
            output_size=(float(output_size_in_pixels[0]), float(output_size_in_pixels[1])),
            input_offset=(float(input_offset_in_pixels[0]), float(input_offset_in_pixels[1])),
        )

    @property
    def scale(self) -> Tuple[np.float32, np.float32]:
        vw, vh = self.viewport
        ow, oh = self.output_size
        return (
            np.float32(_f32(vw) * _rcp(ow)),
            np.float32(_f32(vh) * _rcp(oh)),
        )

    @property
    def offset(self) -> Tuple[np.float32, np.float32]:
        vw, vh = self.viewport
        ow, oh = self.output_size
        offx, offy = self.input_offset
        return (
            np.float32(_f32(0.5) * _f32(vw) * _rcp(ow) - _f32(0.5) + _f32(offx)),
            np.float32(_f32(0.5) * _f32(vh) * _rcp(oh) - _f32(0.5) + _f32(offy)),
        )

    @property
    def inv_size(self) -> Tuple[np.float32, np.float32]:
        iw, ih = self.input_size
        return (_rcp(iw), _rcp(ih))

    def as_uint4(self) -> np.ndarray:
        """con0..con3 packed exactly as FsrEasuCon writes them (4x uint32[4])."""

        def u(x: np.float32) -> np.uint32:
            return np.float32(x).view(np.uint32)

        sx, sy = self.scale
        ox, oy = self.offset
        rx, ry = self.inv_size
        con0 = [u(sx), u(sy), u(ox), u(oy)]
        con1 = [u(rx), u(ry), u(_f32(1.0) * rx), u(_f32(-1.0) * ry)]
        con2 = [u(_f32(-1.0) * rx), u(_f32(2.0) * ry), u(_f32(1.0) * rx), u(_f32(2.0) * ry)]
        con3 = [u(_f32(0.0) * rx), u(_f32(4.0) * ry), np.uint32(0), np.uint32(0)]
        return np.array([con0, con1, con2, con3], dtype=np.uint32)


@dataclasses.dataclass(frozen=True)
class RcasConstants:
    """RCAS sharpening constant.

    ``sharpness_stops``: 0.0 = maximum sharpness, N > 0 halves the
    sharpening N times (ffx_fsr1.h:662-672).  ``sharpness`` is the linear
    value exp2(-stops).
    """

    sharpness_stops: float = 0.0

    @property
    def sharpness(self) -> np.float32:
        return np.float32(np.exp2(np.float32(-self.sharpness_stops)))

    @property
    def sharpness_f16(self) -> np.float16:
        return np.float16(self.sharpness)

    def as_uint4(self) -> np.ndarray:
        """con packed exactly as FsrRcasCon writes it (uint32[4])."""
        s = self.sharpness
        return np.array(
            [s.view(np.uint32), np.uint32(pack_h2(float(s), float(s))), 0, 0],
            dtype=np.uint32,
        )


# Limit of the RCAS negative lobe (ffx_fsr1.h:654).
FSR_RCAS_LIMIT = 0.25 - 1.0 / 16.0


def constants_from_jax(
    easu_fields: Mapping, rcas_fields: Mapping
) -> Tuple[EasuConstants, RcasConstants]:
    """The JAX package's constants, as ``dataclasses.asdict`` gives them,
    turned into this package's ``(EasuConstants, RcasConstants)``."""
    con = EasuConstants(
        viewport=tuple(float(v) for v in easu_fields["viewport"]),
        input_size=tuple(float(v) for v in easu_fields["input_size"]),
        output_size=tuple(float(v) for v in easu_fields["output_size"]),
        input_offset=tuple(float(v) for v in easu_fields.get("input_offset", (0.0, 0.0))),
    )
    rcon = RcasConstants(sharpness_stops=float(rcas_fields["sharpness_stops"]))
    return con, rcon
