"""Colour transfer functions (linear <-> encoded), torch, dtype-generic.

Counterpart of ``fsr_tpu/core/transfer.py``, the ffx_a.h colour-conversion
block (ffx_a.h:2117-2292): Rec.709, sRGB, PQ, generic gamma, gamma 2.0
("two") and gamma 3.0 ("three").  ``to_*`` is linear -> encoded, ``from_*``
encoded -> linear.  The piecewise sRGB/709 curves keep the spec constants
and are branch-free through a select.  Also the fast PQ approximations
(ffx_a.h:1865-1914), whose bit tricks run through the unsigned-wrap helpers
of ``core/approx.py``.

Every constant enters the arithmetic rounded to the tensor's dtype, as the
JAX package's ``jnp.asarray(v, x.dtype)`` rounds it.
"""

from __future__ import annotations

import torch

from fsr_tpu_torch.core import approx

__all__ = [
    "to_709", "from_709",
    "to_srgb", "from_srgb",
    "to_pq", "from_pq",
    "to_gamma", "from_gamma",
    "to_two", "from_two",
    "to_three", "from_three",
    "prx_pq_to_gamma2", "prx_pq_to_linear",
    "prx_lo_gamma2_to_pq", "prx_med_gamma2_to_pq",
    "prx_lo_linear_to_pq", "prx_med_linear_to_pq",
]


def _c(x: torch.Tensor, v: float) -> torch.Tensor:
    # A 0-d tensor of x's dtype filled on x's device: no host copy, so a
    # captured graph may hold it.
    return torch.full((), v, dtype=x.dtype, device=x.device)


def to_709(c: torch.Tensor) -> torch.Tensor:
    """Linear -> Rec.709 (ATo709F* analog), the spec's piecewise form."""
    lin = c * _c(c, 4.5)
    cur = torch.pow(c, _c(c, 0.45)) * _c(c, 1.099) + _c(c, -0.099)
    return torch.where(c < _c(c, 0.018), lin, cur)


def from_709(c: torch.Tensor) -> torch.Tensor:
    """Rec.709 -> linear (AFrom709F* analog; the spec's threshold 0.081 on
    the encoded value)."""
    lin = c * _c(c, 1.0 / 4.5)
    cur = torch.pow(c * _c(c, 1.0 / 1.099) + _c(c, 0.099 / 1.099), _c(c, 1.0 / 0.45))
    return torch.where(c < _c(c, 0.081), lin, cur)


def to_srgb(c: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB (AToSrgbF* analog), the spec's piecewise form."""
    lin = c * _c(c, 12.92)
    cur = torch.pow(c, _c(c, 1.0 / 2.4)) * _c(c, 1.055) + _c(c, -0.055)
    return torch.where(c < _c(c, 0.0031308), lin, cur)


def from_srgb(c: torch.Tensor) -> torch.Tensor:
    """sRGB -> linear (the spec's threshold 0.04045 on the encoded value)."""
    lin = c * _c(c, 1.0 / 12.92)
    cur = torch.pow(c * _c(c, 1.0 / 1.055) + _c(c, 0.055 / 1.055), _c(c, 2.4))
    return torch.where(c < _c(c, 0.04045), lin, cur)


def to_pq(x: torch.Tensor) -> torch.Tensor:
    """Linear -> PQ/ST.2084 (AToPqF1, ffx_a.h:2178); 1.0 == 10000 cd/m^2."""
    p = torch.pow(x, _c(x, 0.159302))
    return torch.pow((_c(x, 0.835938) + _c(x, 18.8516) * p) / (_c(x, 1.0) + _c(x, 18.6875) * p),
                     _c(x, 78.8438))


def from_pq(x: torch.Tensor) -> torch.Tensor:
    """PQ -> linear (AFromPqF1, ffx_a.h:2213)."""
    p = torch.pow(x, _c(x, 0.0126833))
    num = torch.clamp(p - _c(x, 0.835938), min=0.0)
    return torch.pow(num / (_c(x, 18.8516) - _c(x, 18.6875) * p), _c(x, 6.27739))


def to_gamma(c: torch.Tensor, rcp_x: float) -> torch.Tensor:
    """Linear -> gamma; rcp_x = 1/gamma (AToGammaF*, ffx_a.h:2175)."""
    return torch.pow(c, _c(c, rcp_x))


def from_gamma(c: torch.Tensor, x: float) -> torch.Tensor:
    return torch.pow(c, _c(c, x))


def to_two(c: torch.Tensor) -> torch.Tensor:
    """Linear -> gamma 2.0: sqrt (the FSR chain's working encoding)."""
    return torch.sqrt(c)


def from_two(c: torch.Tensor) -> torch.Tensor:
    return c * c


def to_three(c: torch.Tensor) -> torch.Tensor:
    return torch.pow(c, _c(c, 1.0 / 3.0))


def from_three(c: torch.Tensor) -> torch.Tensor:
    return c * c * c


# --- fast PQ approximations (ffx_a.h:1865-1914) ------------------------------


def _quart(a):
    a = a * a
    return a * a


def _oct(a):
    a = a * a
    a = a * a
    return a * a


def prx_pq_to_gamma2(a: torch.Tensor) -> torch.Tensor:
    return _quart(a)


def prx_pq_to_linear(a: torch.Tensor) -> torch.Tensor:
    return _oct(a)


def _bits_shift_add(a, shift, magic):
    """float32(uint32(a) >> shift + magic) in ``a``'s dtype."""
    u = approx._bits(a.to(torch.float32))
    return approx._float((u >> shift) + magic, torch.float32).to(a.dtype)


def prx_lo_gamma2_to_pq(a: torch.Tensor) -> torch.Tensor:
    return _bits_shift_add(a, 2, 0x2F9A4E46)


def prx_med_gamma2_to_pq(a: torch.Tensor) -> torch.Tensor:
    b = _bits_shift_add(a, 2, 0x2F9A4E46)
    b4 = _quart(b)
    return b - b * (b4 - a) / (_c(a, 4.0) * b4)


def prx_lo_linear_to_pq(a: torch.Tensor) -> torch.Tensor:
    return _bits_shift_add(a, 3, 0x378D8723)


def prx_med_linear_to_pq(a: torch.Tensor) -> torch.Tensor:
    b = _bits_shift_add(a, 3, 0x378D8723)
    b8 = _oct(b)
    return b - b * (b8 - a) / (_c(a, 8.0) * b8)
