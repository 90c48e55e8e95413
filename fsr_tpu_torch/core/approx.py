"""Bit-trick fast approximations (torch, float32 and float16), mirroring
ffx_a.h:1786-1860.

Counterpart of ``fsr_tpu/core/approx.py``.  EASU uses APrxLoRcp/APrxLoRsq in
its direction normalisation (ffx_fsr1.h:392,400,409) and RCAS uses
APrxMedRcp in its resolve (ffx_fsr1.h:765); fidelity to the oracle depends
on evaluating the same bit tricks rather than native division.  float16
takes the FsrEasuH/FsrRcasH magic numbers.

torch has no general uint32 or uint16 arithmetic, so the float bits are read
through ``view(torch.int32)`` (``view(torch.int16)``) and the arithmetic
runs in int64 (int32) modulo 2**32 (2**16), which is exactly the unsigned
wrap of the reference for every input, negative and NaN included.  The
right shift of APrxLoRsq/APrxLoSqrt is therefore a logical shift.

``rcp_fast`` is exact ``1/a`` here: the TPU's approximate reciprocal plus a
Newton step existed only because the TPU has no vector divide.
"""

from __future__ import annotations

import torch

__all__ = [
    "prx_lo_rcp",
    "prx_med_rcp",
    "prx_lo_rsq",
    "prx_lo_sqrt",
    "rcp",
    "rcp_fast",
    "sat",
]

# (lo_rcp, med_rcp, lo_rsq, lo_sqrt) magic numbers (ffx_a.h).
_MAGIC = {
    torch.float32: (0x7EF07EBB, 0x7EF19FFF, 0x5F347D74, 0x1FBC4639),
    torch.float16: (0x7784, 0x778D, 0x59A3, 0x1DE2),
}
# float dtype -> (integer view, wider integer for the arithmetic, bit width)
_INT = {
    torch.float32: (torch.int32, torch.int64, 32),
    torch.float16: (torch.int16, torch.int32, 16),
}


def _magic(x: torch.Tensor):
    """``x``'s magic numbers; only float32 and float16 have them."""
    if x.dtype not in _MAGIC:
        raise TypeError(f"bit-trick approximations need float32/float16, got {x.dtype}")
    return _MAGIC[x.dtype]


def _bits(x: torch.Tensor) -> torch.Tensor:
    """The float bits as unsigned values in the wider integer type."""
    view, wide, n = _INT[x.dtype]
    return x.contiguous().view(view).to(wide) & ((1 << n) - 1)


def _float(u: torch.Tensor, dt) -> torch.Tensor:
    """Integer values (any, taken modulo 2**n) -> ``dt`` with those bits."""
    view, _, n = _INT[dt]
    u = u & ((1 << n) - 1)
    u = torch.where(u >= (1 << (n - 1)), u - (1 << n), u)
    return u.to(view).view(dt)


def prx_lo_rcp(a: torch.Tensor) -> torch.Tensor:
    """APrxLoRcp: 1-op reciprocal estimate (positive inputs)."""
    return _float(_magic(a)[0] - _bits(a), a.dtype)


def prx_med_rcp(a: torch.Tensor) -> torch.Tensor:
    """APrxMedRcp: reciprocal estimate + one Newton-Raphson step, each
    operation rounded to ``a``'s dtype."""
    b = _float(_magic(a)[1] - _bits(a), a.dtype)
    return b * (-b * a + 2.0)


def prx_lo_rsq(a: torch.Tensor) -> torch.Tensor:
    """APrxLoRsq: 2-op rsqrt estimate (positive inputs)."""
    return _float(_magic(a)[2] - (_bits(a) >> 1), a.dtype)


def prx_lo_sqrt(a: torch.Tensor) -> torch.Tensor:
    """APrxLoSqrt: 2-op sqrt estimate (positive inputs)."""
    return _float((_bits(a) >> 1) + _magic(a)[3], a.dtype)


def rcp(a: torch.Tensor) -> torch.Tensor:
    """High-precision reciprocal (ARcp semantics): exact ``1/a``."""
    return 1.0 / a


# The kernels' "high precision" reciprocal: the same correctly rounded 1/a.
rcp_fast = rcp


def sat(a: torch.Tensor) -> torch.Tensor:
    """ASat: clamp to [0, 1]."""
    return torch.clamp(a, 0.0, 1.0)
