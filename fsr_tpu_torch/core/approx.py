"""Bit-trick fast approximations (torch, float32), mirroring ffx_a.h:1786-1860.

Counterpart of ``fsr_tpu/core/approx.py``.  EASU uses APrxLoRcp/APrxLoRsq in
its direction normalisation (ffx_fsr1.h:392,400,409) and RCAS uses
APrxMedRcp in its resolve (ffx_fsr1.h:765); fidelity to the oracle depends
on evaluating the same bit tricks rather than native division.

torch has no general uint32 arithmetic, so the float bits are read through
``view(torch.int32)`` and the arithmetic runs in int64 modulo 2**32, which
is exactly the uint32 wrap of the reference for every input, negative and
NaN included.  The right shift of APrxLoRsq/APrxLoSqrt is therefore a
logical shift.

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

# (lo_rcp, med_rcp, lo_rsq, lo_sqrt) magic numbers for float32 (ffx_a.h).
_MAGIC_F32 = (0x7EF07EBB, 0x7EF19FFF, 0x5F347D74, 0x1FBC4639)
_U32 = 1 << 32


def _u32(x: torch.Tensor) -> torch.Tensor:
    """float32 bits as int64 values in [0, 2**32)."""
    if x.dtype != torch.float32:
        raise TypeError(f"bit-trick approximations need float32, got {x.dtype}")
    return x.contiguous().view(torch.int32).to(torch.int64) & (_U32 - 1)


def _f32(u: torch.Tensor) -> torch.Tensor:
    """int64 values (any, taken modulo 2**32) -> float32 with those bits."""
    u = u & (_U32 - 1)
    u = torch.where(u >= (1 << 31), u - _U32, u)
    return u.to(torch.int32).view(torch.float32)


def prx_lo_rcp(a: torch.Tensor) -> torch.Tensor:
    """APrxLoRcp: 1-op reciprocal estimate (positive inputs)."""
    return _f32(_MAGIC_F32[0] - _u32(a))


def prx_med_rcp(a: torch.Tensor) -> torch.Tensor:
    """APrxMedRcp: reciprocal estimate + one Newton-Raphson step."""
    b = _f32(_MAGIC_F32[1] - _u32(a))
    return b * (-b * a + 2.0)


def prx_lo_rsq(a: torch.Tensor) -> torch.Tensor:
    """APrxLoRsq: 2-op rsqrt estimate (positive inputs)."""
    return _f32(_MAGIC_F32[2] - (_u32(a) >> 1))


def prx_lo_sqrt(a: torch.Tensor) -> torch.Tensor:
    """APrxLoSqrt: 2-op sqrt estimate (positive inputs)."""
    return _f32((_u32(a) >> 1) + _MAGIC_F32[3])


def rcp(a: torch.Tensor) -> torch.Tensor:
    """High-precision reciprocal (ARcp semantics): exact ``1/a``."""
    return 1.0 / a


# The kernels' "high precision" reciprocal: the same correctly rounded 1/a.
rcp_fast = rcp


def sat(a: torch.Tensor) -> torch.Tensor:
    """ASat: clamp to [0, 1]."""
    return torch.clamp(a, 0.0, 1.0)
