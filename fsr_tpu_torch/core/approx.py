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

Differentiability: the integer views have no derivative, so each trick (and
``rcp``) is a ``torch.autograd.Function`` whose derivative is that of the
*ideal* function it approximates (d(1/a) = -1/a^2, ...), with non-finite
multipliers zeroed, as the JAX package's ``custom_jvp`` rules give them.
Forward values are the tricks' bits; ``torch.autograd`` and forward-mode
AD flow through the whole torch upscale path.
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
    "p_sin",
    "p_cos",
    "fis_to_u32",
    "fis_from_u32",
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


def _finite(m: torch.Tensor) -> torch.Tensor:
    """Zero non-finite gradient multipliers.

    The forward paths guard their degenerate inputs (EASU's direction
    zero-protect, RCAS's NaN-drop max), so the cotangent arriving at a
    degenerate point is already zero; without the guard the backward would
    still evaluate ``0 * inf = NaN`` there.  Zeroing the multiplier gives the
    conventional "flat at the guard" gradient."""
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def _ideal(trick, derivative, doc):
    """``trick`` as a differentiable function whose derivative is
    ``derivative``, the ideal function's, under ``_finite``: the forward
    value is the trick's, bit for bit; the integer views inside it carry
    no derivative of their own.  Reverse mode (``backward``) and forward
    mode (``jvp``) both use it."""

    class _Trick(torch.autograd.Function):
        @staticmethod
        def forward(a):
            return trick(a)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_backward(inputs[0])
            ctx.save_for_forward(inputs[0])

        @staticmethod
        def backward(ctx, g):
            (a,) = ctx.saved_tensors
            return g * _finite(derivative(a))

        @staticmethod
        def jvp(ctx, t):
            (a,) = ctx.saved_tensors
            return t * _finite(derivative(a))

    def fn(a: torch.Tensor) -> torch.Tensor:
        return _Trick.apply(a)

    fn.__name__ = trick.__name__.lstrip("_")
    fn.__doc__ = doc
    return fn


def _d_rcp(a):
    return -1.0 / (a * a)


def _d_rsq(a):
    return -0.5 * torch.rsqrt(a) / a


def _d_sqrt(a):
    return 0.5 * torch.rsqrt(a)


def _prx_lo_rcp(a):
    return _float(_magic(a)[0] - _bits(a), a.dtype)


def _prx_med_rcp(a):
    b = _float(_magic(a)[1] - _bits(a), a.dtype)
    return b * (-b * a + 2.0)


def _prx_lo_rsq(a):
    return _float(_magic(a)[2] - (_bits(a) >> 1), a.dtype)


def _prx_lo_sqrt(a):
    return _float((_bits(a) >> 1) + _magic(a)[3], a.dtype)


def _rcp(a):
    return 1.0 / a


prx_lo_rcp = _ideal(_prx_lo_rcp, _d_rcp, "APrxLoRcp: 1-op reciprocal estimate (positive inputs); d = -1/a^2.")
prx_med_rcp = _ideal(_prx_med_rcp, _d_rcp,
                     "APrxMedRcp: reciprocal estimate + one Newton-Raphson step, each operation rounded "
                     "to ``a``'s dtype; d = -1/a^2.")
prx_lo_rsq = _ideal(_prx_lo_rsq, _d_rsq, "APrxLoRsq: 2-op rsqrt estimate (positive inputs); d = -rsqrt(a)/(2a).")
prx_lo_sqrt = _ideal(_prx_lo_sqrt, _d_sqrt, "APrxLoSqrt: 2-op sqrt estimate (positive inputs); d = rsqrt(a)/2.")
rcp = _ideal(_rcp, _d_rcp,
             "High-precision reciprocal (ARcp semantics): exact ``1/a``, any float dtype.  It carries the "
             "guarded derivative too: the RCAS limiters evaluate ``min(...) * rcp(0)`` on purpose and drop "
             "the NaN (core/easu_math.py), so the multiplier must not turn the dropped branch's zero "
             "cotangent into ``0 * inf``.")

# The kernels' "high precision" reciprocal: the same correctly rounded 1/a.
rcp_fast = rcp


def sat(a: torch.Tensor) -> torch.Tensor:
    """ASat: clamp to [0, 1]."""
    return torch.clamp(a, 0.0, 1.0)


# --- Parabolic sin/cos (ffx_a.h:1919-1943) ----------------------------------
# Input {-1..1} represents {0..2pi}; output {-1/4..1/4} represents {-1..1}.


def p_sin(x: torch.Tensor) -> torch.Tensor:
    """APSin: one-FMA parabolic sine approximation."""
    return x * x.abs() - x


def p_cos(x: torch.Tensor) -> torch.Tensor:
    """APCos via phase-shifted APSin."""
    x = x * 0.5 + 0.75
    x = x - torch.floor(x)
    return p_sin(x * 2.0 - 1.0)


# --- [FIS] float-integer-sortable (ffx_a.h:1533-1559) ------------------------
# Order-preserving float <-> uint32 mapping (atomic-max / sort tricks).  The
# uint32 values are held in int64, as the tricks above hold them.


def fis_to_u32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> its sortable uint32 code, in int64 (0 .. 2**32 - 1)."""
    u = _bits(x.to(torch.float32))
    return torch.where((u >> 31) > 0, u ^ 0xFFFFFFFF, u ^ 0x80000000)


def fis_from_u32(u: torch.Tensor) -> torch.Tensor:
    """A sortable code (any integer dtype, taken modulo 2**32) -> float32."""
    u = u.to(torch.int64) & 0xFFFFFFFF
    return _float(torch.where((u >> 31) > 0, u ^ 0x80000000, u ^ 0xFFFFFFFF), torch.float32)
