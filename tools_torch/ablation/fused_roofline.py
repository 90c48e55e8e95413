"""Roofline of K1 on the H100: ops per pixel counted from the port's torch
twins, the achieved FMA rate (kernel P3), and K1's time at the headline.

Counterpart of tools/ablation/fused_roofline.py.  Three parts:

1. **Ops per pixel** (``ops_per_pixel``), counted, not estimated: a
   ``TorchDispatchMode`` counts the aten ops that the kernels' torch twins
   run on one pixel's values (``easu_math.easu_resolve(fast=True,
   quad_g=)``, ``rcas_resolve(fast=True)``, ``easu_texel_response(fast=True)``
   and the luma), in two conventions that classify the ops alike
   (``op_cost``):
   - *convention 1*, the JAX tool's rules (fused_roofline.py:46-77): one
     per op call.  Views, ``lift_fresh``, ``detach``, ``unsqueeze``,
     ``select``, ``stack`` and the ``full``/``zeros`` factories are free, so
     is a ``_to_copy`` to the same type; ``reciprocal``/``rsqrt``/``sqrt``/
     ``div`` cost 4; every other op 1.  The bit tricks, which the torch
     twins run as integer ops on ``view(torch.int32)`` (``approx._bits``/
     ``_float``), cost what they cost in CUDA: their subtract, shift or add
     (``TRICK_ARITH``) 1 each, the emulation of unsigned wrap around them
     nothing.  Comparable with the JAX tool's 315 / 90 / 21 (which leaves
     the bit tricks out: they sit inside ``custom_jvp_call``, free by its
     rules).
   - *convention 2*, per element, per output pixel: each counted op weighted
     by its output's element count, so a three-channel op counts 3, and mul
     and add count apart (an FMA is 2).  The texel response and the luma are
     per source texel, amortised at 2x (x 1/4).  ``chip_smoke.py``'s
     ``EASU_OPS``/``RCAS_OPS``, so every kernel's ``bound_ms``, come from it.
   K6's function, the float16 torch path (``easu_rcas_h_ops``: ``ops.easu``
   "mixed" in its non-fast forms, then FsrRcasH), is counted by convention
   2 and split by the type each op runs in (``op_type``): float16 ops at the
   card's half rate, the rest (the float32 direction estimate, the bit
   tricks' integer ops) at the float32 rate (``EASU_H_OPS``/``RCAS_H_OPS``).
2. **Achieved FMA rate** (``fma_rate_tflops``): P3's independent FMA chains
   in float32 (``fmaf``) and half2 (``__hfma2``), 4 and 8 chains of 64, in
   TFLOP/s (FMA = 2) and the JAX tool's el-ops/s (FMA = 1), against the
   data sheet's 67 TFLOP/s float32 (twice that in half2).
3. **K1** at the headline (batch-4 1080p -> 4K, float32 and bfloat16
   storage).

utilization = ops x pixels / rate / K1 time.

Run on a machine with an H100, from the root of a checkout:
    python3 tools_torch/ablation/fused_roofline.py
"""

from __future__ import annotations

import collections
import math
import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fsr_tpu_torch.core import easu_math
from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import fused, pad, probes

# Ops that move or make values and compute nothing, as the JAX tool's _FREE
# (broadcast_in_dim, reshape, concatenate, slice, ...): the views and
# factories the twins run.
FREE = frozenset({"view", "lift_fresh", "detach", "unsqueeze", "select", "stack", "full", "zeros", "zeros_like"})
# Multi-instruction sequences (JAX: div, rsqrt, sqrt).
COST4 = frozenset({"reciprocal", "rsqrt", "sqrt", "div"})
# The bit tricks' own integer arithmetic (approx.py): the magic subtract of
# APrxLoRcp/APrxMedRcp, the shift and the subtract or add of APrxLoRsq and
# APrxLoSqrt.  Every other op on integers is torch's emulation of unsigned
# 32-bit arithmetic (the widening and narrowing copies, the masks, the
# wrap's compare, subtract and select) and free: CUDA runs a trick in 1
# (rcp) or 2 (rsq, sqrt) integer ops.
TRICK_ARITH = frozenset({"rsub", "add", "__rshift__", "bitwise_right_shift"})
_INTEGER = frozenset({torch.int16, torch.int32, torch.int64})
# The JAX tool's counts on the TPU package (ROOFLINE_r05.txt), for reference.
JAX_COUNTS = {"easu_resolve": 315, "rcas_resolve": 90, "texel_response": 21, "per_px": 410.75}

# The data sheet's rates outside the tensor cores (H100 SXM, 700 W), FMA = 2.
PEAK_TFLOPS = {torch.float32: 67.0, torch.float16: 134.0}
# P3's block, the JAX probe's (64, 256) (fused_roofline.py:117), and how long
# a launch keeps the card busy at the data-sheet rate.
FMA_SHAPE = (64, 256)
FMA_RUN_MS = 2.0
# The headline: K1 on batch-4 1080p frames to 4K.
HEADLINE_SHAPE = (4, 3, 1080, 1920)
HEADLINE_OUT = (2160, 3840)


def op_cost(func, args, out) -> int:
    """One op call's cost by the JAX tool's rules (0: free)."""
    name = func.overloadpacket.__name__
    if name in FREE:
        return 0
    if any(isinstance(a, torch.Tensor) and a.dtype in _INTEGER for a in args):
        return int(name in TRICK_ARITH)
    if name == "_to_copy":
        return int(args[0].dtype != out.dtype)
    return 4 if name in COST4 else 1


def op_type(args, out):
    """The type an op runs in: its output's, or for a comparison or a bit
    trick (a bool or integer result) its first tensor operand's."""
    if out.is_floating_point():
        return out.dtype
    return next((a.dtype for a in args if isinstance(a, torch.Tensor)), out.dtype)


class OpCount(TorchDispatchMode):
    """Counts the aten ops run under it by name: ``calls`` (convention 1)
    and ``elems`` (convention 2: each weighted by its output's elements);
    ``by_type``: convention 2 by the type each op runs in (``op_type``)."""

    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()
        self.elems = collections.Counter()
        self.by_type = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        cost = op_cost(func, args, out)
        if cost:
            name = func.overloadpacket.__name__
            self.calls[name] += cost
            self.elems[name] += cost * out.numel()
            self.by_type[op_type(args, out)] += cost * out.numel()
        return out


def count(fn) -> OpCount:
    """The ops ``fn()`` runs."""
    c = OpCount()
    with c:
        fn()
    return c


def _twins() -> dict:
    """The kernels' torch twins on one pixel's values, as the JAX tool
    calls them (fused_roofline.py:80-101): 3-channel taps (3, 1, 1), one
    direction plane (1, 1).  Inputs are made here, outside the count."""
    taps = {k: torch.full((3, 1, 1), 0.5) for k in easu_math.TAP_OFFSETS}
    s = torch.full((1, 1), 0.5)
    quad_g = {k: (s, s, s) for k in ("s", "t", "u", "v")}
    ppx, ppy = torch.full((1, 1), 0.25), torch.full((1, 1), 0.75)
    t3 = torch.zeros((3, 1, 1))
    return {
        "easu_resolve": lambda: easu_math.easu_resolve(taps, ppx, ppy, dtype=torch.float32, fast=True,
                                                       quad_g=quad_g),
        "rcas_resolve": lambda: easu_math.rcas_resolve(t3, t3, t3, t3, t3, 0.87, fast=True),
        "texel_response": lambda: easu_math.easu_texel_response(s, s, s, s, s, fast=True),
        "luma": lambda: easu_math._luma(t3, easu_math._consts(torch.float32, t3.device)),
    }


def op_counts() -> dict:
    """Each twin's ``OpCount``."""
    return {name: count(fn) for name, fn in _twins().items()}


def ops_per_pixel() -> dict:
    """{"convention 1": {...}, "convention 2": {...}}, each with the
    counts of ``easu_resolve``, ``rcas_resolve``, ``texel_response``,
    ``luma`` and ``per_px`` at 2x (one source texel per 4 output pixels).
    Convention 1's ``per_px`` adds 2 ops of luma per texel, as the JAX tool
    does; convention 2's adds the counted luma."""
    counts = op_counts()
    c1 = {k: sum(c.calls.values()) for k, c in counts.items()}
    c2 = {k: sum(c.elems.values()) for k, c in counts.items()}
    c1["per_px"] = c1["easu_resolve"] + c1["rcas_resolve"] + (c1["texel_response"] + 2) * 0.25
    c2["per_px"] = c2["easu_resolve"] + c2["rcas_resolve"] + (c2["texel_response"] + c2["luma"]) * 0.25
    return {"convention 1": c1, "convention 2": c2}


def easu_rcas_ops():
    """(EASU, RCAS) operations per output pixel at 2x, convention 2: the
    resolve plus the texel response and luma amortised over 4 pixels, and
    RCAS.  ``chip_smoke.py``'s EASU_OPS and RCAS_OPS."""
    c2 = ops_per_pixel()["convention 2"]
    return c2["easu_resolve"] + (c2["texel_response"] + c2["luma"]) * 0.25, c2["rcas_resolve"]


def _twins_h() -> dict:
    """The twins of K6's function, the float16 torch path, on one pixel's
    values: ``easu_resolve`` on float16 taps with the direction in float32
    (its per-texel responses, ``quad_g``), the non-fast forms; the float16
    luma widened to float32 per texel; ``rcas_resolve`` on float16 taps."""
    f16, f32 = torch.float16, torch.float32
    taps = {k: torch.full((3, 1, 1), 0.5, dtype=f16) for k in easu_math.TAP_OFFSETS}
    s = torch.full((1, 1), 0.5)
    ppx, ppy = torch.full((1, 1), 0.25), torch.full((1, 1), 0.75)
    t3 = torch.full((3, 1, 1), 0.5, dtype=f16)
    quad_g = {k: easu_math.easu_texel_response(s, s, s, s, s) for k in ("s", "t", "u", "v")}
    return {
        "easu_resolve": lambda: easu_math.easu_resolve(taps, ppx, ppy, dtype=f16, dir_dtype=f32, quad_g=quad_g),
        "rcas_resolve": lambda: easu_math.rcas_resolve(t3, t3, t3, t3, t3, 0.87),
        "texel_response": lambda: easu_math.easu_texel_response(s, s, s, s, s),
        "luma": lambda: easu_math._luma(t3, easu_math._consts(f16, t3.device)).to(f32),
    }


def easu_rcas_h_ops() -> dict:
    """K6's function's operations per output pixel at 2x, convention 2, by
    type: {"float16": (EASU, RCAS), "float32": (EASU, RCAS)}, the float32
    entry every op not on halves (the bit tricks' integer ops too); the
    texel response and the luma amortised over 4 pixels.
    ``chip_smoke.py``'s EASU_H_OPS and RCAS_H_OPS."""
    counts = {name: count(fn) for name, fn in _twins_h().items()}
    out = {}
    for key, half in (("float16", True), ("float32", False)):
        def n(name):
            return sum(v for dt, v in counts[name].by_type.items() if (dt == torch.float16) == half)
        out[key] = (n("easu_resolve") + (n("texel_response") + n("luma")) * 0.25, n("rcas_resolve"))
    return out


def fma_input(device, seed: int = 0) -> torch.Tensor:
    """P3's (64, 256) float32 block, uniform in [0, 1) from ``seed``."""
    x = np.random.default_rng(seed).random(FMA_SHAPE).astype(np.float32)
    return torch.from_numpy(x).to(device)


def fma_reps(dtype, chains: int) -> int:
    """Grid repeats that keep the card busy ``FMA_RUN_MS`` at the data-sheet
    rate."""
    flops = 2 * FMA_SHAPE[0] * FMA_SHAPE[1] * chains * probes.CHAIN
    return min(65535, math.ceil(FMA_RUN_MS * 1e-3 * PEAK_TFLOPS[dtype] * 1e12 / flops))


def fma_flops(x: torch.Tensor, dtype, chains: int) -> float:
    """Floating-point operations of one P3 launch (FMA = 2): every element
    runs ``chains`` chains of ``CHAIN`` FMAs, the first a multiply, as the
    JAX tool counts K = LANES * CHAIN (the chains' sum is not counted)."""
    return 2.0 * x.numel() * chains * probes.CHAIN * fma_reps(dtype, chains)


def fma_run(x: torch.Tensor, dtype, chains: int) -> torch.Tensor:
    """One P3 launch at the rate-reading size."""
    return probes.fma_rate(x, dtype, chains, fma_reps(dtype, chains))


def fma_rate_tflops(dtype=torch.float32, chains: int = 4, device="cuda") -> float:
    """The achieved rate of P3 in TFLOP/s (FMA = 2); halve it for the JAX
    tool's el-ops/s (FMA = 1)."""
    from fsr_tpu_torch.utils.profiling import cuda_time_ms

    x = fma_input(device)
    ms = cuda_time_ms(lambda: fma_run(x, dtype, chains))
    return fma_flops(x, dtype, chains) / (ms * 1e-3) / 1e12


def headline_k1(dtype, device="cuda", seed: int = 0):
    """K1 at the headline: a thunk running K1 once on batch-4 1080p frames
    (K4-padded once, here), and its output pixel count."""
    frames = torch.from_numpy(np.random.default_rng(seed).uniform(0, 1, HEADLINE_SHAPE).astype(np.float32))
    frames = frames.to(device).to(dtype)
    hin, win = HEADLINE_SHAPE[-2:]
    con = EasuConstants.create((win, hin), None, HEADLINE_OUT[::-1])
    fplan = fused.plan((hin, win), HEADLINE_OUT, con)
    padded = pad.edge_pad(frames, fplan.pads, dtype)
    sharp = float(RcasConstants(0.25).sharpness)
    npix = HEADLINE_SHAPE[0] * HEADLINE_OUT[0] * HEADLINE_OUT[1]
    return (lambda: fused.upscale_padded(padded, fplan, HEADLINE_OUT, sharp)), npix


def main():
    from fsr_tpu_torch.utils.profiling import cuda_times_in_turn

    if not torch.cuda.is_available():
        print("fused_roofline: no CUDA device; the readings are device times", file=sys.stderr)
        return 1
    ops = ops_per_pixel()
    print(f"device: {torch.cuda.get_device_name(0)}")
    for conv, c in ops.items():
        print(f"ops/px, {conv}: " + ", ".join(f"{k} {v:g}" for k, v in c.items()))
    print("ops/px, the JAX tool on the TPU package: " + ", ".join(f"{k} {v:g}" for k, v in JAX_COUNTS.items()))
    x = fma_input("cuda")
    k1 = {dt: headline_k1(dt) for dt in (torch.float32, torch.bfloat16)}
    npix = k1[torch.float32][1]
    fns = {f"P3 {'f32' if dt == torch.float32 else 'half2'} x{c}": (lambda dt=dt, c=c: fma_run(x, dt, c))
           for dt in (torch.float32, torch.float16) for c in (4, 8)}
    fns.update({f"K1 {'f32' if dt == torch.float32 else 'bf16'}": fn for dt, (fn, _) in k1.items()})
    ms = cuda_times_in_turn(fns)
    rate = {}
    for name, t in ms.items():
        if name.startswith("P3"):
            dt = torch.float32 if "f32" in name else torch.float16
            tf = fma_flops(x, dt, int(name[-1])) / (t * 1e-3) / 1e12
            rate[dt] = max(rate.get(dt, 0.0), tf)
            print(f"{name}: {t:.4f} ms, {tf:.2f} TFLOP/s ({tf / 2:.2f} T el-ops/s, FMA = 1), "
                  f"{tf / PEAK_TFLOPS[dt]:.1%} of the data sheet's {PEAK_TFLOPS[dt]:g}")
    for dt in (torch.float32, torch.bfloat16):
        t = ms[f"K1 {'f32' if dt == torch.float32 else 'bf16'}"]
        floor2 = ops["convention 2"]["per_px"] * npix / (rate[torch.float32] * 1e12) * 1e3
        floor1 = ops["convention 1"]["per_px"] * npix / (rate[torch.float32] / 2 * 1e12) * 1e3
        print(f"K1 {dt}: {t:.4f} ms per call ({t / HEADLINE_SHAPE[0]:.4f} ms per 4K frame); floor at the "
              f"achieved f32 rate: convention 2 {floor2:.4f} ms ({floor2 / t:.1%}), convention 1 (FMA = 1) "
              f"{floor1:.4f} ms ({floor1 / t:.1%})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
