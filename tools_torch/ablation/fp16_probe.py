"""Probe float16 on the H100: storage, FMA compute and stores in a kernel.

Counterpart of tools/ablation/fp16_probe.py, which asked whether Mosaic
lowers each of three float16 kernels on the TPU.  Here the question is
whether each of P4's three kernels (``fsr_tpu_torch/kernels/probes.py:
fp16_probe``) runs and agrees with its plain version on a (256, 256)
float16 tensor: mode 0 loads float16 and stores float32 x 2, mode 1 runs an
8-step ``__hfma`` chain acc * v + 0.125 and stores float32, mode 2 stores
float16(float32 x 0.5).  Modes 0 and 2 must be bit-equal; mode 1 within one
float16 step per FMA (the plain version rounds the float32 product and sum
once to float16, as an FMA rounds once; where float32 itself rounds the sum
the two can part by a step).  It also prints P3's half2 FMA rate beside the
float32 one.  A measurement only: there is no in-kernel FsrEasuH.

Run on a machine with an H100, from the root of a checkout:
    python3 tools_torch/ablation/fp16_probe.py
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np
import torch

from fsr_tpu_torch.kernels import probes

SHAPE = (256, 256)
MODE1_STEPS = 8  # FMAs in mode 1's chain


def probe_input(device, seed: int = 0) -> torch.Tensor:
    """The (256, 256) float16 input, uniform in [0, 1) from ``seed``."""
    x = np.random.default_rng(seed).uniform(0, 1, SHAPE).astype(np.float16)
    return torch.from_numpy(x).to(device)


def f16_step(v: torch.Tensor) -> torch.Tensor:
    """The float16 step (ulp) at each value of ``v`` (normal range)."""
    _, e = torch.frexp(v.float().abs().clamp_min(2.0 ** -14))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 11)


def agreement(mode: int, got: torch.Tensor, want: torch.Tensor) -> dict:
    """How mode ``mode``'s kernel output agrees with its plain version:
    {"ok", "max_abs", "off" (values that differ), "limit"}.  Modes 0 and 2
    bit-equal; mode 1 within ``MODE1_STEPS`` float16 steps of the value."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"fp16 mode {mode}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    d = (got.float() - want.float()).abs()
    if mode == 1:
        limit = MODE1_STEPS * f16_step(want)
        ok = bool((d <= limit).all())
        limit = float(limit.max())
    else:
        ok, limit = bool(torch.equal(got, want)), 0.0
    return {"ok": ok, "max_abs": float(d.max()), "off": int((d > 0).sum()), "limit": limit}


def main():
    from tools_torch.ablation import fused_roofline

    if not torch.cuda.is_available():
        print("fp16_probe: no CUDA device; the probe is about the card's kernels", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}")
    x = probe_input("cuda")
    supported = []
    for mode, name in enumerate(probes.FP16_MODES):
        try:
            got = probes.fp16_probe(x, mode)
            torch.cuda.synchronize()
        except RuntimeError as e:
            print(f"  {name:<24} UNSUPPORTED: {str(e).splitlines()[0][:140]}")
            supported.append(False)
            continue
        a = agreement(mode, got, probes.fp16_probe_reference(x, mode))
        verdict = "SUPPORTED" if a["ok"] else "RUNS, DISAGREES"
        print(f"  {name:<24} {verdict}: max-abs {a['max_abs']:.3e} (limit {a['limit']:.3e}), "
              f"{a['off']} of {got.numel()} values differ")
        supported.append(a["ok"])
    for dtype, what in ((torch.float32, "f32 fmaf"), (torch.float16, "half2 __hfma2")):
        for chains in (4, 8):
            tf = fused_roofline.fma_rate_tflops(dtype, chains)
            print(f"  P3 {what}, {chains} chains: {tf:.2f} TFLOP/s "
                  f"({tf / fused_roofline.PEAK_TFLOPS[dtype]:.1%} of {fused_roofline.PEAK_TFLOPS[dtype]:g})")
    print("all three float16 kernels run and agree" if all(supported) else "a float16 kernel failed")
    return 0 if all(supported) else 1


if __name__ == "__main__":
    raise SystemExit(main())
