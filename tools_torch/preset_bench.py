"""The upscale presets at 4K on the card: device ms, Mpix/s and the f32 deviation.

    python3 tools_torch/preset_bench.py

Counterpart of ``tools/preset_bench.py``: the JAX tool's three sources
(uniform from seed 7, one frame each, rounded to bfloat16), each upscaled
to (2160, 3840) in bfloat16 storage through
``fsr_tpu_torch.upscale(..., impl="kernel")``: ultra quality 1.3x from
2954 x 1662, quality 1.5x from 2560 x 1440, balanced 1.7x from 2259 x 1271.
Each call must launch exactly one K2 and no K1 (the launch counters).
Prints, per preset, the device ms per call (``profiling.cuda_time_ms``, 10
calls queued per sample), output megapixels per second, and
``maxdev_f32``: the largest difference of the float32 kernel path from the
float32 torch path (``impl="torch"``) on the same source, which the f32
contract holds to ``MAXDEV_F32``; then the card's name and power limit.
Exits non-zero without a card, on another launch count or on a deviation
over the contract.
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

import fsr_tpu_torch
from fsr_tpu_torch.kernels import easu_gather, fused

# (w, h) of each preset's source, as the JAX tool's.
PRESETS = {"ultra_quality_1.3x": (2954, 1662), "quality_1.5x": (2560, 1440), "balanced_1.7x": (2259, 1271)}
OUT_HW = (2160, 3840)
MAXDEV_F32 = 2e-5  # the f32 contract (docs/FIDELITY.md, tests/test_ops_vs_oracle.py)


def bench(dev) -> list:
    """[(name, device ms per call, Mpix/s, maxdev_f32)] for ``PRESETS``."""
    from fsr_tpu_torch.utils.profiling import cuda_time_ms

    rng = np.random.default_rng(7)
    rows = []
    for name, (w, h) in PRESETS.items():
        img = torch.from_numpy(rng.uniform(0, 1, (3, h, w)).astype(np.float32)).to(dev).to(torch.bfloat16)

        def call(img=img):
            return fsr_tpu_torch.upscale(img, out_size=OUT_HW, compute_dtype=torch.bfloat16, impl="kernel")

        easu_gather.easu_gather.launches = fused.upscale_padded.launches = 0
        call()
        n = (easu_gather.easu_gather.launches, fused.upscale_padded.launches)
        if n != (1, 0):
            raise RuntimeError(f"{name}: {n[0]} K2 and {n[1]} K1 launches per call, expected one K2 and no K1")
        img32 = img.float()
        want = fsr_tpu_torch.upscale(img32, out_size=OUT_HW, compute_dtype=torch.float32, impl="torch")
        got = fsr_tpu_torch.upscale(img32, out_size=OUT_HW, compute_dtype=torch.float32, impl="kernel")
        dev_f32 = (got - want).abs().max().item()
        del want, got
        ms = cuda_time_ms(call, queue=10)
        rows.append((name, ms, OUT_HW[0] * OUT_HW[1] / ms / 1e3, dev_f32))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("preset_bench: no CUDA device; the readings are device times", file=sys.stderr)
        return 1
    from tools_torch.ablation import kernel_ab

    rows = bench(torch.device("cuda:0"))
    for name, ms, mpix, d in rows:
        print(f"{name} ms= {ms:.4f} mpix_s= {mpix:.0f} maxdev_f32= {d:.3e}", flush=True)
    print(kernel_ab.card())
    bad = [name for name, _, _, d in rows if not d <= MAXDEV_F32]
    if bad:
        print(f"preset_bench: maxdev_f32 over {MAXDEV_F32:g} for {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
