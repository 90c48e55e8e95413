"""Headline probe: K1's device ms for one 1080p -> 4K frame in bfloat16 storage.

    python3 tools_torch/ablation/headline_probe.py

Counterpart of ``tools/ablation/headline_probe.py``: one frame (batch 1),
uniform from seed 0 in float32, upscaled 2x with RCAS at sharpness 0.25
under bfloat16 storage (K1 rounds the source at its load) through
``kernels/fused.upscale_fused``, timed with ``profiling.cuda_time_ms``
(10 calls queued per sample: device time).  Prints the JAX tool's line,
``HEADLINE_MS <ms>  MPIX_S <output megapixels per second>``, then the
card's name and power limit.  Exits non-zero without a card.
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np
import torch

from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import fused

IN_HW, OUT_HW = (1080, 1920), (2160, 3840)


def headline_ms(dev) -> float:
    """K1's device ms per call on the headline frame."""
    from fsr_tpu_torch.utils.profiling import cuda_time_ms

    con = EasuConstants.create(IN_HW[::-1], None, OUT_HW[::-1])
    rcon = RcasConstants(0.25)
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (3, *IN_HW)).astype(np.float32)).to(dev)
    return cuda_time_ms(lambda: fused.upscale_fused(x, OUT_HW, con, rcon, compute_dtype=torch.bfloat16), queue=10)


def line(ms: float) -> str:
    return f"HEADLINE_MS {ms:.4f}  MPIX_S {OUT_HW[0] * OUT_HW[1] / (ms * 1e-3) / 1e6:.1f}"


def main() -> int:
    if not torch.cuda.is_available():
        print("headline_probe: no CUDA device; the reading is a device time", file=sys.stderr)
        return 1
    from tools_torch.ablation import kernel_ab

    print(line(headline_ms(torch.device("cuda:0"))))
    print(kernel_ab.card())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
