"""K2's time by stage on the H100: the gather kernel with one stage knocked out.

    python3 tools_torch/ablation/gather_ablation.py [preset]

Counterpart of ``tools/ablation/gather_ablation.py``: preset ``1.3`` or
``1.7`` (default ``1.7``), the JAX tool's sources (2954 x 1662 and
2259 x 1271, uniform from seed 7, bfloat16) upscaled to 4K in bfloat16
storage, here a batch of ``kernel_ab.NFRAMES``.  Each mode is a build of
this checkout's kernels with one ``FSR_ABL_*`` macro
(``csrc/fsr_pixel.cuh:ABLATION_MASK``); the output is WRONG under every
mode.  ``fused_stage_ablation.sweep`` builds them in parallel, checks each
library's mask, holds each output different from production's, times them
in turn with production and prints ms per 4K frame, the difference and
the timed kernel's static SASS counts beside production's.

The JAX tool's modes stub out the TPU kernel's column-gather machinery.
Only "nog" (the texel responses: K2's response pass with each centre's
luma in their place) has a counterpart; the others are listed in
``NO_COUNTERPART`` with the reason and not timed.
K2's own stages take their place: the tap weights, and staging alone.
"stageonly" runs with RCAS off, so that it times the staging, the tables
and the store and nothing else; "norcas" is production with
``apply_rcas=False``.  Exits non-zero without a card, on an unknown
preset, when a build fails, when a mask is wrong or when a knockout
changes nothing.
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np
import torch

from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import easu_gather
from tools_torch.ablation import fused_stage_ablation, kernel_ab

# (name; what it removes; macro, or None for the production build; RCAS
# applied), as fused_stage_ablation.MODES.
MODES = [
    ("", "full kernel (baseline)", None, True),
    ("nog", "the staged response pass (each centre's luma as its response, the JAX tool's nog)",
     "FSR_ABL_K2_NOG", True),
    ("weights", "the tap distances and weights (stubbed; accumulation kept)", "FSR_ABL_K2_WEIGHTS", True),
    ("stageonly", "EASU and RCAS: the staged 'f' texel stored (staging, tables, store left)",
     "FSR_ABL_K2_STAGEONLY", False),
    ("norcas", "the RCAS pass (apply_rcas=False, no build)", None, False),
]
# The JAX tool's modes with no K2 counterpart.
NO_COUNTERPART = {
    "base384": "the Mosaic VMEM tile plan (120, 384) that the TPU's ablation modes needed; K2 has one "
               "tile plan (32 x 32 output pixels per block)",
    "noroll": "vreg alignment rolls: K2 reads each tap from its staged footprint in shared memory at a "
              "table offset, with no roll",
    "nogather": "within-vreg tap gathers: a shared-memory load replaces them",
    "noselrow": "one-hot row-selection matmuls: K2's row tables index the footprint directly",
}
SIZES = {"1.3": (2954, 1662), "1.7": (2259, 1271)}
OUT_HW = (2160, 3840)


def sass_kernel(rcas: bool) -> str:
    """The timed kernel in cuobjdump's listing: K2 <bfloat16 source, float32
    math, bfloat16 output, RCAS on or off, no denoise, RGB>."""
    return rf"staged_gather_kernelI13__nv_bfloat16fS\w*?_Lb{int(rcas)}ELb0ELb0EE"


def frames(preset: str, dev, n: int) -> torch.Tensor:
    """The JAX tool's source (uniform from seed 7, rounded to bfloat16), n times."""
    w, h = SIZES[preset]
    img = np.random.default_rng(7).uniform(0, 1, (3, h, w)).astype(np.float32)
    return torch.from_numpy(img).to(dev).to(torch.bfloat16).expand(n, 3, h, w).contiguous()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    preset = argv[0] if argv else "1.7"
    if preset not in SIZES:
        print(f"gather_ablation: preset must be one of {sorted(SIZES)}, got {preset!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("gather_ablation: no CUDA device; the readings are device times", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    cname = kernel_ab.card()
    w, h = SIZES[preset]
    con = EasuConstants.create((w, h), None, OUT_HW[::-1])
    rcon = RcasConstants(0.25)
    x = frames(preset, dev, kernel_ab.NFRAMES)

    def call(rcas):
        return easu_gather.easu_gather(x, OUT_HW, con, rcon, rcas, False, torch.bfloat16)

    print(f"K2 by stage: {preset}x, {w}x{h} -> 3840x2160, bfloat16; card {cname}")
    for name, why in NO_COUNTERPART.items():
        print(f"{name:>10}: no counterpart on the H100 ({why})")
    ok = fused_stage_ablation.sweep(MODES, call, sass_kernel, kernel_ab.NFRAMES, cname)
    print(cname)
    if not ok:
        print("gather_ablation: a knockout left the output as it was", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
