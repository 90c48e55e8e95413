"""fsr_tpu_torch: FidelityFX Super Resolution 1.0 in PyTorch with hand-written
CUDA kernels for NVIDIA Hopper.

The PyTorch port of ``fsr_tpu``: the same planar (..., C, H, W) interface,
with EASU+RCAS fused in a CUDA kernel for integer ratios (the Performance
2x preset) and a plain-torch path for everything else.  The kernels build
from ``fsr_tpu_torch/csrc`` with nvcc at first use.
"""

from fsr_tpu_torch.api import upscale
from fsr_tpu_torch.core.constants import (
    EasuConstants,
    FSR_RCAS_LIMIT,
    RcasConstants,
    constants_from_jax,
)
from fsr_tpu_torch.core.presets import PRESETS, Preset, recommended_mip_bias, render_resolution

__version__ = "0.1.0"

__all__ = [
    "upscale",
    "EasuConstants",
    "RcasConstants",
    "FSR_RCAS_LIMIT",
    "constants_from_jax",
    "PRESETS",
    "Preset",
    "render_resolution",
    "recommended_mip_bias",
]
