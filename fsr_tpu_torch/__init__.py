"""fsr_tpu_torch: FidelityFX Super Resolution 1.0 in PyTorch with hand-written
CUDA kernels for NVIDIA Hopper.

The PyTorch port of ``fsr_tpu``: the same planar (..., C, H, W) interface,
with EASU+RCAS fused in CUDA kernels for every preset and DRS ratio (K1 at
integer ratios, K2 at any other upscale), RCAS alone in a CUDA kernel (K3,
``sharpen``), and a plain-torch path on any device.  The kernels build from
``fsr_tpu_torch/csrc`` with nvcc at first use.
"""

from fsr_tpu_torch.api import sharpen, upscale
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
    "sharpen",
    "EasuConstants",
    "RcasConstants",
    "FSR_RCAS_LIMIT",
    "constants_from_jax",
    "PRESETS",
    "Preset",
    "render_resolution",
    "recommended_mip_bias",
]
