"""fsr_tpu_torch: FidelityFX Super Resolution 1.0 in PyTorch with hand-written
CUDA kernels for NVIDIA Hopper.

The PyTorch port of ``fsr_tpu``: the same planar (..., C, H, W) interface,
with EASU+RCAS fused in CUDA kernels for every preset and DRS ratio (K1 at
integer ratios, K2 at any other upscale), the SRTM prologue, the output
epilogue (SRTM^-1/gamma2, LFGA grain, TEPD dither) and byte I/O inside them
(``UpscalePipeline``, the sample's frame tail), RCAS alone in a CUDA kernel
(K3, ``sharpen``), mesh-sharded batch and row (spatial) execution across
devices (``fsr_tpu_torch.parallel``, ``UpscalePipeline(mesh=)``, whose
results stay on their devices as a ``Sharded``, as JAX's sharded arrays
do), and a plain-torch path on any device.  The kernels build from
``fsr_tpu_torch/csrc`` with nvcc at first use.
"""

from fsr_tpu_torch.api import UpscalePipeline, sharpen, upscale
from fsr_tpu_torch.core.constants import (
    EasuConstants,
    FSR_RCAS_LIMIT,
    RcasConstants,
    constants_from_jax,
)
from fsr_tpu_torch.core.presets import PRESETS, Preset, recommended_mip_bias, render_resolution
from fsr_tpu_torch.kernels.epilogue import Epilogue
from fsr_tpu_torch.parallel.sharding import Sharded

__version__ = "0.1.0"

__all__ = [
    "upscale",
    "sharpen",
    "UpscalePipeline",
    "Epilogue",
    "Sharded",
    "EasuConstants",
    "RcasConstants",
    "FSR_RCAS_LIMIT",
    "constants_from_jax",
    "PRESETS",
    "Preset",
    "render_resolution",
    "recommended_mip_bias",
]
