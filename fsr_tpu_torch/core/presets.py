"""Quality presets and tuning defaults (copy of ``fsr_tpu/core/presets.py``).

Mirrors the sample app's preset table (sample/src/DX12/FSRSample.h:79-93 and
the per-preset mip-bias defaults at sample/src/DX12/FSRSample.cpp:34-38).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

__all__ = ["Preset", "PRESETS", "render_resolution", "recommended_mip_bias"]


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    scale: float  # per-dimension upscale factor
    mip_bias: float  # sample default (FSRSample.cpp:34-38)


PRESETS: Dict[str, Preset] = {
    "ultra_quality": Preset("ultra_quality", 1.3, -0.38),
    "quality": Preset("quality", 1.5, -0.585),
    "balanced": Preset("balanced", 1.7, -0.75),
    "performance": Preset("performance", 2.0, -1.0),
    "native": Preset("native", 1.0, 0.0),
}


def render_resolution(display: Tuple[int, int], scale: float) -> Tuple[int, int]:
    """Render resolution for a display size and upscale ratio.

    Matches RefreshRenderResolution (FSRSample.h:70-97): render = display / r,
    truncated toward zero after float division.
    """
    h, w = display
    return (int(float(h) / float(scale)), int(float(w) / float(scale)))


def recommended_mip_bias(scale: float) -> float:
    """Documentation-recommended mip bias: -log2(display/source) (PDF p.24)."""
    return -math.log2(float(scale))
