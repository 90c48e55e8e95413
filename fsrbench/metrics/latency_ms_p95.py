"""The 95th percentile of the same samples as ``latency_ms_p50`` (linear
interpolation between order statistics); None where calls were dispatched
ahead."""

import numpy as np


def read(run):
    lat = run.calls.latency_ms
    return float(np.percentile(np.asarray(lat, dtype=np.float64), 95)) if lat else None
