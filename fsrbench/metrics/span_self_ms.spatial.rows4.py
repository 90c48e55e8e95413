"""The median over the traced stretch's captured row-sharded calls (a
``CapturedSpatial.writable()`` and the call after it) of the summed self
time of their ``fsr.spatial`` spans, in ms: ``writable()``'s event waits,
the call's checks and each card's staging, less the graph launches
(``fsr.replay``).  The program records them
(``fsr_tpu_torch.utils.profiling``); None where it records none."""

import statistics


def read(run):
    try:
        from fsr_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    per_call = records().self_times("fsr.spatial")
    return 1e3 * statistics.median(per_call.values()) if per_call else None
