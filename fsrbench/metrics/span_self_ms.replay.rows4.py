"""The median over the traced stretch's captured row-sharded calls of the
summed self time of their ``fsr.replay`` spans, in ms: one
``graph.replay()`` a card.  The program records them
(``fsr_tpu_torch.utils.profiling``); None where it records none."""

import statistics


def read(run):
    try:
        from fsr_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    per_call = records().self_times("fsr.replay")
    return 1e3 * statistics.median(per_call.values()) if per_call else None
