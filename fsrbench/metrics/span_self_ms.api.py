"""The median over the traced stretch's calls of the self time of the
program's ``fsr.api`` span, in ms: ``api.upscale``'s checks, the output
size, the constants, the path choice and the layout moves, less the
``fsr.dispatch`` spans under it.  The program records it
(``fsr_tpu_torch.utils.profiling``) while the profiler records; None where
it records no such span."""

import statistics


def read(run):
    try:
        from fsr_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    per_call = records().self_times("fsr.api")
    return 1e3 * statistics.median(per_call.values()) if per_call else None
