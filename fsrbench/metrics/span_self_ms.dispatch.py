"""The median over the traced stretch's ``upscale`` calls (each with an
``fsr.api`` span) of the summed self time of the call's ``fsr.dispatch``
spans, in ms: the kernel choice (``dispatch.supported``, each time it is
asked), the host plans, the epilogue's binding, the output's allocation
and the launch arguments, less the ``fsr.launch`` spans under them.  The
program records them (``fsr_tpu_torch.utils.profiling``); None where it
records no ``fsr.api`` span."""

import statistics


def read(run):
    try:
        from fsr_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    spans = records()
    calls = spans.self_times("fsr.api")
    per_call = spans.self_times("fsr.dispatch")
    return 1e3 * statistics.median(per_call.get(c, 0.0) for c in calls) if calls else None
