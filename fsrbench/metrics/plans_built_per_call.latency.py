"""Host plans, tables and constants objects built rather than taken from a
cache, per ``upscale`` call of the traced stretch (each with an ``fsr.api``
span): the program's count ``plans_built`` summed over those calls' spans,
over their number (``fsr_tpu_torch.utils.profiling``); None where the
program records no ``fsr.api`` span."""


def read(run):
    try:
        from fsr_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    spans = records()
    calls = spans.self_times("fsr.api")
    built = spans.counts("plans_built")
    return sum(built.get(c, 0) for c in calls) / len(calls) if calls else None
