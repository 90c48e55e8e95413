"""The seconds of the run's ``fsr.capture`` span: the warm-up and capture
of every card's graph of a ``CapturedSpatial`` in set-up.  The program
records it whether or not the profiler records
(``fsr_tpu_torch.utils.profiling``); None where it records none."""


def read(run):
    try:
        from fsr_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    spans = records().named("fsr.capture")
    return spans[-1].seconds if spans else None
