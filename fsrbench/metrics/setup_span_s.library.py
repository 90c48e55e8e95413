"""The seconds of the run's ``fsr.library`` span: loading the kernels'
library at its first use in set-up, building it first where the checkout
has none (the span's count ``built``).  The program records it whether or
not the profiler records (``fsr_tpu_torch.utils.profiling``); None where
it records none."""


def read(run):
    try:
        from fsr_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    spans = records().named("fsr.library")
    return spans[-1].seconds if spans else None
