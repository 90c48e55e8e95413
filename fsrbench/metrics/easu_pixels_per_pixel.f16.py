"""K6's EASU evaluations per output pixel in the traced stretch: the
program's count ``easu_pixels`` (the ring pixels whose EASU a launch
computes, its tiles' RCAS ring included) summed over the ``fsr.launch``
spans of K6 that carry it, over the same spans' count ``pixels``
(``fsr_tpu_torch.utils.profiling``); None where the program records no such
launch."""


def read(run):
    try:
        from fsr_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    launches = [s.args for s in records().named("fsr.launch")
                if s.args and s.args.get("kernel") == "K6" and "easu_pixels" in s.args]
    pixels = sum(a.get("pixels", 0) for a in launches)
    return sum(a["easu_pixels"] for a in launches) / pixels if pixels else None
