"""Process start to the window's start: imports, the card, the kernels'
library (built on a checkout's first run), the frames, the entry and its
warm-up."""


def read(run):
    return run.setup_s
