"""Output frames whose calls completed in the window, over the window's
length (host clock: from the first call's entry to the sync after the
last)."""


def read(run):
    return run.calls.n * run.traffic["batch"] / run.seconds
