"""The share of the untraced window in which no operation ran on the card,
in percent: one minus the card's busy time per frame in the traced stretch
times the frames per second that the window completed.  Where the host
sets the pace, as with one call in flight, the profiler's own host work
would show as idle in the traced stretch itself; so the device's time per
frame comes from the trace and the pace from the window, run with the
profiler off.  On several cards, the mean of each card's share."""


def read(run):
    if run.trace is None or not run.trace.frames:
        return None
    busy = run.trace.busy_s_by_device()
    if not busy:
        return None
    rate = run.calls.n * run.traffic["batch"] / run.seconds
    return 100.0 * sum(1.0 - b / run.trace.frames * rate for b in busy.values()) / len(busy)
