"""The share of the traced stretch in which no operation ran on a card, in
percent; on several cards the mean of each card's share."""


def read(run):
    if run.trace is None:
        return None
    busy = run.trace.busy_s_by_device()
    if not busy:
        return None
    window = run.trace.window_s
    return 100.0 * sum(1.0 - b / window for b in busy.values()) / len(busy)
