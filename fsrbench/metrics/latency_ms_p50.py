"""The median over every call of the window of the time from entering the
call to its output being ready (the device's clock: a timing event recorded
on the idle stream as the host enters the call, one after it); None where
calls were dispatched ahead."""

import statistics


def read(run):
    lat = run.calls.latency_ms
    return statistics.median(lat) if lat else None
