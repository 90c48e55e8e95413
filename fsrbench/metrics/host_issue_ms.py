"""The median over the window's calls of the host time from entering a
call to its return, without waiting for the device: ``upscale``'s checks,
constants, plan lookups and launch, or, on row strips, the producer's
writes into the graphs' inputs, the staging and the graph launches (host
clock, taken with the profiler off)."""

import statistics


def read(run):
    issue = run.calls.issue_s
    return 1e3 * statistics.median(issue) if issue else None
