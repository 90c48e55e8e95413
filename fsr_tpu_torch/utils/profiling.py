"""Device timing (counterpart of ``fsr_tpu/utils/profiling.py``).

The JAX package parses TPU profiler traces; on a CUDA device the timer is a
pair of CUDA events around each call, and ``device_trace`` reads kernel
times and the device's idle share from a ``torch.profiler`` trace (the
counterpart of ``op_times``).  ``trace_annotation`` names a span in that
trace (the UserMarker / SetPerfMarker analog).
"""

from __future__ import annotations

import statistics
from typing import Callable, Iterable, Tuple

import torch

__all__ = ["cuda_time_ms", "cuda_times_in_turn", "device_trace", "busy_time", "trace_annotation"]

# A torch.profiler cycle can come back with no device activity (seen once on
# an H100 in a trace that succeeds on a second take): device_trace retakes it.
TRACE_ATTEMPTS = 3


def cuda_time_ms(fn: Callable[[], object], warmup: int = 3, iters: int = 20, queue: int = 1) -> float:
    """Median device time of ``fn()`` in milliseconds, from CUDA events on
    the current stream.  Each sample brackets ``queue`` calls queued back to
    back and divides by them: with 1, the sample includes the host work of
    the call before its launch (the device idles through it); with more,
    each call's host work overlaps the previous call's kernels, so a call
    that keeps the device busier than the host reads its device time.
    Raises when no CUDA device is available: a timing never falls back to
    the host."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(queue):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / queue)
    return statistics.median(times)


def cuda_times_in_turn(fns: dict, rounds: int = 3, **kw) -> dict:
    """``cuda_time_ms`` of each function of ``fns``, the functions taken in
    turn ``rounds`` times, so that every reading sees the same clocks and
    card state; the median per function."""
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            times[k].append(cuda_time_ms(fn, **kw))
    return {k: statistics.median(v) for k, v in times.items()}


def busy_time(intervals: Iterable[Tuple[float, float]], start: float, end: float) -> float:
    """Length of the union of the (start, end) intervals, each clipped to
    the window [start, end] first: a device operation that began before the
    window counts only from its start, so busy time never exceeds the
    window and the idle share never reads negative."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, start), min(e, end)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def device_trace(fn: Callable[[], object], calls: int = 5) -> dict:
    """Trace ``calls`` back-to-back calls of ``fn()`` with ``torch.profiler``
    and read the device's share of the window.

    Returns ``{"kernels": {name: ms per call}, "ops_per_call", "busy_ms",
    "busy_ms_by_device", "window_ms", "idle_share"}``.  The same calls run
    once first as the profiler's warm-up step, so its buffer set-up falls
    outside the recorded step.  The window runs from the host entering the
    first call to the end of the last device operation; busy is the union of
    the device operations' intervals clipped to the window (``busy_time``),
    over all devices and per device index (cards that overlap sum to more
    than the union).  A profiling cycle in
    which CUPTI delivered no device activity is taken again, at most
    ``TRACE_ATTEMPTS`` times in all; then it raises."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    if not torch.cuda.is_available():
        raise RuntimeError("device_trace needs a CUDA device")
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(TRACE_ATTEMPTS):
        traced = []
        with profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: traced.append(p.events()),
        ) as prof:
            for _ in range(2):
                with record_function("device_trace_window"):
                    for _ in range(calls):
                        fn()
                torch.cuda.synchronize()
                prof.step()
        events = traced[0]
        # Device operations only: the annotation also shows as a device-side span.
        dev = [e for e in events if e.device_type == cuda and e.name != "device_trace_window"
               and not getattr(e, "is_user_annotation", False)]
        if dev:
            break
    else:
        raise RuntimeError(f"the profiler recorded no device operation in {TRACE_ATTEMPTS} attempts")
    start = min(e.time_range.start for e in events
                if e.name == "device_trace_window" and e.device_type != cuda)
    end = max(e.time_range.end for e in dev)
    kernels: dict = {}
    for e in dev:
        kernels[e.name] = kernels.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / calls
    busy = busy_time(((e.time_range.start, e.time_range.end) for e in dev), start, end)
    by_device = {
        i: busy_time(((e.time_range.start, e.time_range.end) for e in dev if e.device_index == i), start, end) / 1e3
        for i in sorted({e.device_index for e in dev})
    }
    window = end - start
    return {
        "kernels": kernels,
        "ops_per_call": len(dev) / calls,
        "busy_ms": busy / 1e3,
        "busy_ms_by_device": by_device,
        "window_ms": window / 1e3,
        "idle_share": 1.0 - busy / window,
    }


def trace_annotation(name: str):
    """Named scope for traces (the UserMarker / SetPerfMarker analog): a
    ``torch.profiler.record_function`` span, on the host and, where a CUDA
    trace is taken, beside the device operations it launched."""
    return torch.profiler.record_function(name)
