"""Device timing (counterpart of ``fsr_tpu/utils/profiling.py``) and the
port's spans and counters.

The JAX package parses TPU profiler traces; on a CUDA device the timer is a
pair of CUDA events around each call, and ``device_trace`` reads kernel
times and the device's idle share from a ``torch.profiler`` trace (the
counterpart of ``op_times``).

``trace_annotation`` is the one span primitive (the UserMarker /
SetPerfMarker analog), on the port's hot paths too.  Off, the normal
state, a span costs one check of ``torch.autograd.profiler``'s enabled
flag and returns a shared no-op: nothing allocated, no clock read.  It is
on while a ``torch.profiler`` records (not in its warm-up steps) and
inside ``recording()``.  A span then enters a profiler range ``name``
where a profiler records (an ``at::RecordFunction``, as
``record_function`` enters), so it lands in the profiler's trace on the
clock of the kernels it launched, and appends a ``Span`` to a bounded
buffer: its name, start and end (host seconds), its parent, the call it
belongs to (every span under one root span, and a ``leads`` root with the
root after it) and its counts (``count``) and labels.  The set-up spans
(``always=True``: the kernels' library, a capture) are recorded whether on
or off; they happen once.  ``records()`` and ``recording()`` give the
spans as ``Records``, whose readers sum self times (a span's duration
less its children's) and counts per call.

The port's spans (``SPANS``): ``fsr.api`` (``api.upscale``),
``fsr.dispatch`` (each entry into ``kernels/dispatch.py``), ``fsr.launch``
(each ctypes call that queues a kernel; label ``kernel``: K1-K4, K6,
P1-P4), ``fsr.spatial`` (``CapturedSpatial.writable``, its call and each
card's staging; label ``card``), ``fsr.replay`` (a card's graph launch;
label ``card``), ``fsr.library`` (loading the kernels' library, building
it first where it is stale; count ``built``) and ``fsr.capture`` (a
``CapturedSpatial``'s warm-up and capture; count ``cards``).  The count
``plans_built`` is every host plan, table or constants object built
rather than taken from a cache, on the span that builds it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import statistics
import threading
import time
from typing import Callable, Iterable, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["cuda_time_ms", "cuda_times_in_turn", "device_trace", "busy_time", "trace_annotation", "count",
           "recording", "records", "Records", "Span", "SPANS", "BUFFER"]

# A torch.profiler cycle can come back with no device activity, or without
# some of a replayed CUDA graph's kernels (each seen once on an H100, in a
# trace that succeeds on a second take): device_trace retakes it.
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


def device_trace(fn: Callable[[], object], calls: int = 5, short: Callable[[dict], bool] | None = None) -> dict:
    """Trace ``calls`` back-to-back calls of ``fn()`` with ``torch.profiler``
    and read the device's share of the window.

    Returns ``{"kernels": {name: ms per call}, "launches": {name: device
    operations per call}, "ops_per_call", "busy_ms", "busy_ms_by_device",
    "window_ms", "idle_share", "attempts"}`` (the launches of a replayed CUDA graph
    included, which no ``fsr.launch`` span sees).  The same calls run
    once first as the profiler's warm-up step, so its buffer set-up falls
    outside the recorded step.  The window runs from the host entering the
    first call to the end of the last device operation; busy is the union of
    the device operations' intervals clipped to the window (``busy_time``),
    over all devices and per device index (cards that overlap sum to more
    than the union).  A profiling cycle in
    which CUPTI delivered no device activity is taken again, at most
    ``TRACE_ATTEMPTS`` times in all; then it raises.  So is one whose
    reading ``short`` finds missing operations a call is known to launch
    (a replayed graph's kernel that CUPTI did not deliver); after the last
    attempt that reading is returned, for the caller's own check to refuse.
    ``"attempts"`` says how many cycles were taken."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    if not torch.cuda.is_available():
        raise RuntimeError("device_trace needs a CUDA device")
    cuda = torch.autograd.DeviceType.CUDA
    reading = None
    for attempt in range(1, TRACE_ATTEMPTS + 1):
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
        if not dev:
            continue
        reading = _reading(events, dev, calls, cuda)
        reading["attempts"] = attempt
        if short is None or not short(reading):
            break
    if reading is None:
        raise RuntimeError(f"the profiler recorded no device operation in {TRACE_ATTEMPTS} attempts")
    return reading


def _reading(events, dev, calls: int, cuda) -> dict:
    """``device_trace``'s reading of one profiling cycle: ``events``, all of
    it; ``dev``, its device operations."""
    start = min(e.time_range.start for e in events
                if e.name == "device_trace_window" and e.device_type != cuda)
    end = max(e.time_range.end for e in dev)
    kernels: dict = {}
    launches: dict = {}
    for e in dev:
        kernels[e.name] = kernels.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / calls
        launches[e.name] = launches.get(e.name, 0) + 1 / calls
    busy = busy_time(((e.time_range.start, e.time_range.end) for e in dev), start, end)
    by_device = {
        i: busy_time(((e.time_range.start, e.time_range.end) for e in dev if e.device_index == i), start, end) / 1e3
        for i in sorted({e.device_index for e in dev})
    }
    window = end - start
    return {
        "kernels": kernels,
        "launches": launches,
        "ops_per_call": len(dev) / calls,
        "busy_ms": busy / 1e3,
        "busy_ms_by_device": by_device,
        "window_ms": window / 1e3,
        "idle_share": 1.0 - busy / window,
    }


# --- spans and counters ------------------------------------------------------

# The port's spans, each named "fsr." and so none a benchmark harness's own.
SPANS = ("fsr.api", "fsr.dispatch", "fsr.launch", "fsr.spatial", "fsr.replay", "fsr.library", "fsr.capture")
# Spans the buffer holds, the newest; a traced stretch of 1,500 frame calls
# records ~9,000.
BUFFER = 1 << 16


class _Off:
    """The span while nothing records, shared by every call.  Its enter and
    exit are C callables, so a ``with`` runs no Python frame: entering
    returns ``tuple()``, the empty tuple; leaving returns ``"".format(...)``,
    the empty string, false, so an exception passes through."""

    __slots__ = ()
    __enter__ = staticmethod(tuple)
    __exit__ = staticmethod("".format)


_OFF = _Off()
# The profiler range a recorded span enters: the same at::RecordFunction as
# ``record_function``'s without its operator dispatch (under a profiler ~0.8
# us an enter and exit on the CPU against ~7 us; 7 us each of a frame call's
# spans added ~15% to its traced host time on the H100's host).
_range = torch._C._profiler._RecordFunctionFast
_buffer: collections.deque = collections.deque(maxlen=BUFFER)
_sinks: list = []  # the Records of the open recording() contexts
_forced = 0  # how many recording() contexts are open
_span_ids = itertools.count()
_call_ids = itertools.count()


class _Thread(threading.local):
    """Per thread: the open recorded spans, innermost last, and the call a
    finished ``leads`` root span hands to the next root span."""

    def __init__(self):
        self.stack: list = []
        self.lead = None


_per_thread = _Thread()


class Span:
    """A recorded span: ``name``; ``start``/``end``, host seconds
    (``time.perf_counter``); ``id``; ``parent``, its parent's id (None for
    a root); ``call``, shared by the spans of one call; ``args``, its
    counts and labels (None without any)."""

    __slots__ = ("name", "args", "start", "end", "id", "parent", "call", "_leads", "_rf")

    def __init__(self, name: str, key, value, leads: bool):
        self.name = name
        self.args = None if key is None else {key: value}
        self._leads = leads

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def __enter__(self) -> "Span":
        stack = _per_thread.stack
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent = None
            self.call = _per_thread.lead if _per_thread.lead is not None else next(_call_ids)
        self.id = next(_span_ids)
        self._rf = None
        if _autograd_profiler._is_profiler_enabled:
            self._rf = _range(self.name)
            self._rf.__enter__()
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.perf_counter()
        _per_thread.stack.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        if self.parent is None:
            _per_thread.lead = self.call if self._leads else None
        _buffer.append(self)
        for sink in _sinks:
            sink.append(self)


def trace_annotation(name: str, key=None, value=None, always: bool = False, leads: bool = False):
    """The span ``name`` around a ``with`` block, labelled ``key``=``value``
    when given.  Off (no profiler recording, no ``recording()``), the shared
    no-op, unless ``always`` (a set-up span, recorded whenever it runs).
    ``leads``: a root span that opens a call the next root span continues
    (``CapturedSpatial.writable`` before the call that reads what was
    written).  (Positional defaults: keyword-only ones cost a dictionary
    lookup each on every call.)"""
    if _forced or _autograd_profiler._is_profiler_enabled or always:
        return Span(name, key, value, leads)
    return _OFF


def count(key: str, n=1) -> None:
    """Add ``n`` to the count ``key`` of the innermost recorded span open
    on this thread; nothing while spans are off."""
    if _forced or _autograd_profiler._is_profiler_enabled:
        stack = _per_thread.stack
        if stack:
            span = stack[-1]
            if span.args is None:
                span.args = {}
            span.args[key] = span.args.get(key, 0) + n


class Records(list):
    """Recorded spans, oldest first, with the readers per call."""

    def named(self, name: str) -> list:
        return [s for s in self if s.name == name]

    def self_times(self, name: str) -> dict:
        """{call: the summed self time, in seconds, of its spans ``name``}:
        each span's duration less its children's (the spans of a thread
        follow one another, so their durations sum to what they cover)."""
        covered: dict = {}
        for s in self:
            if s.parent is not None:
                covered[s.parent] = covered.get(s.parent, 0.0) + s.seconds
        out: dict = {}
        for s in self:
            if s.name == name:
                out[s.call] = out.get(s.call, 0.0) + s.seconds - covered.get(s.id, 0.0)
        return out

    def counts(self, key: str) -> dict:
        """{call: the sum of the count ``key`` over its spans} for the calls
        whose spans carry it."""
        out: dict = {}
        for s in self:
            if s.args and key in s.args:
                out[s.call] = out.get(s.call, 0) + s.args[key]
        return out

    def launches(self) -> collections.Counter:
        """The kernels queued, by name (``fsr.launch``'s ``kernel``)."""
        return collections.Counter(s.args["kernel"] for s in self if s.name == "fsr.launch")


def records() -> Records:
    """The buffer's spans: the set-up spans and those recorded since,
    at most the newest ``BUFFER``."""
    return Records(_buffer)


@contextlib.contextmanager
def recording():
    """Spans on inside the block, with no profiler needed (tests, chip
    checks, operators); yields the ``Records`` of the spans that finish in
    it, filled as they finish.  A profiler's trace is taken only where one
    records."""
    global _forced
    rec = Records()
    _sinks.append(rec)
    _forced += 1
    try:
        yield rec
    finally:
        _forced -= 1
        _sinks.remove(rec)
