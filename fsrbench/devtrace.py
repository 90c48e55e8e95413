"""Reading the device's side of a stretch of calls from ``torch.profiler``.

``busy_time`` and the profiling cycle are frozen copies of
``fsr_tpu_torch/utils/profiling.py`` (``busy_time``, ``device_trace``), so
that a change to the program cannot move the yardstick: the busy union is
clipped to the window, and a cycle in which CUPTI delivered no device
operation is taken again.  Beyond the original, the reading keeps every
device operation (name, card, interval) and the harness's own host spans,
so that idle gaps can be labelled with what the host was doing.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Iterable, List, Tuple

import torch

__all__ = ["busy_time", "Reading", "profile", "gaps", "breakdown"]

TRACE_ATTEMPTS = 3
WINDOW = "fsrbench_window"


def busy_time(intervals: Iterable[Tuple[float, float]], start: float, end: float) -> float:
    """Length of the union of the (start, end) intervals, each clipped to
    the window [start, end] first."""
    return sum(e - s for s, e in _union(intervals, start, end))


def _union(intervals, start: float, end: float) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted((max(s, start), min(e, end)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclasses.dataclass
class Reading:
    """One traced stretch, times in seconds on the profiler's clock.
    ``ops``: (name, card index, start, end) of every device operation
    (kernel, copy, memset); ``spans``: (name, start, end) of the harness's
    host spans; ``start``/``end``: from the host entering the stretch to the
    end of its last device operation; ``frames``: output frames its calls
    made."""

    ops: List[Tuple[str, int, float, float]]
    spans: List[Tuple[str, float, float]]
    start: float
    end: float
    frames: int
    attempts: int

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s_by_device(self) -> dict:
        return {d: busy_time(((s, e) for _, dd, s, e in self.ops if dd == d), self.start, self.end)
                for d in sorted({d for _, d, _, _ in self.ops})}


def profile(stretch: Callable[[], int], span_names: Tuple[str, ...]) -> Reading:
    """Trace ``stretch()`` (which runs its calls, waits for them, and
    returns the frames they made) with ``torch.profiler``: it runs once as
    the profiler's warm-up step and once recorded."""
    from torch.profiler import ProfilerActivity, record_function, schedule

    cuda = torch.autograd.DeviceType.CUDA
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        traced, frames = [], []
        with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: traced.append(p.events()),
        ) as prof:
            for _ in range(2):
                with record_function(WINDOW):
                    frames.append(stretch())
                prof.step()
        events = traced[0]
        dev = [e for e in events if e.device_type == cuda and e.name != WINDOW and e.name not in span_names
               and not getattr(e, "is_user_annotation", False)]
        if not dev:
            continue
        start = min(e.time_range.start for e in events if e.name == WINDOW and e.device_type != cuda)
        end = max(e.time_range.end for e in dev)
        ops = [(e.name, e.device_index, e.time_range.start / 1e6, e.time_range.end / 1e6) for e in dev]
        spans = [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6) for e in events
                 if e.name in span_names and e.device_type != cuda]
        return Reading(ops, spans, start / 1e6, end / 1e6, frames[-1], attempt)
    raise RuntimeError(f"the profiler recorded no device operation in {TRACE_ATTEMPTS} attempts")


def _overlap(spans, starts, s: float, e: float) -> str:
    """The harness span that covers most of [s, e]; "none" where none does.
    ``spans`` are sorted by start and follow one another (``starts``, their
    starts)."""
    best, label = 0.0, "none"
    k = bisect.bisect_right(starts, e) - 1
    while k >= 0 and spans[k][2] > s:
        name, ss, ee = spans[k]
        cover = min(e, ee) - max(s, ss)
        if cover > best:
            best, label = cover, name
        k -= 1
    return label


def gaps(r: Reading) -> List[Tuple[str, int, float]]:
    """Every idle gap of each card inside the window, as (the harness span
    that covers most of it on the host, card, seconds)."""
    out = []
    spans = sorted(r.spans, key=lambda sp: sp[1])
    starts = [sp[1] for sp in spans]
    for d in sorted({d for _, d, _, _ in r.ops}):
        busy = _union(((s, e) for _, dd, s, e in r.ops if dd == d), r.start, r.end)
        edges = [r.start] + [x for s, e in busy for x in (s, e)] + [r.end]
        for s, e in zip(edges[::2], edges[1::2]):
            if e > s:
                out.append((_overlap(spans, starts, s, e), d, e - s))
    return out


def breakdown(r: Reading, cards: int, top: int = 10) -> dict:
    """The contract's ``breakdown``: the device operations that took the
    most time (seconds summed by name over the stretch), and the longest
    idle gaps by what the host was doing (with the card, on several)."""
    by_name: dict = {}
    for name, _, s, e in r.ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps(r), key=lambda g: -g[2])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[f"{label} (cuda:{d})" if cards > 1 else label, s] for label, d, s in idle]}
