"""The window's arithmetic: a stall inside the window lowers the rate and
raises the tail, because both are taken over every call of the window."""

import time
import types

import pytest
import torch

from fsrbench import drive, harness
from fsrbench.conftest import BENCH
from fsrbench.metrics import frames_per_s, latency_ms_p50, latency_ms_p95


class _Sleeper:
    """An entry whose calls take ``base`` seconds, and ``stall`` more on
    every ``every``-th call."""

    def __init__(self, base, stall=0.0, every=4):
        self.devices = [torch.device("cpu")]
        self.base, self.stall, self.every = base, stall, every

    def produce(self, i):
        pass

    def call(self, i):
        time.sleep(self.base + (self.stall if i % self.every == self.every - 1 else 0.0))
        return i

    def keep(self, i, out):
        return i, out


def _window(entry, in_flight, seconds=0.4):
    traffic = {"in_flight": in_flight, "batch": 4}
    loop = drive.Loop(entry, traffic)
    calls = drive.Calls()
    t0 = time.perf_counter()
    loop.run(calls, deadline=t0 + seconds)
    loop.sync()
    return types.SimpleNamespace(calls=calls, seconds=time.perf_counter() - t0, traffic=traffic)


@pytest.mark.parametrize("in_flight", [1, 2])
def test_a_stall_lowers_the_rate(in_flight):
    steady = _window(_Sleeper(0.002), in_flight)
    stalled = _window(_Sleeper(0.002, stall=0.010), in_flight)
    assert frames_per_s.read(stalled) < 0.8 * frames_per_s.read(steady)


def test_a_stall_raises_the_tail_and_not_the_median():
    steady = _window(_Sleeper(0.002), 1)
    stalled = _window(_Sleeper(0.002, stall=0.010), 1)  # a quarter of the calls 10 ms longer
    assert latency_ms_p95.read(stalled) > latency_ms_p95.read(steady) + 5.0
    assert latency_ms_p50.read(stalled) < latency_ms_p50.read(steady) + 2.0


def test_latency_only_with_one_call_in_flight():
    ahead = _window(_Sleeper(0.001), 2, seconds=0.1)
    assert latency_ms_p50.read(ahead) is None and latency_ms_p95.read(ahead) is None


def test_rate_counts_every_frame_over_the_whole_window():
    w = _window(_Sleeper(0.001), 2, seconds=0.2)
    assert frames_per_s.read(w) == pytest.approx(w.calls.n * 4 / w.seconds)


class _Trace:
    """A traced stretch of ``frames`` frames with ``busy`` device seconds on
    one card in ``window`` seconds."""

    def __init__(self, frames, busy, window):
        self.frames, self.busy, self.window_s = frames, busy, window

    def busy_s_by_device(self):
        return {0: self.busy}


def test_latency_idle_reads_the_untraced_window():
    """The frame cell's idle share takes the pace from the window run with
    the profiler off, not from the traced stretch, whose own host work would
    read as idle: 0.2 ms of the card's time a frame, 2,500 frames a second
    in the window, so the card idles half the window; the traced stretch,
    paced by the profiler at 0.5 ms a frame, would read 60%."""
    run = types.SimpleNamespace(calls=types.SimpleNamespace(n=25_000), seconds=10.0, traffic={"batch": 1},
                                trace=_Trace(frames=1000, busy=0.2, window=0.5))
    assert harness.reader(BENCH, "device_idle_pct.latency")(run) == pytest.approx(50.0)
    assert harness.reader(BENCH, "device_idle_pct.throughput")(run) == pytest.approx(60.0)
