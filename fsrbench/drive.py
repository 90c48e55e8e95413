"""The general traffic generator: one configuration under one traffic mix.

A traffic mix is a data file (``fsrbench/traffic/<name>.json``) of
parameters that this module reads:

- ``entry``: the program's entry the calls go through, the module
  ``fsrbench/entries/<entry>.py``: ``upscale`` (``fsr_tpu_torch.upscale``
  on a batch on one card) or ``pipeline_rows`` (``UpscalePipeline(mesh=)``
  captured once per card, each frame's rows split over ``strips`` cards);
- ``batch``: frames per call; ``ring``: distinct input batches resident on
  the card(s), made from the seed, read in turn;
- ``in_flight``: calls dispatched ahead of the host (1: a sync after each
  call, whose latency is then read from the device's clock);
- ``keep_calls``: calls whose outputs are kept for the check, drawn from the
  seed among those the window reaches (the last call is kept too);
- ``trace_calls``: calls in the traced stretch of a ``--trace 1`` run.

The configuration (``fsrbench/configs/<name>.json``) gives the sizes,
types and options of each call.  The harness times the calls; this module
makes them.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from typing import List

import torch

__all__ = ["DTYPES", "SPANS", "frames", "call_options", "make_entry", "Calls", "Loop"]

DTYPES = {"uint8": torch.uint8, "uint16": torch.uint16, "float16": torch.float16, "bfloat16": torch.bfloat16,
          "float32": torch.float32}
# The harness's host spans, as the traced stretch names them.
SPANS = ("producer write", "issue", "wait", "output check")


def call_options(cfg: dict) -> dict:
    """The configuration's options of an ``upscale`` call or a pipeline."""
    return dict(sharpness=cfg["sharpness_stops"], apply_rcas=cfg["apply_rcas"], denoise=cfg["denoise"],
                compute_dtype=DTYPES[cfg["compute_dtype"]], out_dtype=DTYPES[cfg["out_dtype"]])


def frames(cfg, traffic, seed, device) -> List[torch.Tensor]:
    """The ring of input batches, uniform random bytes made on ``device``
    from the seed."""
    if cfg["in_dtype"] != "uint8":
        raise ValueError(f"the frames are uint8 sources, not {cfg['in_dtype']}")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    shape = (traffic["batch"], cfg["channels"], *cfg["in_size"])
    return [torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen, device=device)
            for _ in range(traffic["ring"])]


class _Events:
    """The done events of the calls in flight, one per card per call."""

    def __init__(self, devices):
        self.devices = devices
        self.cuda = devices[0].type == "cuda"
        self.pending: List[list] = []

    def record(self) -> None:
        if self.cuda:
            evs = []
            for d in self.devices:
                e = torch.cuda.Event()
                e.record(torch.cuda.current_stream(d))
                evs.append(e)
            self.pending.append(evs)

    def wait_until(self, n: int) -> None:
        """Wait until at most ``n`` calls are in flight."""
        while len(self.pending) > n:
            for e in self.pending.pop(0):
                e.synchronize()

    def sync(self) -> None:
        self.pending.clear()
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)


def make_entry(cfg, traffic, seed, devices):
    """The traffic's entry: ``fsrbench/entries/<entry>.py``'s ``Entry``."""
    return importlib.import_module(f"fsrbench.entries.{traffic['entry']}").Entry(cfg, traffic, seed, devices)


class Calls:
    """What a run of calls left: how many, the latency of each (ms, with
    one call in flight), each call's host issue time (s, when asked for),
    and the kept outputs."""

    def __init__(self):
        self.n = 0
        self.latency_ms: List[float] = []
        self.issue_s: List[float] = []
        self.kept: list = []
        self.last = None


class Loop:
    """The traffic's closed loop over an entry: at most ``in_flight`` calls
    dispatched ahead of the host; with one, each call's latency from the
    device's clock (a timing event recorded as the host enters the call, on
    an idle stream, and one after it, then a wait on the latter)."""

    def __init__(self, entry, traffic):
        self.entry, self.traffic = entry, traffic
        self.events = _Events(entry.devices)
        self.cuda = self.events.cuda
        self.latency = traffic["in_flight"] == 1
        # Calls issued so far, set-up's included: the ring advances by one
        # slot a call throughout, so no call reads the slot of the one before.
        self.issued = 0
        if self.cuda and self.latency:
            self.start, self.end = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))

    def run(self, calls: Calls, n=None, deadline=None, keep_at=(), issue=False, span=None) -> Calls:
        """Issue calls until ``n`` of them or the host clock passes
        ``deadline``; keep the outputs of the calls in ``keep_at`` (counted
        from this run's first); with
        ``issue``, record each call's host issue time; ``span(name)``: the
        host spans' context (none by default).  Returns ``calls`` with these
        added; the last calls may still be in flight (``sync``)."""
        span = span or (lambda name: contextlib.nullcontext())
        entry, events, ahead = self.entry, self.events, self.traffic["in_flight"] - 1
        timing = self.cuda and self.latency
        stop = calls.n + n if n is not None else None
        while (stop is None or calls.n < stop) and (deadline is None or time.perf_counter() < deadline):
            i = self.issued
            with span("wait"):
                events.wait_until(ahead)
            if timing:
                self.start.record()
            t = time.perf_counter()
            with span("producer write"):
                entry.produce(i)
            with span("issue"):
                out = entry.call(i)
            t_issue = time.perf_counter()
            if issue:
                calls.issue_s.append(t_issue - t)
            if timing:
                self.end.record()
            events.record()
            if calls.n in keep_at:
                with span("output check"):
                    calls.kept.append(entry.keep(i, out))
            if self.latency:
                with span("wait"):
                    if timing:
                        self.end.synchronize()
                        calls.latency_ms.append(self.start.elapsed_time(self.end))
                    else:
                        events.sync()
                        calls.latency_ms.append((time.perf_counter() - t) * 1e3)
            calls.last = (i, out)
            calls.n += 1
            self.issued += 1
        return calls

    def sync(self) -> None:
        self.events.sync()
