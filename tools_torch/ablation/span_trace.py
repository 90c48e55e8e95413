"""A benchmark cell's host time by the program's spans, on the card.

    python3 tools_torch/ablation/span_trace.py --workload perf2x-u8.frame-b1 [--seed N] [--calls N]

Sets the cell up as ``fsrbench/run.py`` does (``fsrbench.harness.setup``:
its frames, entry and warm-up), then reads what the benchmark's traced run
cannot print:

1. the spans' cost while off: ns per ``trace_annotation`` enter and exit
   (bare, and labelled as ``fsr.launch`` is) and per ``count``, and so the
   host us per call, from the spans and counts one call of the cell opens;
2. one traced stretch of the cell's loop as ``fsrbench/devtrace.py`` takes
   it (a warm-up step, then a recorded one, ``--calls`` calls, default the
   traffic's ``trace_calls``), spans on: each call's host issue time, and
   per call the self time of each ``fsr.*`` span (the program's records);
   then the same stretch with every span forced off (``trace_annotation``
   replaced by its no-op): the on cost, median issue ms on against off;
   and in each the full garbage collections (ms each), which stall a call;
3. from the on stretch's profiler trace, the ten longest idle gaps of each
   card, each with the innermost ``fsr.*`` span over most of it (a span's
   part of the gap less its ``fsr.*`` children's) and the harness's span
   there;
4. on one card, each K1 kernel's start against the ``fsr.launch`` range
   that queued it (the n-th launch range of the stretch for its n-th K1
   kernel): whether every kernel starts after its range begins, and the
   distance from the range's end to the kernel's start.

Prints the card's name and power limit and, last, one JSON line.  Exits
non-zero without the cell's cards.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
# The ten longest gaps, as the benchmark's ``breakdown`` keeps them.
TOP = 10


def _ns_per(fn, n: int = 200_000, rounds: int = 7) -> float:
    """The least over ``rounds`` of the ns per iteration of ``fn(n)``, less
    an empty loop's."""
    def empty(n):
        for _ in range(n):
            pass

    def best(f):
        times = []
        for _ in range(rounds):
            t = time.perf_counter()
            f(n)
            times.append(time.perf_counter() - t)
        return min(times) / n * 1e9

    return best(fn) - best(empty)


def off_cost() -> dict:
    """ns per span enter and exit and per count, with nothing recording."""
    from fsr_tpu_torch.utils import profiling

    def bare(n):
        for _ in range(n):
            with profiling.trace_annotation("fsr.api"):
                pass

    def labelled(n):
        for _ in range(n):
            with profiling.trace_annotation("fsr.launch", "kernel", "K1"):
                pass

    def count(n):
        for _ in range(n):
            profiling.count("plans_built")

    return {"span_ns": _ns_per(bare), "labelled_span_ns": _ns_per(labelled), "count_ns": _ns_per(count)}


def _stretch(loop, n: int):
    """The profiled stretch: a warm-up step and a recorded one of ``n``
    calls each, as ``fsrbench/devtrace.py`` takes it; (the recorded step's
    events, its calls, the ms of each full garbage collection in it)."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, record_function, schedule

    from fsrbench import devtrace, drive

    traced, calls, full, t = [], [], [], {}

    def collected(phase, info):
        if info["generation"] == 2:
            if phase == "start":
                t["start"] = time.perf_counter()
            elif len(calls) == 2:
                full.append(1e3 * (time.perf_counter() - t["start"]))

    gc.callbacks.append(collected)
    try:
        with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                    schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                                    on_trace_ready=lambda p: traced.append(p.events())) as prof:
            for _ in range(2):
                calls.append(drive.Calls())
                with record_function(devtrace.WINDOW):
                    loop.run(calls[-1], n=n, issue=True, span=record_function)
                    loop.sync()
                prof.step()
    finally:
        gc.callbacks.remove(collected)
    return traced[0], calls[-1], full


def _gap_labels(events, spans, harness) -> list:
    """The ``TOP`` longest idle gaps of each card inside the stretch:
    (seconds, card, the innermost ``fsr.*`` span over most of it, the
    harness's span over most of it)."""
    import torch

    from fsrbench import devtrace

    cuda = torch.autograd.DeviceType.CUDA
    names = set(spans) | set(harness) | {devtrace.WINDOW}
    dev = [e for e in events if e.device_type == cuda and e.name not in names
           and not getattr(e, "is_user_annotation", False)]
    host = [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type != cuda and (e.name in spans or e.name in harness)]
    start = min(e.time_range.start for e in events if e.name == devtrace.WINDOW and e.device_type != cuda)
    end = max(e.time_range.end for e in dev)
    gaps = []
    for card in sorted({e.device_index for e in dev}):
        busy = devtrace._union(((e.time_range.start, e.time_range.end) for e in dev if e.device_index == card),
                               start, end)
        edges = [start] + [x for s, e in busy for x in (s, e)] + [end]
        gaps += [(e - s, card, s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]
    out = []
    for length, card, s, e in sorted(gaps, reverse=True)[:TOP]:
        over = [(n, a, b) for n, a, b in host if b > s and a < e]

        def part(a, b):
            return max(0.0, min(b, e) - max(a, s))

        mine = {}
        for n, a, b in over:
            if n not in spans:
                continue
            inner = sum(part(a2, b2) for n2, a2, b2 in over
                        if n2 in spans and (a2, b2, n2) != (a, b, n) and a <= a2 and b2 <= b)
            mine[n] = mine.get(n, 0.0) + part(a, b) - inner
        theirs = {}
        for n, a, b in over:
            if n in harness:
                theirs[n] = theirs.get(n, 0.0) + part(a, b)
        out.append({"us": length, "card": card,
                    "span": max(mine, key=mine.get) if mine and max(mine.values()) > 0 else "none",
                    "harness": max(theirs, key=theirs.get) if theirs else "none"})
    return out


def _launch_clock(events) -> dict:
    """Each K1 kernel (``fused_kernel``) against the ``fsr.launch`` range
    that queued it: the n-th range for the n-th kernel.  us from the
    range's end to the kernel's start."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ranges = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.device_type != cuda and e.name == "fsr.launch")
    kernels = sorted(e.time_range.start for e in events if e.device_type == cuda and "fused_kernel" in e.name
                     and not getattr(e, "is_user_annotation", False))
    if not kernels or len(kernels) != len(ranges):
        return {"kernels": len(kernels), "launch_ranges": len(ranges)}
    after = [k - r1 for k, (r0, r1) in zip(kernels, ranges)]
    return {"kernels": len(kernels), "launch_ranges": len(ranges),
            "all_start_inside_or_after": all(k >= r0 for k, (r0, _) in zip(kernels, ranges)),
            "us_after_range_end": {"min": min(after), "median": statistics.median(after), "max": max(after)}}


def _per_call(records, spans) -> dict:
    """Median us per call of each span's self time, over the calls."""
    calls = set().union(*(records.self_times(n) for n in spans))
    out = {}
    for name in spans:
        got = records.self_times(name)
        out[name] = 1e6 * statistics.median(got.get(c, 0.0) for c in calls) if calls else None
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2_900_000_077)
    ap.add_argument("--calls", type=int, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import pathlib

    import torch

    from fsr_tpu_torch.utils import profiling
    from fsrbench import drive, harness

    bench, cell, cfg, traffic = harness.load_cell(pathlib.Path(ROOT), pathlib.Path(ROOT) / "fsrbench",
                                                  args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"span_trace: {args.workload} needs {cell['chips']} CUDA device(s)", file=sys.stderr)
        return 2
    devs = [torch.device("cuda", i) for i in range(cell["chips"])]
    entry, loop, _ = harness.setup(cfg, traffic, args.seed, 5.0, devs)
    n = args.calls or traffic["trace_calls"]
    out = {"workload": args.workload, "torch": torch.__version__, "off": off_cost()}

    newest = max((s.id for s in profiling.records() if isinstance(s.id, int)), default=-1)
    events, calls, full = _stretch(loop, n)
    rec = profiling.Records(s for s in profiling.records() if s.id > newest)
    spans = [s for s in profiling.SPANS if rec.named(s)]
    per_call = {name: len(rec.named(name)) / max(1, len({s.call for s in rec if s.name in spans}))
                for name in spans}
    counted = sum(rec.counts("plans_built").values()) / max(1, len({s.call for s in rec}))
    off = out["off"]
    out["spans_per_call"] = per_call
    out["off_us_per_call"] = 1e-3 * (sum(per_call.values()) * off["span_ns"]
                                     + per_call.get("fsr.launch", 0) * (off["labelled_span_ns"] - off["span_ns"])
                                     + counted * off["count_ns"])
    out["self_us_per_call"] = _per_call(rec, spans)
    roots = [s.seconds for s in rec if s.parent is None and s.name in ("fsr.api", "fsr.spatial")]
    out["root_span_us_median"] = 1e6 * statistics.median(roots) if roots else None
    out["issue_ms_on"] = 1e3 * statistics.median(calls.issue_s)
    out["full_gc_ms_on"] = full
    out["gaps"] = _gap_labels(events, profiling.SPANS, drive.SPANS)
    if len(devs) == 1:
        out["launch_clock"] = _launch_clock(events)

    on = profiling.trace_annotation
    profiling.trace_annotation = lambda *a, **k: profiling._OFF
    try:
        _, calls_off, full_off = _stretch(loop, n)
    finally:
        profiling.trace_annotation = on
    out["issue_ms_forced_off"] = 1e3 * statistics.median(calls_off.issue_s)
    out["full_gc_ms_forced_off"] = full_off
    entry.release()
    card = torch.cuda.get_device_name(0)
    print(f"{args.workload}: {card}, power limit {harness._card()}")
    for k, v in out.items():
        print(f"  {k}: {v}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
