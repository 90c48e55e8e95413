"""One run of one cell: ``python3 fsrbench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` from the root of a checkout.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration (``configs/<name>.json``, the file
the manifest names), its traffic mix (``traffic/<name>.json``, read by
``drive``), its reference (``reference/<name>.py``, named by the
configuration) and each metric's reader (``metrics/<name>.py``: the
metric's whole name where such a file exists, else its name up to its
first dot).  A run:

1. refuses to run without the cards the cell asks for;
2. makes its frames on the card from the seed, builds the entry, and warms
   up every shape the cell uses (set-up, from process start);
3. issues calls for ``--seconds`` (the window), keeping the outputs of a
   few calls drawn from the seed and the last;
4. with ``--trace 1``, records each call's host issue time over the window
   and then traces a short stretch of the same loop with ``torch.profiler``;
5. reads the peak memory, frees the program's state, and compares every
   kept frame with the plain reference (``check``);
6. refuses to print a result if JAX or the JAX package was loaded;
7. prints the compared numbers beside their limits on standard error and,
   last on standard output, the result line.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import pathlib
import random
import statistics
import sys
import time
import types

import torch

from fsrbench import check, devtrace, drive, roofline

__all__ = ["main", "setup", "window", "load_cell", "metrics_of", "reader", "FORBIDDEN"]

HERE = pathlib.Path(__file__).resolve().parent
# Top-level module names a run may not have loaded once its window closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "fsr_tpu")
# The share of the window in which the kept calls are drawn, so that the
# window reaches them whatever its pace.
KEEP_SHARE = 0.75
# Host seconds of calls timed in set-up to estimate a call's pace.
PACE_S = 0.5


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_cell(root: pathlib.Path, bench_dir: pathlib.Path, name: str):
    """(manifest, cell, configuration, traffic) of the cell ``name``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, cfg, traffic


def metrics_of(bench: dict, cell: dict, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: with ``trace`` the per-layer
    ones that list it, else the end-to-end ones that list it or list no
    cells."""
    if trace:
        return [m for m in bench["per_layer"] if cell["name"] in m["workloads"]]
    return [m for m in bench["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]


def reader(bench_dir: pathlib.Path, metric: str):
    """The ``read(run)`` of a metric: ``metrics/<name>.py``, else
    ``metrics/<name up to its first dot>.py``."""
    path = bench_dir / "metrics" / f"{metric}.py"
    if not path.exists():
        path = bench_dir / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"fsrbench_metric_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _devices(chips: int):
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {chips} CUDA device(s); found {found}", file=sys.stderr)
        raise SystemExit(2)
    return [torch.device("cuda", i) for i in range(chips)]


def _card() -> str:
    """Each card's name, power limit and clocks, as nvidia-smi reads them
    (empty where it cannot): the numbers' context on standard error."""
    import subprocess

    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return ""
    return res.stdout.strip().replace("\n", " | ")


def setup(cfg, traffic, seed, seconds, devs, phases=None):
    """The frames from the seed, the entry and every shape it uses warmed
    up; the allocator's cache holding as many outputs as the window holds;
    the calls whose outputs the window keeps, drawn from the seed among
    those it reaches at the pace of a few calls timed here.  Returns
    (entry, loop, the kept calls' indices); ``phases`` (a dict) gets each
    step's host seconds."""
    phases = {} if phases is None else phases
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        phases[name] = now - t
        t = now

    entry = drive.make_entry(cfg, traffic, seed, devs)
    loop = drive.Loop(entry, traffic)
    lap("frames and entry")
    warm = drive.Calls()
    loop.run(warm, n=2)
    loop.sync()
    lap("first calls")
    n_held = traffic["keep_calls"] + traffic["in_flight"] + 1
    loop.run(warm, n=n_held, keep_at=range(warm.n, warm.n + n_held))
    loop.sync()
    del warm
    lap("held outputs")
    pace = drive.Calls()
    loop.run(pace, deadline=t + PACE_S)
    loop.sync()
    call_s = (time.perf_counter() - t) / pace.n
    del pace
    gc.collect()
    lap("pace")
    reach = max(traffic["keep_calls"], int(KEEP_SHARE * seconds / call_s))
    return entry, loop, set(random.Random(seed).sample(range(reach), traffic["keep_calls"]))


def window(entry, loop, seconds, keep_at, issue=False):
    """Calls for ``seconds`` of the host clock, then a wait for the last:
    (the calls, the window's seconds to that wait's end); the outputs of
    the calls in ``keep_at`` kept, and the last call's after the window."""
    calls = drive.Calls()
    t0 = time.perf_counter()
    loop.run(calls, deadline=t0 + seconds, keep_at=keep_at, issue=issue)
    loop.sync()
    t1 = time.perf_counter()
    if calls.n - 1 not in keep_at:
        calls.kept.append(entry.keep(*calls.last))
    calls.last = None
    return calls, t1 - t0


def main(argv=None, *, t_start=None, root=None, devices=None) -> int:
    """Run one cell; returns the exit code.  ``devices`` (tests only) runs
    on those devices without looking for a card."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = _args(argv)
    root = pathlib.Path(root) if root is not None else HERE.parent
    bench_dir = root / "fsrbench"
    bench, cell, cfg, traffic = load_cell(root, bench_dir, args.workload)
    wanted = metrics_of(bench, cell, bool(args.trace))
    devs = _devices(cell["chips"]) if devices is None else list(devices)
    cuda = devs[0].type == "cuda"

    phases = {"imports and card": time.perf_counter() - t_start}
    entry, loop, keep_at = setup(cfg, traffic, args.seed, args.seconds, devs, phases)
    setup_s = time.perf_counter() - t_start
    calls, seconds = window(entry, loop, args.seconds, keep_at, issue=bool(args.trace))

    trace = None
    if args.trace:
        from torch.profiler import record_function

        def stretch():
            part = loop.run(drive.Calls(), n=traffic["trace_calls"], span=record_function)
            loop.sync()
            return part.n * traffic["batch"]

        trace = devtrace.profile(stretch, drive.SPANS)

    peak = max(torch.cuda.max_memory_allocated(d) for d in devs) if cuda else 0
    kept, pairs = calls.kept, entry.pairs
    entry.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    run = types.SimpleNamespace(cfg=cfg, traffic=traffic, cell=cell, calls=calls, seconds=seconds,
                                setup_s=setup_s, trace=trace, floor_s=roofline.floor_s_per_frame(cfg)[0])
    metrics = {}
    for m in wanted:
        value = reader(bench_dir, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if calls.latency_ms:
        lat, k = calls.latency_ms, max(1, len(calls.latency_ms) // 10)
        tenths = [statistics.median(lat[i:i + k]) for i in range(0, len(lat) - k + 1, k)]
        print(f"latency samples: {len(lat)}; median ms by tenth of the window: "
              + " ".join(f"{v:.4f}" for v in tenths), file=sys.stderr)
    print("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()), file=sys.stderr)
    print(f"window: {calls.n} calls of {traffic['batch']} frames in {seconds:.6f} s; set-up {setup_s:.6f} s; "
          f"card: {_card() if cuda else 'none'}", file=sys.stderr)

    readings = check.readings(pairs(kept), cfg, devs[0])
    del kept
    limits = cfg["check"]
    compared = {k: {"value": readings.get(k, float("inf")), "limit": limits[k]} for k in limits}
    correct = (readings["frames"] > 0 and not readings["frames_wrong_shape"]
               and all(v["value"] <= v["limit"] for v in compared.values()))

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"the run loaded {loaded}: the benchmark measures the PyTorch port alone", file=sys.stderr)
        return 3

    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(devs[0]) if cuda else "cpu",
              "count": len(devs), "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": calls.n * traffic["batch"], "failed": 0, "metrics": metrics,
              "device": device}
    if trace is not None:
        busy = trace.busy_s_by_device()
        device["busy_s"] = statistics.fmean(busy.values()) if busy else 0.0
        device["window_s"] = trace.window_s
        result["breakdown"] = devtrace.breakdown(trace, len(devs))
    result["compared"] = compared
    print("frames compared: " + ", ".join(f"{k} {v}" for k, v in readings.items() if k not in compared),
          file=sys.stderr)
    for k, v in compared.items():
        print(f"{k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
