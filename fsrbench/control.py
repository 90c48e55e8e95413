"""Readings that set a cell's limits (not run by the benchmark's runs).

``python3 fsrbench/control.py --workload <cell> --seeds 1,2,3 --seconds 2``
runs, for each seed in one process, the cell's set-up and a short window
at its own load, and prints one JSON line per seed with the readings of
``check.readings`` for:

- ``program``: the kept frames of the timed path against the reference
  (the lower reading of each compared number);
- ``control``: the reference computed in bfloat16 put in the program's
  place, on the same sources (the upper reading);
- ``program_float16`` (cells through ``upscale``): the program's own
  lower-precision path on the same sources, ``compute_dtype=float16``
  (K6, the sample's FsrEasuH + FsrRcasH), a second witness.

The program's bfloat16 storage is no control here: a byte source and a byte
output never pass through the storage type.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from fsrbench import check, drive, harness  # noqa: E402


def readings(cell_name: str, seed: int, seconds: float, root: pathlib.Path, devices=None) -> dict:
    bench, cell, cfg, traffic = harness.load_cell(root, root / "fsrbench", cell_name)
    devs = devices or [torch.device("cuda", i) for i in range(cell["chips"])]
    entry, loop, keep_at = harness.setup(cfg, traffic, seed, seconds, devs)
    calls, _ = harness.window(entry, loop, seconds, keep_at)
    pairs = list(entry.pairs(calls.kept))
    out = {"seed": seed, "calls": calls.n, "program": check.readings(pairs, cfg, devs[0]),
           "control": check.readings(pairs, cfg, devs[0], candidate=check.control(cfg))}
    if traffic["entry"] == "upscale":
        kw = dict(entry.kw, compute_dtype=torch.float16)
        half = [(entry.api.upscale(ins["src"][None], **kw)[0], ins) for _, ins in pairs]
        out["program_float16"] = check.readings(half, cfg, devs[0])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    root = pathlib.Path(__file__).resolve().parent.parent
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = readings(args.workload, seed, args.seconds, root)
        r["wall_s"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
