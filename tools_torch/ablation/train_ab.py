"""The training example against a parent commit's on the H100, run in turn.

    python3 tools_torch/ablation/train_ab.py [--parent DIR] [--steps N]

Runs ``examples_torch/train_through_fsr.py`` as a user does, one process
per run, from this checkout and from the parent's (DIR, default
``_parent``: a ``git archive`` of the parent commit unpacked at the root of
the checkout), in turn: parent, this, this, parent, for each mode
(inverse, prefilter), each at ``--steps N`` (default the example's 300)
and at ``--steps 0``.  Both kernel libraries are built first, in parallel,
so no run builds.  Prints each run's wall seconds (host clock around the
process), each tree's median at N steps and at 0 steps and their
difference (the steps alone; a run at 0 steps still builds its problem and,
in a tree that captures the step, captures it), and whether the two
trees' runs print the same lines and exit with the same code, with the
card's name and power limit.  Exits non-zero without a card or parent
sources, or when a run fails in another way than the example's exit rule
(exit code 1 at 0 steps, where nothing was trained).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
EXAMPLE = pathlib.Path("examples_torch") / "train_through_fsr.py"
BUILD = "from fsr_tpu_torch.kernels import _build; _build.library()"


def _run(tree: pathlib.Path, mode: str, steps: int):
    """One run of the example in ``tree``: (wall seconds, exit code,
    standard output)."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(EXAMPLE), mode, "--steps", str(steps)], cwd=tree,
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode not in (0, 1) or (res.returncode == 1 and steps > 0):
        raise RuntimeError(f"{tree.name} {mode} --steps {steps}: exit {res.returncode}\n{res.stdout}{res.stderr}")
    return wall, res.returncode, res.stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=str(ROOT / "_parent"),
                    help="root of the parent commit's checkout (default _parent)")
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("train_ab: no CUDA device", file=sys.stderr)
        return 2
    trees = {"parent": pathlib.Path(args.parent).resolve(), "this": ROOT}
    if not (trees["parent"] / EXAMPLE).is_file():
        print(f"train_ab: no parent sources under {trees['parent']}", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0].strip()
    with concurrent.futures.ThreadPoolExecutor(len(trees)) as pool:
        for fut in [pool.submit(subprocess.run, [sys.executable, "-c", BUILD], cwd=t, check=True,
                                capture_output=True) for t in trees.values()]:
            fut.result()
    order = ("parent", "this", "this", "parent")
    for mode in ("inverse", "prefilter"):
        walls = {(k, n): [] for k in trees for n in (args.steps, 0)}
        outs = {}
        for n in (args.steps, 0):
            for k in order:
                wall, rc, out = _run(trees[k], mode, n)
                walls[k, n].append(wall)
                outs.setdefault((k, n), (rc, out))
                print(f"{mode} --steps {n} {k}: {wall:.3f} s, exit {rc}")
        same = outs["parent", args.steps] == outs["this", args.steps]
        med = {key: statistics.median(v) for key, v in walls.items()}
        steps = {k: med[k, args.steps] - med[k, 0] for k in trees}
        print(f"{mode}: {args.steps} steps {med['parent', args.steps]:.3f} s (parent) against "
              f"{med['this', args.steps]:.3f} s (this), {med['parent', args.steps] / med['this', args.steps]:.2f}x; "
              f"--steps 0 {med['parent', 0]:.3f} / {med['this', 0]:.3f} s; the steps alone "
              f"{steps['parent']:.3f} / {steps['this']:.3f} s ({steps['parent'] / steps['this']:.2f}x, "
              f"{steps['parent'] / args.steps * 1e3:.3f} / {steps['this'] / args.steps * 1e3:.3f} ms per step); "
              f"the same lines and exit code: {same}; {card}")
        if not same:
            for k in trees:
                print(f"--- {k}, exit {outs[k, args.steps][0]}:\n{outs[k, args.steps][1]}")
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
