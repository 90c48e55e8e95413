"""Test settings of the benchmark's own tests (``fsrbench/tests``).

Run them with ``python -m pytest fsrbench/tests -q`` from the repository's
root.  ``card`` marks a test that needs a CUDA card: it skips inside the
test, never at import.  ``tiny_tree`` is a copy of the benchmark whose
configurations are cut to a few dozen rows, for runs on the CPU.  The tests
read their cells from ``BENCHMARK.json`` (``cells``) and size each tiny
configuration from its own sizes (``tiny_sizes``), so a cell added as files
and manifest entries is covered with no test edited.
"""

import json
import pathlib
import shutil

import pytest

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
# The tiny copies' source size (rows, columns) and most frames per call.
TINY_IN = (32, 48)
TINY_BATCH = 4


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one, inside the test)")


def need_card(n: int = 1):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA card(s)")


def cells() -> list:
    """(name, chips, traffic mix) of each cell of ``BENCHMARK.json``, in its
    order."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [(w["name"], w["chips"], json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text()))
            for w in bench["workloads"]]


def tiny_sizes(cfg: dict) -> tuple:
    """(in, out) sizes of a configuration's tiny copy: a ``TINY_IN`` source
    and the output at the configuration's own ratio on each axis, rounded to
    whole pixels."""
    (hin, win), (hout, wout) = cfg["in_size"], cfg["out_size"]
    h, w = TINY_IN
    return (h, w), (round(h * hout / hin), round(w * wout / win))


def make_tiny(dst: pathlib.Path, src: pathlib.Path = ROOT) -> pathlib.Path:
    """A copy of ``BENCHMARK.json`` and ``fsrbench/`` of the tree ``src``
    under ``dst``, with each configuration cut to its ``tiny_sizes`` and at
    most ``TINY_BATCH`` frames a call."""
    shutil.copytree(src / "fsrbench", dst / "fsrbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache", "tests"))
    shutil.copy(src / "BENCHMARK.json", dst / "BENCHMARK.json")
    for f in (dst / "fsrbench" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg["in_size"], cfg["out_size"] = tiny_sizes(cfg)
        f.write_text(json.dumps(cfg))
    for f in (dst / "fsrbench" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t["batch"] = min(t["batch"], TINY_BATCH)
        t["trace_calls"] = 2
        f.write_text(json.dumps(t))
    return dst


@pytest.fixture
def tiny_tree(tmp_path):
    return make_tiny(tmp_path)


def run_cell(root, cell: str, seed: int = 2**31 + 11, seconds: float = 0.3, capsys=None):
    """``harness.main`` on the CPU for ``cell`` of the tree ``root``: (exit
    code, the result line's object or None).  The test process has the JAX
    package loaded (the reference's test compares with its oracle), so the
    run's look for it is off here; ``test_fsrbench_imports`` checks what a
    run loads, in a process of its own."""
    import torch

    from fsrbench import harness

    bench = json.loads((pathlib.Path(root) / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}[cell]
    forbidden, harness.FORBIDDEN = harness.FORBIDDEN, ()
    try:
        rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds)], root=root,
                          devices=[torch.device("cpu")] * chips)
    finally:
        harness.FORBIDDEN = forbidden
    out = capsys.readouterr().out.strip().splitlines() if capsys is not None else []
    return rc, (json.loads(out[-1]) if out else None)
