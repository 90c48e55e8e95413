"""What a cell's run imports: nothing whose top-level name is ``jax`` or
``fsr_tpu`` (``fsr_tpu_torch`` is the program), and the reference and the
comparison nothing of the program."""

import json
import subprocess
import sys

from fsrbench.conftest import ROOT

CELL_PATH = """
import sys, torch
sys.path.insert(0, {root!r})
from fsrbench import harness, drive, check, devtrace, roofline, control
from fsrbench.conftest import make_tiny
import pathlib, tempfile, json
tmp = pathlib.Path(tempfile.mkdtemp(dir={tmp!r}))
make_tiny(tmp)
for cell, chips in (("perf2x-u8.video-b16", 1), ("perf2x-u8.rows4-b16", 4)):
    _, _, cfg, traffic = harness.load_cell(tmp, tmp / "fsrbench", cell)
    entry = drive.make_entry(cfg, traffic, 5, [torch.device("cpu")] * chips)
    loop = drive.Loop(entry, traffic)
    calls = drive.Calls()
    loop.run(calls, n=2, keep_at={{1}})
    check.readings(entry.pairs(calls.kept), cfg, torch.device("cpu"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import sys, json
sys.path.insert(0, {root!r})
import fsrbench.reference.fsr1, fsrbench.check, fsrbench.roofline, fsrbench.devtrace
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str, tmp_path) -> set:
    res = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT), tmp=str(tmp_path))],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_a_cell_imports_no_jax(tmp_path):
    names = _top_level(CELL_PATH, tmp_path)
    assert "fsr_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "fsr_tpu"}


def test_the_reference_imports_nothing_of_the_program(tmp_path):
    names = _top_level(REFERENCE, tmp_path)
    assert not names & {"fsr_tpu_torch", "fsr_tpu", "jax", "jaxlib", "flax"}


PRELUDE = """
import runpy, sys
runpy.run_path({run!r}, run_name="prelude")
sys.path.insert(0, {root!r})
import fsrbench.roofline
print(sys.pycache_prefix, sys.dont_write_bytecode)
"""


def test_a_run_caches_bytecode_inside_its_checkout(tiny_tree):
    """``run.py`` keeps the bytecode of what a run imports under the
    checkout's ``fsrbench/_cache/pycache``, also where the environment
    forbids writing it beside the sources."""
    import os

    root = tiny_tree
    code = PRELUDE.format(run=str(root / "fsrbench" / "run.py"), root=str(root))
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=root, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    prefix, dont_write = res.stdout.split()
    assert prefix == str(root / "fsrbench" / "_cache" / "pycache") and dont_write == "False"
    assert list((root / "fsrbench" / "_cache" / "pycache").rglob("roofline.*.pyc"))
    assert not (root / "fsrbench" / "__pycache__").exists()
