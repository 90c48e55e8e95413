"""Run one benchmark cell: ``python3 fsrbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``, from the root of a checkout (see
``fsrbench/harness.py``)."""

import time

T_START = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# The bytecode of every module a run imports (torch's ~2,100 among them) is
# cached in the checkout, at a fixed path, and written even where the
# environment forbids writing it beside the sources (PYTHONDONTWRITEBYTECODE):
# without it every run compiles them all again, 8-11 s of its set-up.
PYCACHE = ROOT / "fsrbench" / "_cache" / "pycache"
sys.pycache_prefix = str(PYCACHE)
sys.dont_write_bytecode = False

if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    from fsrbench import harness

    sys.exit(harness.main(t_start=T_START))
