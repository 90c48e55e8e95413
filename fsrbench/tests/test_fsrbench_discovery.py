"""A configuration, a traffic mix, a cell and a per-layer metric added as
files and entries only are found by name, and no file that was there
changes."""

import hashlib
import json
import pathlib

import pytest

from fsrbench.conftest import BENCH, ROOT, run_cell


def _digests(root: pathlib.Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "fsrbench").rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_added_as_files_is_found(tiny_tree, capsys):
    root = pathlib.Path(tiny_tree)
    before = _digests(root)
    bench_path = root / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())

    cfg = json.loads((root / "fsrbench/configs/fsr1-perf2x-4k-u8.json").read_text())
    cfg.update(name="throwaway-1x-u8", preset="native", in_size=[40, 56], out_size=[40, 56])
    (root / "fsrbench/configs/throwaway-1x-u8.json").write_text(json.dumps(cfg))
    traffic = {"entry": "upscale", "batch": 2, "ring": 3, "in_flight": 3, "keep_calls": 2,
               "trace_calls": 2, "why": "a throwaway mix"}
    (root / "fsrbench/traffic/throwaway-b2.json").write_text(json.dumps(traffic))
    (root / "fsrbench/metrics/throwaway_calls.py").write_text("def read(run):\n    return float(run.calls.n)\n")
    bench["configs"].append({"name": "throwaway-1x-u8", "source": "https://example.org/throwaway",
                             "file": "fsrbench/configs/throwaway-1x-u8.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "throwaway.b2", "config": "throwaway-1x-u8", "traffic": "throwaway-b2",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("throwaway.b2")
    bench["end_to_end"].append({"name": "throwaway_calls", "unit": "calls", "better": "higher", "bound": 0.01,
                                "source": "host_clock", "workloads": ["throwaway.b2"]})
    bench_path.write_text(json.dumps(bench))

    rc, line = run_cell(root, "throwaway.b2", capsys=capsys)
    assert rc == 0 and line["correct"] is True
    assert set(line["metrics"]) == {"frames_per_s", "setup_s", "throwaway_calls"}
    assert line["metrics"]["throwaway_calls"]["value"] * 2 == line["attempted"]
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


def _manifest_metrics():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]


@pytest.mark.parametrize("metric", _manifest_metrics())
def test_every_metric_of_the_manifest_has_a_reader(metric):
    from fsrbench import harness

    assert callable(harness.reader(BENCH, metric))
