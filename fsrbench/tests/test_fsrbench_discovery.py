"""A configuration, a traffic mix, a reference, a cell and a per-layer
metric added as files and entries only are found by name, and no file that
was there changes."""

import hashlib
import json
import pathlib
import shutil
import sys

import pytest
import torch

import fsrbench.reference
from fsrbench import control, roofline
from fsrbench.conftest import BENCH, ROOT, make_tiny, run_cell, tiny_sizes


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


THROWAWAY_REFERENCE = '''"""A throwaway reference: the float32 reference's steps, each rounded to
the configuration's compute type."""

import torch

from fsrbench.reference import fsr1


def expected(inputs, cfg, dtype=None):
    return fsr1.expected(inputs, cfg, dtype or getattr(torch, cfg["compute_dtype"]))
'''


def test_a_float16_configuration_added_before_the_tiny_copy_is_found(tmp_path, monkeypatch, capsys):
    """A float16 configuration with a floor of mixed precision, its own
    reference module, a traffic mix and a cell, added as files and manifest
    entries to a copy of the tree before its tiny copy is made: the tiny copy
    sizes the configuration by the rule, a run takes the cell whole, and the
    control's second witness is the program in float32.  The configuration's
    limits are loose: this test is of discovery, not of fidelity (the
    throwaway reference rounds every step to float16, where the program
    computes FsrEasuH's mixed precision, and on the CPU at this size 13% of
    their bytes lie one or two codes apart)."""
    src = tmp_path / "tree"
    shutil.copytree(BENCH, src / "fsrbench", ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(ROOT / "BENCHMARK.json", src / "BENCHMARK.json")
    before = _digests(src)
    bench = json.loads((src / "BENCHMARK.json").read_text())

    cfg = json.loads((src / "fsrbench/configs/fsr1-perf2x-4k-u8.json").read_text())
    cfg.update(name="throwaway-perf2x-u8-f16", compute_dtype="float16", reference="throwaway_f16",
               floor={"ops_per_output_pixel": {"float32": 74.75, "float16": 541}, "why": "a test"},
               check={"worst_frame_off_share": 0.3, "max_code_off": 16})
    (src / "fsrbench/configs/throwaway-perf2x-u8-f16.json").write_text(json.dumps(cfg))
    (src / "fsrbench/reference/throwaway_f16.py").write_text(THROWAWAY_REFERENCE)
    traffic = {"entry": "upscale", "batch": 2, "ring": 3, "in_flight": 2, "keep_calls": 2, "trace_calls": 2,
               "why": "a throwaway mix"}
    (src / "fsrbench/traffic/throwaway-f16-b2.json").write_text(json.dumps(traffic))
    bench["configs"].append({"name": cfg["name"], "source": "https://example.org/throwaway",
                             "file": "fsrbench/configs/throwaway-perf2x-u8-f16.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "throwaway-f16.b2", "config": cfg["name"], "traffic": "throwaway-f16-b2",
                               "chips": 1, "why": "a test"})
    next(m for m in bench["end_to_end"] if m["name"] == "frames_per_s")["workloads"].append("throwaway-f16.b2")
    (src / "BENCHMARK.json").write_text(json.dumps(bench))

    tiny = make_tiny(tmp_path / "tiny", src=src)
    small = json.loads((tiny / "fsrbench/configs/throwaway-perf2x-u8-f16.json").read_text())
    assert (small["in_size"], small["out_size"]) == ([32, 48], [64, 96])
    assert roofline.floor_s_per_frame(small) == pytest.approx(((74.75 / 67e12 + 541 / 134e12) * 64 * 96,
                                                               "operations"), rel=1e-12)

    # The tree's reference modules are found by name, as a run from a
    # checkout of that tree finds them.
    monkeypatch.setattr(fsrbench.reference, "__path__",
                        [*fsrbench.reference.__path__, str(tiny / "fsrbench" / "reference")])
    try:
        rc, line = run_cell(tiny, "throwaway-f16.b2", capsys=capsys)
        r = control.readings("throwaway-f16.b2", 2**31 + 5, 0.2, tiny, devices=[torch.device("cpu")])
    finally:
        sys.modules.pop("fsrbench.reference.throwaway_f16", None)
    assert rc == 0 and line["correct"] is True, line
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
    assert "program_float32" in r and "program_float16" not in r
    assert r["program_float32"]["frames"] == r["program"]["frames"] > 0
    after = _digests(src)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("in_size, tiny_out", [((1080, 1920), (64, 96)), ((1440, 2560), (48, 72)),
                                               ((1661, 2953), (42, 62)), ((1270, 2258), (54, 82))],
                         ids=["performance-2x", "quality-1.5x", "ultra-quality-1.3x", "balanced-1.7x"])
def test_tiny_sizes_keep_each_configurations_ratio(in_size, tiny_out):
    """The tiny copy's output is the configuration's ratio of a 32 x 48
    source, in whole pixels: today's sizes at 2x and 1.5x."""
    (tin, tout) = tiny_sizes({"in_size": in_size, "out_size": (2160, 3840)})
    assert tin == (32, 48) and tout == tiny_out and all(isinstance(v, int) for v in tout)


def _manifest_metrics():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]


@pytest.mark.parametrize("metric", _manifest_metrics())
def test_every_metric_of_the_manifest_has_a_reader(metric):
    from fsrbench import harness

    assert callable(harness.reader(BENCH, metric))
