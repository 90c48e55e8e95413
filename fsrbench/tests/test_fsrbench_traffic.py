"""Each cell's control flow, run whole at a tiny size on the CPU: set-up,
the window, the kept frames against the reference, the result line."""

import json
import pathlib

import pytest

from fsrbench.conftest import ROOT, run_cell

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_cpu_at_a_tiny_size(cell, tiny_tree, capsys):
    rc, line = run_cell(tiny_tree, cell, capsys=capsys)
    assert rc == 0
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == want
    assert list(line)[-1] == "compared"
    assert all(v["value"] <= v["limit"] for v in line["compared"].values())


def test_seed_makes_the_frames(tiny_tree):
    import torch

    from fsrbench import drive, harness

    _, _, cfg, traffic = harness.load_cell(pathlib.Path(tiny_tree), pathlib.Path(tiny_tree) / "fsrbench",
                                           "perf2x-u8.video-b16")
    cpu = [torch.device("cpu")]
    big = 2**33 + 5  # seeds beyond 32 signed bits
    a, b, c = (drive.make_entry(cfg, traffic, s, cpu).ring for s in (big, big, big + 1))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert len({bytes(x.numpy()) for x in a}) == traffic["ring"]  # distinct batches
