"""The control fails the comparison, and the program passes it: the
reference computed in bfloat16 put in the program's place, and the
program's own float16 path, each read against the configuration's limit on
the same kept sources.  On the CPU at a tiny size; on a card at the cell's
own size (``card``)."""

import pathlib

import pytest
import torch

from fsrbench import control
from fsrbench.conftest import ROOT, need_card

CELLS = [("perf2x-u8.video-b16", 1), ("quality1.5x-u8.video-b16", 1), ("perf2x-u8.frame-b1", 1)]


def _assert_separates(r, cfg_limit):
    assert r["program"]["frames"] > 0 and r["program"]["worst_frame_off_share"] <= cfg_limit
    assert r["control"]["worst_frame_off_share"] > cfg_limit
    if "program_float16" in r:
        assert r["program_float16"]["worst_frame_off_share"] > cfg_limit


def _limit(root, cell):
    from fsrbench import harness

    _, _, cfg, _ = harness.load_cell(pathlib.Path(root), pathlib.Path(root) / "fsrbench", cell)
    return cfg["check"]["worst_frame_off_share"]


@pytest.mark.parametrize("cell, chips", CELLS + [("perf2x-u8.rows4-b16", 4)])
def test_control_fails_at_a_tiny_size(cell, chips, tiny_tree):
    r = control.readings(cell, 2**31 + 3, 0.2, pathlib.Path(tiny_tree), devices=[torch.device("cpu")] * chips)
    _assert_separates(r, _limit(tiny_tree, cell))


@pytest.mark.card
@pytest.mark.parametrize("cell, chips", CELLS)
def test_control_fails_on_the_card(cell, chips):
    need_card(chips)
    for seed in (4000000001, 4000000002, 4000000003):
        _assert_separates(control.readings(cell, seed, 1.0, ROOT), _limit(ROOT, cell))
