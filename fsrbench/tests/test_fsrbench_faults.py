"""A run whose timed path is broken underneath comes out not correct, once
for each fault a cell can have; the same run unbroken comes out correct.
The runs skip the look for a card and run at a tiny size on the CPU."""

import pytest
import torch

import fsr_tpu_torch
from fsr_tpu_torch.kernels import halo
from fsr_tpu_torch.parallel import sharding, spatial
from fsrbench.conftest import run_cell

UPSCALE_CELLS = ["perf2x-u8.video-b16", "quality1.5x-u8.video-b16", "perf2x-u8.frame-b1"]
ROWS = "perf2x-u8.rows4-b16"
EDGE_ROWS = 4


def _stale_upscale(monkeypatch):
    """Each call returns the output of the call before it (the first, zeros)."""
    real, last = fsr_tpu_torch.upscale, []

    def upscale(x, **kw):
        out = real(x, **kw)
        prev = last[0] if last else torch.zeros_like(out)
        last[:] = [out]
        return prev
    monkeypatch.setattr(fsr_tpu_torch, "upscale", upscale)


def _half_batch(monkeypatch):
    """Only the first half of the batch is computed; the rest repeats it."""
    real = fsr_tpu_torch.upscale

    def upscale(x, **kw):
        half = real(x[: (x.shape[0] + 1) // 2], **kw)
        return torch.cat([half, half])[: x.shape[0]]
    monkeypatch.setattr(fsr_tpu_torch, "upscale", upscale)


def _altered_answer(monkeypatch):
    """The first frame of each call altered where it is produced: its codes'
    last bit flipped."""
    real = fsr_tpu_torch.upscale

    def upscale(x, **kw):
        out = real(x, **kw)
        out[0] ^= 1
        return out
    monkeypatch.setattr(fsr_tpu_torch, "upscale", upscale)


def _edge_pixels(monkeypatch):
    """A few pixels at the right edge of each call's first frame altered
    where they are produced, as a wrong edge rule would: too few bytes for
    the share of a frame off the reference, so only the largest difference
    of one byte catches it."""
    real = fsr_tpu_torch.upscale

    def upscale(x, **kw):
        out = real(x, **kw)
        out[0, 0, :EDGE_ROWS, -1] ^= 0x80
        return out
    monkeypatch.setattr(fsr_tpu_torch, "upscale", upscale)


def _stale_replay(monkeypatch):
    """Each card's program returns the outputs of its first run, whatever
    it is given: its state unchanged."""
    real, first = sharding._PerDevice.run_on, {}

    def run_on(self, device):
        return first.setdefault((id(self), device), real(self, device))
    monkeypatch.setattr(sharding._PerDevice, "run_on", run_on)


def _no_exchange(monkeypatch):
    """Each strip read without its neighbours' rows: the exchange between
    cards left out (the frame's edge rule at every strip's edge)."""
    class Alone(halo.StripSource):
        def __init__(self, up, own, down, halo_rows):
            super().__init__(None, own, None, halo_rows)
    monkeypatch.setattr(halo, "StripSource", Alone)


def _altered_strip(monkeypatch):
    """The last strip's output altered where it is produced."""
    real = spatial.CapturedSpatial.__call__

    def call(self, image, frame=0, grain=None):
        out = real(self, image, frame=frame, grain=grain)
        out.shards[-1][0] ^= 1
        return out
    monkeypatch.setattr(spatial.CapturedSpatial, "__call__", call)


FAULTS = [(cell, f) for cell in UPSCALE_CELLS for f in (_stale_upscale, _altered_answer)]
FAULTS += [(c, _half_batch) for c in UPSCALE_CELLS if c != "perf2x-u8.frame-b1"]  # batch 1 has no half
FAULTS += [(ROWS, f) for f in (_stale_replay, _no_exchange, _altered_strip)]


@pytest.mark.parametrize("cell, fault", FAULTS, ids=[f"{c}-{f.__name__.strip('_')}" for c, f in FAULTS])
def test_fault_is_not_correct(cell, fault, tiny_tree, monkeypatch, capsys):
    fault(monkeypatch)
    rc, line = run_cell(tiny_tree, cell, capsys=capsys)
    assert rc == 0 and line["correct"] is False, (line, capsys.readouterr().err[-1500:])


@pytest.mark.parametrize("cell", UPSCALE_CELLS)
def test_a_fault_at_one_edge_is_caught_by_the_largest_code_difference(cell, tiny_tree, monkeypatch, capsys):
    _edge_pixels(monkeypatch)
    rc, line = run_cell(tiny_tree, cell, capsys=capsys)
    compared = line["compared"]
    assert rc == 0 and line["correct"] is False
    assert compared["worst_frame_off_share"]["value"] <= compared["worst_frame_off_share"]["limit"]
    assert compared["max_code_off"]["value"] > compared["max_code_off"]["limit"]


@pytest.mark.parametrize("cell", UPSCALE_CELLS + [ROWS])
def test_sound_run_is_correct(cell, tiny_tree, capsys):
    rc, line = run_cell(tiny_tree, cell, capsys=capsys)
    assert rc == 0 and line["correct"] is True
