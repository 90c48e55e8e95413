"""K6's counts (``kernels/easu_h.counts``): the texel responses, output
pixels and ring pixels a launch of ``csrc/easu_h.cu`` evaluates, held on the
CPU against a count block by block from K2's tables (``easu_gather.plan``,
``shard_plan``) and K6's ``TILE`` as the kernel's ``stage`` and tile loops
read them; the benchmark's readers of the counts; on a card (``card``), the
counts on one recorded K6 launch, bare and with the frame tail.  This file
imports no JAX, so the card tests run where the JAX package is absent."""

import importlib.util
import sys
from pathlib import Path

import pytest
import torch

from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import easu_gather, easu_h
from fsr_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
PERF_4K = ((1080, 1920), (2160, 3840))
QUALITY_4K = ((1440, 2560), (2160, 3840))


def _con(in_hw, out_hw):
    return EasuConstants.create((in_hw[1], in_hw[0]), (in_hw[1], in_hw[0]), (out_hw[1], out_hw[0]))


def _by_block(gplan, apply_rcas):
    """The counts block by block, as ``csrc/easu_h.cu`` reads the tables:
    a block at (y0, x0) stages rows from ``rows[0]`` of output row y0 - 1
    to ``rows[3]`` of row min(y0 + TH, hout), columns from ``cols[0]`` of
    max(x0 - 1, 0) to ``cols[3]`` of min(x0 + TW, wout - 1), and evaluates
    a response per centre of that footprint and a texel of margin; with
    RCAS its (TH + 2) x (TW + 2) ring's EASU, else each pair of its tile
    whose first pixel lies inside the output."""
    rows, cols = gplan.rows, gplan.cols  # the row tables start at output row -1
    hout, wout = rows.shape[1] - 2, cols.shape[1]
    th, tw = easu_h.TILE
    responses = easu_px = 0
    for y0 in range(0, hout, th):
        fh = int(rows[3][min(y0 + th, hout) + 1]) - int(rows[0][y0]) + 1
        for x0 in range(0, wout, tw):
            fw = int(cols[3][min(x0 + tw, wout - 1)]) - int(cols[0][max(x0 - 1, 0)]) + 1
            responses += (fh + 2) * (fw + 2)
            if apply_rcas:
                easu_px += (th + 2) * (tw + 2)
            else:
                pairs = sum(1 for ly in range(th) for m in range(tw // 2) if y0 + ly < hout and x0 + 2 * m < wout)
                easu_px += 2 * pairs
    return responses, hout * wout, easu_px


@pytest.mark.parametrize("in_hw, out_hw", [PERF_4K, QUALITY_4K, ((27, 41), (50, 77)), ((32, 48), (48, 72)),
                                           ((37, 53), (64, 123))],
                         ids=["performance-2x-4k", "quality-1.5x-4k", "odd", "tiny-1.5x", "drs-like"])
@pytest.mark.parametrize("apply_rcas", [True, False], ids=["rcas", "easu-only"])
def test_counts_equal_the_block_by_block_count(in_hw, out_hw, apply_rcas):
    gplan = easu_gather.plan(in_hw, out_hw, _con(in_hw, out_hw))
    assert easu_h.counts(gplan, apply_rcas) == _by_block(gplan, apply_rcas)


@pytest.mark.parametrize("n", [2, 4])
def test_a_strips_counts_equal_the_block_by_block_count(n):
    """A row strip's plan (``shard_plan``, its rows -1 .. hl) counts the
    strip's blocks: over the strips, every output pixel once."""
    in_hw, out_hw = (64, 96), (128, 192)
    con = _con(in_hw, out_hw)
    pixels = 0
    for k in range(n):
        gplan = easu_gather.shard_plan(in_hw, out_hw, con, n, k, 4)
        got = easu_h.counts(gplan, True)
        assert got == _by_block(gplan, True)
        pixels += got[1]
    assert pixels == out_hw[0] * out_hw[1]


def test_performance_4k_evaluates_1138_ring_pixels_and_049_responses_per_pixel():
    """1080p -> 4K: 128 x 72 blocks of a 32 x 32 ring for 30 x 30 pixels,
    9,216 x 1,024 / 8,294,400 = 1.1378 EASU evaluations per output pixel;
    each block's footprint 19 x 19 texels at most, a 21 x 21 grid of
    responses, 0.488 per pixel.  Quality 1.5x: 0.749 per pixel, the same
    ring."""
    responses, pixels, easu_px = easu_h.counts(easu_gather.plan(*PERF_4K, _con(*PERF_4K)), True)
    assert pixels == 3840 * 2160 and easu_px == 9216 * 1024
    assert easu_px / pixels == pytest.approx(1.1378, abs=1e-4)
    assert responses / pixels == pytest.approx(0.488, abs=1e-3)
    q_responses, q_pixels, q_easu = easu_h.counts(easu_gather.plan(*QUALITY_4K, _con(*QUALITY_4K)), True)
    assert q_responses / q_pixels == pytest.approx(0.749, abs=1e-3) and q_easu == easu_px


def test_a_cpu_call_counts_nothing():
    """On the CPU K6 runs its plain version: no launch, no count."""
    x = torch.randint(0, 256, (3, 24, 40), dtype=torch.uint8, generator=torch.Generator().manual_seed(3))
    with profiling.recording() as rec:
        easu_h.easu_h(x, (48, 80), _con((24, 40), (48, 80)), RcasConstants(0.25), True, out_dtype=torch.uint8)
    assert not rec.named("fsr.launch")
    for key in ("texel_responses", "pixels", "easu_pixels"):
        assert rec.counts(key) == {}


def _metric(name):
    path = ROOT / "fsrbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name.replace('.', '_')}", path)
    mod = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _launch(call, **args):
    s = profiling.Span("fsr.launch", None, None, False)
    s.start, s.end, s.call, s.parent, s.id, s.args = 0.0, 1e-6, call, None, call, args
    return s


COUNTED = [_launch(0, kernel="K2", texel_responses=5, pixels=10, easu_pixels=99),
           _launch(1, kernel="K6", texel_responses=488, pixels=1000, easu_pixels=1138),
           _launch(2, kernel="K6", texel_responses=976, pixels=2000, easu_pixels=2276), _launch(3, kernel="K6")]


@pytest.mark.parametrize("metric, want", [("texel_responses_per_pixel.f16", 0.488),
                                          ("easu_pixels_per_pixel.f16", 1.138)])
@pytest.mark.parametrize("spans", [[], [_launch(0, kernel="K1"), _launch(1, kernel="K2", texel_responses=5, pixels=9)],
                                   [_launch(0, kernel="K6")], COUNTED],
                         ids=["nothing", "K1 and K2 only", "K6 uncounted", "K6 counted"])
def test_metrics_read_k6s_counts_per_pixel(metric, want, spans, monkeypatch):
    """The two readers sum K6's counts over its launches that carry them,
    whatever K2 counts, and read None without one (the parent's program)."""
    read = _metric(metric)
    monkeypatch.setattr(profiling, "records", lambda: profiling.Records(spans))
    got = read(None)
    assert got == (pytest.approx(want) if spans is COUNTED else None)


@pytest.mark.card
@pytest.mark.parametrize("out_dtype", [None, torch.uint8], ids=["bare", "tail"])
def test_a_recorded_k6_launch_carries_its_counts(out_dtype):
    """One K6 launch on the card, bare (a float16 output) and with the frame
    tail (uint8 codes), records one ``fsr.launch`` span with its counts for
    the batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from fsr_tpu_torch.kernels import _build

    _build.library()
    dev = torch.device("cuda", 0)
    in_hw, out_hw = (90, 160), (180, 320)
    x = torch.randint(0, 256, (2, 3, *in_hw), dtype=torch.uint8, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(5))
    con = _con(in_hw, out_hw)
    with profiling.recording() as rec:
        out = easu_h.easu_h(x, out_hw, con, RcasConstants(0.25), True, out_dtype=out_dtype)
    torch.cuda.synchronize(dev)
    assert out.dtype == (out_dtype or torch.float16)
    (launch,) = rec.named("fsr.launch")
    responses, pixels, easu_px = easu_h.counts(easu_gather.plan(in_hw, out_hw, con), True)
    assert launch.args == {"kernel": "K6", "texel_responses": 2 * responses, "pixels": 2 * pixels,
                           "easu_pixels": 2 * easu_px}
