"""Each configuration's floor against a hand computation from its shapes,
and the readers that divide by the device's busy time."""

import json
import pathlib
import types

import pytest

from fsrbench import devtrace, roofline
from fsrbench.metrics import device_idle_pct, device_ops_per_frame, upscale_roofline

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"


def _cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.mark.parametrize("name, src_bytes", [("fsr1-perf2x-4k-u8", 1080 * 1920 * 3),
                                             ("fsr1-quality1.5x-4k-u8", 1440 * 2560 * 3)])
def test_floor_by_hand(name, src_bytes):
    cfg = _cfg(name)
    out_px = 2160 * 3840
    assert roofline.frame_bytes(cfg) == src_bytes + out_px * 3
    by_ops = 488.75 * out_px / 67e12        # EASU + RCAS float32 operations per pixel
    by_bytes = (src_bytes + out_px * 3) / 3.35e12
    floor, bound = roofline.floor_s_per_frame(cfg)
    assert by_ops > by_bytes and bound == "operations"
    assert floor == pytest.approx(by_ops, rel=1e-12)
    assert floor == pytest.approx(6.0506e-5, rel=1e-4)
    # The float every reading of these configurations has divided by since
    # the benchmark began, to the bit.
    assert floor == 6.050579104477612e-05


def test_mixed_floor_by_hand():
    """K6's function, 74.75 float32 and 541 float16 operations a pixel (the
    halves at twice the rate), 1080p to 4K in bytes: bound by operations."""
    cfg = dict(_cfg("fsr1-perf2x-4k-u8"), compute_dtype="float16",
               floor={"ops_per_output_pixel": {"float32": 74.75, "float16": 541}})
    out_px = 2160 * 3840
    by_ops = (74.75 / 67e12 + 541 / 134e12) * out_px
    by_bytes = (1080 * 1920 * 3 + out_px * 3) / 3.35e12
    floor, bound = roofline.floor_s_per_frame(cfg)
    assert by_ops > by_bytes and bound == "operations"
    assert floor == pytest.approx(by_ops, rel=1e-12)
    assert floor == pytest.approx(4.27e-5, rel=1e-3)


def _reading(ops, frames, start=0.0, end=1.0):
    return devtrace.Reading(ops=ops, spans=[("issue", 0.0, 0.1), ("wait", 0.1, 1.0)], start=start, end=end,
                            frames=frames, attempts=1)


def test_roofline_is_floor_over_busy_time_summed_over_cards():
    ops = [("k", 0, 0.0, 0.5), ("k", 0, 0.4, 0.6), ("k", 1, 0.0, 0.3)]  # card 0 busy 0.6, card 1 0.3
    run = types.SimpleNamespace(trace=_reading(ops, frames=1000), floor_s=1e-4)
    assert upscale_roofline.read(run) == pytest.approx(100 * 1e-4 * 1000 / 0.9)
    assert device_ops_per_frame.read(run) == pytest.approx(3 / 1000)
    assert device_idle_pct.read(run) == pytest.approx(100 * ((1 - 0.6) + (1 - 0.3)) / 2)


def test_readers_say_nothing_without_a_trace():
    run = types.SimpleNamespace(trace=None, floor_s=1e-4)
    assert upscale_roofline.read(run) is None
    assert device_ops_per_frame.read(run) is None
    assert device_idle_pct.read(run) is None


def test_busy_time_clips_to_the_window_and_gaps_take_the_host_span():
    r = _reading([("k", 0, -0.5, 0.05), ("k", 0, 0.2, 0.3)], frames=2)
    assert devtrace.busy_time([(s, e) for _, _, s, e in r.ops], r.start, r.end) == pytest.approx(0.15)
    gaps = sorted(devtrace.gaps(r), key=lambda g: -g[2])
    assert gaps[0][0] == "wait" and gaps[0][2] == pytest.approx(0.7)
    assert gaps[1][0] == "wait" and gaps[1][2] == pytest.approx(0.15)
    b = devtrace.breakdown(r, cards=1)
    assert b["device_ops"] == [["k", pytest.approx(0.65)]]
    assert [g[0] for g in b["idle_gaps"]] == ["wait", "wait"]
