"""``fsr_tpu_torch.utils.profiling.busy_time``: the device-busy arithmetic
of ``device_trace`` on synthetic intervals (CPU, exact)."""

import pytest

from fsr_tpu_torch.utils.profiling import busy_time

CASES = [
    # id, intervals, window (start, end), busy
    ("empty", [], (0.0, 10.0), 0.0),
    ("disjoint", [(1.0, 2.0), (4.0, 7.0)], (0.0, 10.0), 4.0),
    ("overlapping and unsorted", [(5.0, 8.0), (1.0, 3.0), (2.0, 6.0)], (0.0, 10.0), 7.0),
    ("nested", [(1.0, 9.0), (2.0, 3.0), (4.0, 5.0)], (0.0, 10.0), 8.0),
    ("touching", [(1.0, 2.0), (2.0, 3.0)], (0.0, 10.0), 2.0),
    # A device operation that began before the host-side window start
    # counts only from the start: busy never exceeds the window.
    ("straddles the start", [(-3.0, 2.0), (4.0, 10.0)], (0.0, 10.0), 8.0),
    ("straddles the start, fills the window", [(-5.0, 6.0), (5.0, 10.0)], (0.0, 10.0), 10.0),
    ("wholly before the start", [(-5.0, -1.0), (1.0, 2.0)], (0.0, 10.0), 1.0),
    ("past the end", [(8.0, 12.0)], (0.0, 10.0), 2.0),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_busy_time_clips_to_the_window(case):
    _, intervals, (start, end), want = case
    got = busy_time(intervals, start, end)
    assert got == pytest.approx(want, abs=1e-12)
    assert 0.0 <= got <= end - start
