"""The port's spans and counters (``fsr_tpu_torch/utils/profiling.py``) on
the CPU: off by default (the shared no-op, nothing recorded), on in a
profiler's active step only and in ``recording()``, parent links, call ids
and self time, the ``plans_built`` count of an ``upscale`` call, the span
names against the benchmark harness's own, and the benchmark's readers of
them (``fsrbench/metrics/``) on hand-built records."""

import importlib.util
import re
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

import fsr_tpu_torch
from fsr_tpu_torch.kernels import fused
from fsr_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]


def _load(rel: str):
    spec = importlib.util.spec_from_file_location("tracing_" + Path(rel).stem.replace(".", "_"), ROOT / rel)
    mod = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _newest() -> int:
    spans = profiling.records()
    return spans[-1].id if spans else -1


def _since(newest: int) -> profiling.Records:
    return profiling.Records(s for s in profiling.records() if s.id > newest)


def _frame(seed=0, shape=(3, 13, 17)):
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed))


def test_off_records_nothing_and_returns_the_shared_noop():
    assert not profiling._forced and not torch.autograd.profiler._is_profiler_enabled
    spans = [profiling.trace_annotation("fsr.api"), profiling.trace_annotation("fsr.launch", "kernel", "K1")]
    assert all(s is spans[0] for s in spans)
    newest = _newest()
    with spans[0] as entered:
        profiling.count("plans_built")
    assert entered == ()
    with pytest.raises(KeyError):  # an exception passes through the no-op
        with spans[1]:
            raise KeyError("inside")
    fsr_tpu_torch.upscale(_frame(), scale=2.0, impl="kernel")
    assert _newest() == newest


def test_profiler_records_only_its_active_step():
    """Under a profiler with one warm-up and one active step, the buffer
    holds the active step's call alone, and the profiler's trace holds the
    same spans by name."""
    traced = []
    newest = _newest()
    with profile(activities=[ProfilerActivity.CPU], schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: traced.append(p.events())) as prof:
        for _ in range(2):
            fsr_tpu_torch.upscale(_frame(1), scale=2.0, impl="kernel")
            prof.step()
    got = _since(newest)
    assert [s.name for s in got] == ["fsr.dispatch", "fsr.api"]
    assert len({s.call for s in got}) == 1
    names = [e.name for e in traced[0] if e.name.startswith("fsr.")]
    assert sorted(names) == sorted(s.name for s in got)


def test_nested_spans_parents_calls_and_self_time():
    with profiling.recording() as rec:
        with profiling.trace_annotation("fsr.api") as api:
            with profiling.trace_annotation("fsr.dispatch") as outer:
                profiling.count("plans_built", 2)
                with profiling.trace_annotation("fsr.launch", "kernel", "K1") as launch:
                    profiling.count("plans_built")
            with pytest.raises(ValueError):
                with profiling.trace_annotation("fsr.dispatch"):
                    raise ValueError("inside a recorded span")
        with profiling.trace_annotation("fsr.spatial", leads=True) as lead:
            pass
        with profiling.trace_annotation("fsr.spatial") as joined:
            with profiling.trace_annotation("fsr.replay", "card", 0) as replay:
                pass
        with profiling.trace_annotation("fsr.api") as other:
            pass
    assert [s.name for s in rec] == ["fsr.launch", "fsr.dispatch", "fsr.dispatch", "fsr.api", "fsr.spatial",
                                     "fsr.replay", "fsr.spatial", "fsr.api"]
    failed = rec[2]
    assert (api.parent, outer.parent, launch.parent, failed.parent) == (None, api.id, outer.id, api.id)
    assert api.call == outer.call == launch.call == failed.call
    assert lead.call == joined.call == replay.call != api.call
    assert len({api.call, lead.call, other.call}) == 3
    assert launch.args == {"kernel": "K1", "plans_built": 1} and outer.args == {"plans_built": 2}
    assert rec.self_times("fsr.api")[api.call] == pytest.approx(api.seconds - outer.seconds - failed.seconds)
    assert rec.self_times("fsr.dispatch")[api.call] == pytest.approx(
        outer.seconds - launch.seconds + failed.seconds)
    assert rec.self_times("fsr.spatial")[lead.call] == pytest.approx(
        lead.seconds + joined.seconds - replay.seconds)
    assert rec.counts("plans_built") == {api.call: 3}
    assert rec.launches() == {"K1": 1}
    assert not profiling._per_thread.stack and not profiling._forced


def test_set_up_spans_record_while_off():
    newest = _newest()
    with profiling.trace_annotation("fsr.capture", "cards", 4, always=True) as span:
        profiling.count("plans_built")  # counts stay off with the spans
    assert _since(newest) == [span] and span.args == {"cards": 4}


def test_plans_built_on_two_identical_kernel_calls():
    """The constants (on ``fsr.api``) and K1's plan (on ``fsr.dispatch``)
    are built per call; the phase structure once, on the first call's
    kernel choice (a cache miss)."""
    x = _frame(2, (3, 11, 19))
    fused._phase_structure.cache_clear()
    with profiling.recording() as rec:
        for _ in range(2):
            fsr_tpu_torch.upscale(x, scale=2.0, impl="kernel")
    calls = sorted(rec.self_times("fsr.api"))
    built = rec.counts("plans_built")
    assert [built[c] for c in calls] == [4, 3]
    assert [s.args.get("plans_built") for s in rec.named("fsr.api")] == [2, 2]
    assert not rec.launches()


def test_span_names_are_the_programs_and_not_the_harness():
    """Every span the package opens is one of ``SPANS``, each "fsr."; none
    is a span or the window of the benchmark's harness, which its trace
    reader keys on."""
    drive, devtrace = _load("fsrbench/drive.py"), _load("fsrbench/devtrace.py")
    opened = set()
    for path in (ROOT / "fsr_tpu_torch").rglob("*.py"):
        opened |= set(re.findall(r'trace_annotation\(\s*"([^"]+)"', path.read_text()))
    assert opened == set(profiling.SPANS)
    assert all(name.startswith("fsr.") for name in profiling.SPANS)
    assert not set(profiling.SPANS) & (set(drive.SPANS) | {devtrace.WINDOW})


# --- the benchmark's readers of the spans --------------------------------------


def _span(name, start, end, call, parent=None, ident=None, **args):
    s = profiling.Span(name, None, None, False)
    s.start, s.end, s.call, s.parent, s.args = start * 1e-6, end * 1e-6, call, parent, args
    s.id = ident if ident is not None else (call, name, start)
    return s


def _frame_call(call, t0, slow):
    """One ``upscale`` call's spans, times in us from t0: api 10 + slow,
    dispatch 5 (supported 1, upscale_fused 3 + slow, its supported 1),
    launch 2."""
    api = (call, "api")
    return [
        _span("fsr.dispatch", t0 + 1, t0 + 2, call, api, (call, "s1")),
        _span("fsr.dispatch", t0 + 4, t0 + 5, call, (call, "uf"), (call, "s2"), plans_built=1),
        _span("fsr.launch", t0 + 6, t0 + 8, call, (call, "uf"), (call, "l"), kernel="K1"),
        _span("fsr.dispatch", t0 + 3, t0 + 9 + slow, call, api, (call, "uf"), plans_built=2),
        _span("fsr.api", t0, t0 + 10 + slow, call, None, api, plans_built=2),
    ]


def _rows_call(call, t0):
    """A ``writable()`` (1 us) and the call after it (9 us): 4 stage steps
    of 0.5 us, 4 replays of 1 us."""
    root = (call, "call")
    spans = [_span("fsr.spatial", t0, t0 + 1, call, None, (call, "w"))]
    for k in range(4):
        spans.append(_span("fsr.spatial", t0 + 2 + 0.5 * k, t0 + 2.5 + 0.5 * k, call, root, (call, "st", k), card=k))
    for k in range(4):
        spans.append(_span("fsr.replay", t0 + 5 + k, t0 + 6 + k, call, root, (call, "r", k), card=k))
    spans.append(_span("fsr.spatial", t0 + 1.5, t0 + 10.5, call, None, root))
    return spans


SETUP = [_span("fsr.library", 0, 2.5e6, 100, built=1), _span("fsr.capture", 3e6, 8e6, 101, cards=4)]
FRAME = SETUP[:1] + [s for c, slow in enumerate((0, 4, 1)) for s in _frame_call(c, 20 * c, slow)]
ROWS = SETUP + [s for c in range(3) for s in _rows_call(10 + c, 20 * c)]

# metric, the records it reads, its value (from the spans above)
METRICS = [
    ("span_self_ms.api", FRAME, 3e-3),
    ("span_self_ms.dispatch", FRAME, 5e-3 + 1e-3),
    ("span_self_ms.launch", FRAME, 2e-3),
    ("plans_built_per_call.latency", FRAME, 5.0),
    ("span_self_ms.spatial.rows4", ROWS, 1e-3 + 9e-3 - 2e-3 - 4e-3 + 2e-3),
    ("span_self_ms.replay.rows4", ROWS, 4e-3),
    ("setup_span_s.library", FRAME, 2.5),
    ("setup_span_s.capture", ROWS, 5.0),
]


@pytest.mark.parametrize("metric, spans, want", METRICS, ids=[m[0] for m in METRICS])
@pytest.mark.parametrize("present", [True, False], ids=["recorded", "absent"])
def test_metric_reads_the_spans(metric, spans, want, present, monkeypatch):
    read = _load(f"fsrbench/metrics/{metric}.py").read
    monkeypatch.setattr(profiling, "records", lambda: profiling.Records(spans if present else []))
    got = read(None)
    if present:
        assert got == pytest.approx(want)
    else:
        assert got is None
