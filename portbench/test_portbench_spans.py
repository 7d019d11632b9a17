"""The readers of the program's spans (portbench/spans.py and the
`idle_*` metrics): their interval arithmetic on a synthetic trace and span
list, their silence where there is nothing to read, and a tiny traced job
on the CPU that records the spans they read.

    python -m pytest portbench/ -q
"""

from __future__ import annotations

import sys

import pytest

from hbird_tpu_torch.utils import profiling
from hbird_tpu_torch.utils.profiling import Span
from portbench import spans
from portbench.run import HERE, load_module
from portbench.trace import Activity, Trace


def _span(name, start, end, id_=0, parent=None):
    return Span(name, start, end, id_, parent, {})


def _trace():
    """Window [1000, 2000) ns; the device busy in [1100, 1300), [1250,
    1400) (overlapping streams) and [1600, 1700)."""
    acts = [Activity("k", 1100, 1300, 7, 1090), Activity("k", 1250, 1400, 8, 1240),
            Activity("copy", 1600, 1700, 7, 1590)]
    return Trace(window=(1000, 2000), activities=acts)


SPANS = [
    _span("hbird.eval.feed", 900, 1150),  # clipped to the window: idle 1000-1100
    _span("hbird.eval.step", 1150, 1350),
    _span("hbird.eval.consume", 1350, 1650, 3),  # idle 1400-1600
    _span("hbird.eval.consume.wait", 1350, 1450, 4, 3),  # inside its parent: counted once
    _span("hbird.eval.feed", 1650, 1800),  # idle 1700-1800
    _span("hbird.eval.step", 1800, 1900),  # idle 1800-1900
    _span("hbird.index.layout", 1950, 2100),  # idle 1950-2000
    _span("hbird.index.scatter", 1960, 1990),  # overlaps layout: its union once
    _span("hbird.phase.index_build", 1940, 1995),
]


@pytest.fixture
def recorded(monkeypatch):
    store = list(SPANS)
    monkeypatch.setattr(profiling, "recorded_spans", lambda: list(store))
    return store


def test_idle_under_spans_is_the_union_less_the_busy_part(recorded):
    t = _trace()
    assert spans.idle_ns(t, [(900, 1150)]) == 100
    assert spans.idle_ns(t, [(1350, 1650), (1350, 1450)]) == 200
    assert spans.idle_ns(t, [(1950, 2100), (1960, 1990)]) == 50
    assert spans.idle_ns(t, [(1100, 1400)]) == 0
    assert spans.idle_ns(t, []) == 0
    res = {"trace": t}
    assert spans.idle_per(res, ("hbird.eval.feed",), ("hbird.eval.step",), 1e-9) == pytest.approx((100 + 100) / 2)
    assert spans.idle_per(res, ("hbird.eval.consume",), ("hbird.eval.step",), 1e-9) == pytest.approx(200 / 2)
    assert spans.idle_per(res, ("hbird.index.",), ("hbird.phase.index_build",), 1e-9) == pytest.approx(50)


def test_the_readers_read_their_spans(recorded):
    res = {"trace": _trace()}

    def read(metric):
        return load_module(HERE / "metrics" / f"{metric}.py").read(res, None)

    assert read("idle_feed_ms.eval") == pytest.approx(100e-6)  # 200 ns over 2 steps, in ms
    assert read("idle_consume_ms.eval") == pytest.approx(100e-6)
    assert read("idle_feed_ms.job") == pytest.approx(100e-6)  # no memory steps here
    assert read("idle_index_s.job") == pytest.approx(50e-9)


@pytest.mark.parametrize("case", ["untraced", "no_activity", "no_spans", "older_program", "no_steps"])
def test_the_readers_are_silent_with_nothing_to_read(monkeypatch, recorded, case):
    t = _trace()
    if case == "untraced":
        t = None
    elif case == "no_activity":
        t.activities = []
    elif case == "no_spans":
        recorded.clear()
    elif case == "older_program":  # a checkout whose profiling module records no spans
        monkeypatch.setitem(sys.modules, "hbird_tpu_torch.utils.profiling", None)
    else:
        recorded[:] = [s for s in recorded if not s.name.endswith(".step") and "phase" not in s.name]
    for metric in ("idle_feed_ms.eval", "idle_consume_ms.eval", "idle_feed_ms.job", "idle_index_s.job"):
        assert load_module(HERE / "metrics" / f"{metric}.py").read({"trace": t}, None) is None


def test_idle_goes_to_the_innermost_open_span(recorded):
    t = _trace()
    by = spans.idle_by_span(t, spans.window_spans(t))
    # idle: [1000, 1100) feed; [1400, 1450) wait, [1450, 1600) consume; [1700, 1800) feed,
    # [1800, 1900) step, [1900, 1940) none, [1940, 1950) the phase, [1950, 1960) and
    # [1990, 2000) layout (opened after the phase, still open), [1960, 1990) scatter
    assert by == {"hbird.eval.feed": 200, "hbird.eval.step": 100, "hbird.eval.consume.wait": 50,
                  "hbird.eval.consume": 150, "(none)": 40, "hbird.phase.index_build": 10,
                  "hbird.index.layout": 20, "hbird.index.scatter": 30}
    assert sum(by.values()) == 1000 - 400  # the window less the busy union


def test_launches_fall_under_their_spans(recorded):
    t = _trace()
    outside, per = spans.launched_under(t, spans.window_spans(t), "hbird.eval.step", t.activities)
    assert per == [1, 0] and outside == 2  # launched at 1240 in the first step; 1090 and 1590 outside


def test_a_traced_tiny_job_records_what_the_readers_read():
    from portbench.test_portbench_harness import tiny_run

    profiling.clear_spans()
    ctx, out, _ = tiny_run("job", trace=True)
    res = out["res"]
    t = res["trace"]
    found = spans.window_spans(t)
    names = {s.name for s in found}
    n_jobs = len(res["jobs"])
    assert sum(s.name == "hbird.phase.index_build" for s in found) == n_jobs
    assert sum(s.name == "hbird.memory.step" for s in found) == res["train_batches"]
    assert sum(s.name == "hbird.eval.step" for s in found) == res["eval_batches"]
    assert {"hbird.memory.feed", "hbird.eval.feed", "hbird.index.layout"} <= names
    assert "idle_feed_ms.job" not in out["metrics"]  # the CPU run has no device activity
    t.activities = [Activity("k", t.window[0], t.window[0] + 1, 0, t.window[0])]
    feed = load_module(HERE / "metrics" / "idle_feed_ms.job.py").read(res, ctx)
    index = load_module(HERE / "metrics" / "idle_index_s.job.py").read(res, ctx)
    assert feed > 0 and index > 0
    profiling.clear_spans()
