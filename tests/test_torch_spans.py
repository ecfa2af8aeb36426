"""The port's hot-path spans (``util/tracing.py`` ``arm`` / ``span``).

Disarmed and outside a trace a span is the shared no-op: no flight-
recorder row, no id, no context written.  Armed, a span records on any
thread, with its start on the epoch clock (``torch.profiler``'s), its
thread and the armed span around it.  Inside a trace a span is the trace's
child whether armed or not, with the rows it always had.
"""

import threading
import time

import pytest
import torch

from ray_tpu_torch._private import events
from ray_tpu_torch.util import tracing


@pytest.fixture
def rows_since():
    """Rows of the ``trace`` source recorded after the fixture started;
    the process is disarmed again afterwards whatever the test did."""
    since = events.buffer().last_seq()
    yield lambda: [r for r in events.local_events()
                   if r["seq"] > since and r["source"] == tracing.TRACE_SOURCE]
    tracing.arm(False)


def test_a_disarmed_span_outside_any_context_records_nothing_and_makes_no_id(
        rows_since, monkeypatch):
    made = []
    real = tracing.new_span_id
    monkeypatch.setattr(tracing, "new_span_id", lambda: made.append(1) or real())
    before = (tracing._current.get(), tracing._enclosing.get())
    for name in ("gen.decode_attend", "engine.prefill"):
        cm = tracing.span(name)
        assert cm is tracing._NOOP  # the shared no-op, no generator made
        with cm as ctx:
            assert ctx is None
            assert (tracing._current.get(), tracing._enclosing.get()) == before
    assert rows_since() == [] and made == []


def test_an_armed_span_records_on_any_thread_with_its_parent(rows_since):
    tracing.arm(True)  # armed here, recorded on another thread
    seen = {}

    def work():
        seen["thread"] = threading.get_ident()
        with tracing.span("outer") as ctx:
            assert ctx is None
            with tracing.span("inner", note=3):
                time.sleep(0.002)

    t0 = time.time_ns()
    th = threading.Thread(target=work)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    tracing.arm(False)
    with tracing.span("after"):
        pass
    rows = {r["message"]: r for r in rows_since()}
    assert set(rows) == {"outer", "inner"}
    outer, inner = rows["outer"]["data"], rows["inner"]["data"]
    assert outer["thread"] == inner["thread"] == seen["thread"] != threading.get_ident()
    assert outer["parent_span_id"] == "" and inner["parent_span_id"] == outer["span_id"]
    assert inner["note"] == 3 and "trace_id" not in inner
    assert t0 <= outer["start_ns"] <= inner["start_ns"]
    assert rows["inner"]["span_dur"] >= 0.002
    end = lambda r: r["data"]["start_ns"] + r["span_dur"] * 1e9
    assert end(rows["inner"]) <= end(rows["outer"]) + 1e3  # within a microsecond
    assert rows["outer"]["ts"] == pytest.approx(end(rows["outer"]) / 1e9, abs=1e-6)


@pytest.mark.parametrize("armed", [False, True])
def test_inside_a_trace_span_rows_are_the_traces_children(rows_since, armed):
    tracing.arm(armed)
    with tracing.trace("request") as root:
        with tracing.span("step", phase="work", n=1) as ctx:
            assert tracing.current_context() == ctx
            assert ctx["parent_span_id"] == root["span_id"]
    rows = {r["message"]: r for r in rows_since()}
    step = rows["step"]
    assert step["entity_id"] == root["trace_id"]
    assert step["data"] == {"trace_id": root["trace_id"], "span_id": ctx["span_id"],
                            "parent_span_id": root["span_id"], "phase": "work", "n": 1}
    assert tracing.current_context() is None


def test_an_armed_span_starts_on_the_profilers_clock(rows_since):
    """The same block under a ``record_function`` of a CPU-activity
    profile and an armed span, on one thread: their starts agree within
    a millisecond."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):  # the profiler's first range pays its set-up
            x @ x
        tracing.arm(True)
        with record_function("block"), tracing.span("block"):
            x @ x
        tracing.arm(False)
    (row,) = [r for r in rows_since() if r["message"] == "block"]
    (rf,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "block" and e.device_type() == torch.autograd.DeviceType.CPU]
    assert abs(row["data"]["start_ns"] - rf.start_ns()) < 1_000_000

