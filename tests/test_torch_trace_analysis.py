"""The port's trace analysis (``util/trace_analysis.py``) against the JAX
package's: ``analyze``'s phase attribution and critical path,
``span_tree_lines`` and ``render_trace`` on the same traces, and, on the
port's CPU runtime, ``trace <id>``'s rendered tree over a head-assembled
trace.

The cases are ``tests/test_tracing.py::test_critical_path_phase_attribution``'s
traces, its gap and empty traces, and seeded random span trees; both
packages' results are equal (exact: they are the same float sums in the
same order), and the phases sum to the wall within 1e-6 relative plus
half a microsecond for each number ``analyze`` rounds to the microsecond.  The
sampler's collapsed format (``test_tracing.py::test_profile_collapsed_format``,
whose dashboard endpoint is not ported) is held here too.  Every test
has its own time limit.
"""

import contextlib
import io
import signal
import tempfile
import time

import numpy as np
import pytest

from ray_tpu._private import sampling_profiler as jax_sp
from ray_tpu.util import trace_analysis as jax_ta
from ray_tpu_torch._private import sampling_profiler as sp
from ray_tpu_torch.util import trace_analysis as ta

LIMIT = 90  # seconds: each test's own limit
T = 60


@pytest.fixture(autouse=True)
def time_limit(request):
    def expired(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past its {LIMIT} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old if old is not None else signal.SIG_DFL)


THE_JAX_TESTS_TRACE = {"trace_id": "t", "spans": [
    {"name": "root", "span_id": "r", "parent_span_id": "",
     "phase": "http", "source": "trace", "start": 0.0, "end": 10.0},
    {"name": "queue", "span_id": "q", "parent_span_id": "r",
     "phase": "scheduler_queue", "source": "task", "start": 1.0, "end": 4.0},
    {"name": "exec", "span_id": "x", "parent_span_id": "r",
     "phase": "execution", "source": "task", "start": 4.0, "end": 9.0},
    {"name": "wait", "span_id": "w", "parent_span_id": "x",
     "phase": "channel_wait", "source": "compiled_dag", "start": 5.0, "end": 7.0},
]}
GAP_TRACE = {"spans": [
    {"name": "a", "span_id": "a", "phase": "p", "start": 0.0, "end": 1.0},
    {"name": "b", "span_id": "b", "phase": "p", "start": 3.0, "end": 4.0},
]}


def _random_trace(seed, n=40):
    """A seeded span tree: nested intervals, some orphan parents, a few
    malformed spans (no end, end before start), shared start times."""
    rng = np.random.default_rng(seed)
    spans = [{"name": "root", "span_id": "s0", "parent_span_id": "",
              "phase": "http", "source": "trace", "start": 100.0, "end": 110.0}]
    bounds = [(100.0, 110.0)]  # each span's interval as drawn
    for i in range(1, n):
        k = int(rng.integers(len(spans)))
        parent = spans[k]
        lo, hi = bounds[k]
        a = round(float(rng.uniform(lo, hi)), 3)
        b = round(float(rng.uniform(a, hi)), 3)
        if rng.random() < 0.1:
            a = lo  # a tie on start
        bounds.append((a, b))
        span = {"name": f"span{i}", "span_id": f"s{i}",
                "parent_span_id": parent["span_id"] if rng.random() > 0.1 else "gone",
                "phase": ["execution", "scheduler_queue", "channel_wait", "object_transfer",
                          None][int(rng.integers(5))],
                "source": ["task", "trace", "compiled_dag"][int(rng.integers(3))],
                "start": a, "end": b}
        if rng.random() < 0.05:
            span["end"] = None
        elif rng.random() < 0.05:
            span["end"] = a - 1.0
        spans.append(span)
    return {"trace_id": f"seed{seed}", "spans": spans, "dropped_spans": seed % 2}


def _phases_sum_to_wall(a):
    """The phases sum to the wall within 1e-6 relative, beside the half
    microsecond ``analyze`` may round each of them and the wall by."""
    gap = abs(sum(a["phases"].values()) - a["wall_s"])
    assert gap <= 1e-6 * a["wall_s"] + 5e-7 * (len(a["phases"]) + 1), (gap, a)


def test_critical_path_phase_attribution():
    a = ta.analyze(THE_JAX_TESTS_TRACE)
    assert a == jax_ta.analyze(THE_JAX_TESTS_TRACE)
    assert a["wall_s"] == pytest.approx(10.0)
    assert a["phases"]["http"] == pytest.approx(2.0)
    assert a["phases"]["scheduler_queue"] == pytest.approx(3.0)
    assert a["phases"]["execution"] == pytest.approx(3.0)
    assert a["phases"]["channel_wait"] == pytest.approx(2.0)
    _phases_sum_to_wall(a)
    path = [(s["name"], s["phase"]) for s in a["critical_path"]]
    assert path == [("root", "http"), ("queue", "scheduler_queue"), ("exec", "execution"),
                    ("wait", "channel_wait"), ("exec", "execution"), ("root", "http")]
    text = ta.render_trace(THE_JAX_TESTS_TRACE, a)
    assert text == jax_ta.render_trace(THE_JAX_TESTS_TRACE, a)
    assert "critical path" in text and "scheduler_queue" in text


@pytest.mark.parametrize("trace", [GAP_TRACE, None, {}, {"spans": []}],
                         ids=["gap", "none", "empty", "no_spans"])
def test_gaps_and_empty_traces(trace):
    a = ta.analyze(trace)
    assert a == jax_ta.analyze(trace)
    if trace is GAP_TRACE:
        assert a["phases"]["idle"] == pytest.approx(2.0)
    else:
        assert a == {"wall_s": 0.0, "num_spans": 0, "phases": {}, "critical_path": []}
    assert ta.render_trace(trace) == jax_ta.render_trace(trace)


@pytest.mark.parametrize("seed", range(6))
def test_seeded_span_trees_analyze_and_render_alike(seed):
    trace = _random_trace(seed)
    a = ta.analyze(trace)
    assert a == jax_ta.analyze(trace)
    _phases_sum_to_wall(a)
    assert a["critical_path"]
    assert ta.span_tree_lines(trace) == jax_ta.span_tree_lines(trace)
    assert ta.render_trace(trace, a) == jax_ta.render_trace(trace, a)


def test_profile_collapsed_format():
    for mod in (sp, jax_sp):
        p = mod.SamplingProfiler(period_s=0.001)
        p.samples["a.py:f|b.py:g"] = 7
        p.samples["a.py:f"] = 3
        folded = p.report_collapsed()
        assert "a.py:f;b.py:g 7" in folded.splitlines()
        assert mod.collapsed_from_report(p.report()) == folded
    ref = jax_sp.SamplingProfiler()
    ref.samples.update(p.samples)
    assert p.report_collapsed() == ref.report_collapsed()
    assert p.report_text() == ref.report_text()


def test_trace_command_renders_a_head_assembled_trace():
    """On a port runtime, a traced actor call's trace renders through
    ``trace <id>`` as ``render_trace`` renders the state API's trace, with
    the call's spans in the tree and the phases summing to the wall."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.experimental.state import api as state
    from ray_tpu_torch.scripts import cli
    from ray_tpu_torch.util import tracing

    with tempfile.TemporaryDirectory(prefix="trace_") as d, pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMPDIR", d)
        mp.setattr(tempfile, "tempdir", d)
        rt.init(num_cpus=2)
        try:
            @rt.remote
            class Echo:
                def echo(self, x):
                    time.sleep(0.01)
                    return x

            e = Echo.remote()
            rt.get(e.echo.remote(0), timeout=T)
            with tracing.trace("render-me") as ctx:
                assert rt.get(e.echo.remote(1), timeout=T) == 1
            deadline = time.monotonic() + T
            trace = last = None
            while time.monotonic() < deadline:
                # settled: the call's span is in, and a second read finds
                # no span that arrived since (the CLI reads it again below)
                last, trace = trace, state.get_trace(ctx["trace_id"])
                if (trace and any(s["name"] == "Echo.echo" for s in trace["spans"])
                        and trace == last):
                    break
                time.sleep(0.2)
            assert trace and any(s["name"] == "Echo.echo" for s in trace["spans"])
            a = ta.analyze(trace)
            assert a == jax_ta.analyze(trace)
            _phases_sum_to_wall(a)
            assert a["critical_path"]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(["trace", ctx["trace_id"]])
            out = buf.getvalue()
            assert out.startswith(jax_ta.render_trace(trace, a).split("\n")[0])
            assert "critical path:" in out and "Echo.echo" in out
        finally:
            rt.shutdown()
