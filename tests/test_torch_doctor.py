"""The port's doctor (``util/doctor.py``) against the JAX package's, on the
CPU with no runtime.

Every event rule (``diagnose``) and trend rule (``diagnose_trends``)
runs on the same seeded events, task rows and series in both packages,
healthy and with the pathology induced (``test_resource_accounting.py``'s
lines 286-356 among them), and the findings are equal; ``render`` gives
the same text.  The port's text names its own command and knobs, so the
JAX package's strings are compared after the port's renaming
(``ray_tpu`` -> ``ray_tpu_torch``, ``RAY_TPU_`` -> ``RAY_TPU_TORCH_``),
the one change the port makes to them.  The recompile-storm and
MFU-regression rules also run on what the port's own ``util/perf.py``
records: its compile tracker's events and its step profiler's MFU gauge,
pushed through both packages' time-series stores.
"""

import re
import signal

import numpy as np
import pytest
import torch

from ray_tpu.util import doctor as jax_doctor
from ray_tpu.util import tsdb as jax_tsdb
from ray_tpu_torch._private import events as events_mod
from ray_tpu_torch.util import doctor, metrics, perf, tsdb

T0 = 1_700_000_000.0
LIMIT = 90  # seconds: each test's own limit


@pytest.fixture(autouse=True)
def time_limit(request):
    def expired(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past its {LIMIT} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old if old is not None else signal.SIG_DFL)


def _ported(text: str) -> str:
    return re.sub(r"\bray_tpu\b", "ray_tpu_torch", text).replace("RAY_TPU_", "RAY_TPU_TORCH_")


def _ported_findings(findings):
    return [dict(f, summary=_ported(f["summary"]), remedy=_ported(f["remedy"]))
            for f in findings]


def _same_findings(events, tasks=()):
    port = doctor.diagnose(events, tasks)
    assert port == _ported_findings(jax_doctor.diagnose(events, tasks))
    assert doctor.render(port) == _ported(jax_doctor.render(jax_doctor.diagnose(events, tasks)))
    return port


def _same_trends(series_map):
    port = doctor.diagnose_trends(series_map)
    ref = jax_doctor.diagnose_trends(series_map)
    assert port == _ported_findings(ref)
    assert doctor.render(port) == _ported(jax_doctor.render(ref))
    return port


def test_thresholds_and_rule_sets_equal_the_jax_packages():
    names = [n for n in dir(jax_doctor) if n.isupper() and not n.startswith("_")
             and isinstance(getattr(jax_doctor, n), (int, float))]
    assert len(names) >= 30 and {n: getattr(doctor, n) for n in names} == {
        n: getattr(jax_doctor, n) for n in names}
    assert [r.__name__ for r in doctor.RULES] == [r.__name__ for r in jax_doctor.RULES]
    assert [r.__name__ for r in doctor.TREND_RULES] == [
        r.__name__ for r in jax_doctor.TREND_RULES]


def _ev(source, message, ts, severity="INFO", entity_id=None, span_dur=None, **data):
    row = {"source": source, "message": message, "ts": ts, "severity": severity,
           "entity_id": entity_id, "origin": "w1", "data": data}
    if span_dur is not None:
        row["span_dur"] = span_dur
    return row


def _event_cases(rng):
    """(rule, healthy events, pathological events) for every event rule
    but the task-table one, with seeded magnitudes."""
    r = lambda lo, hi: float(rng.uniform(lo, hi))  # noqa: E731
    t = T0
    return [
        ("backpressure_stall",
         [_ev("streaming", "backpressure stall", t, op="map", total_stalled_s=r(0, 0.4))],
         [_ev("streaming", "backpressure stall", t + i, op=op, total_stalled_s=r(0.3, 2))
          for i, op in enumerate(["map", "map", "filter"])]),
        ("split_starvation",
         [_ev("streaming", "split starved", t, wait_s=r(0, 1.5))],
         [_ev("streaming", "split starved", t + i, wait_s=r(1, 2)) for i in range(3)]),
        ("spill_thrash",
         [_ev("object_store", "spilled object to disk", t, size_mb=r(1, 9))],
         [_ev("object_store", "spilled object to disk", t + i, size_mb=r(1, 90))
          for i in range(4)]),
        ("oom_kills",
         [_ev("scheduler", "dispatch", t)],
         [_ev("scheduler", "OOM kill", t, "WARNING", entity_id="w9", frac=r(0.9, 1))]),
        ("gang_restart",
         [_ev("train", "gang started", t)],
         [_ev("train", "gang failure: rank 1 died", t, "ERROR"),
          _ev("train", "gang restarted", t + 1, "WARNING")]),
        ("stuck_channel",
         [_ev("compiled_dag", "channel wait", t, span_dur=r(6, 9), op="recv")],
         [_ev("compiled_dag", "channel wait", t, span_dur=r(6, 9), op="send"),
          _ev("compiled_dag", "actor loop died", t + 1, "ERROR")]),
        ("router_saturation",
         [_ev("serve", "router stalled: no replica available", t, replicas=0)],
         [_ev("serve", "router stalled: no replica available", t, replicas=2)]),
        ("ingress_shedding",
         [_ev("serve", "ingress shedding started", t, entity_id="app"),
          _ev("serve", "ingress shedding stopped", t + 1, entity_id="app")],
         [_ev("serve", "ingress shedding started", t, entity_id="app"),
          _ev("serve", "ingress shedding stopped", t + 1, entity_id="app"),
          _ev("serve", "ingress shedding started", t + 2, entity_id="app")]),
        ("drain_stuck",
         [_ev("serve", "replica draining", t, entity_id="r1"),
          _ev("serve", "replica drained", t + 2, entity_id="r1")],
         [_ev("serve", "replica draining", t, entity_id="r1"),
          _ev("serve", "replica draining", t, entity_id="r2"),
          _ev("serve", "replica drain timeout", t + 3, "WARNING", entity_id="r2"),
          _ev("node", "tick", t + 30)]),
        ("tenant_killed",
         [_ev("client_proxy", "tenant driver died", t, entity_id="job-1"),
          _ev("client_proxy", "tenant reaped", t + 1, entity_id="job-1"),
          _ev("node", "tick", t + 500)],
         [_ev("client_proxy", "tenant driver died", t, entity_id="job-2"),
          _ev("node", "tick", t + 20)]),
        ("worker_churn",
         [_ev("worker_pool", "worker died: exit", t, "DEBUG")] * 5,
         [_ev("worker_pool", f"worker died: signal {i}", t + i, "WARNING") for i in range(3)]),
        ("log_error_burst",
         [_ev("log", "stream retired", t)],
         [_ev("log", "error burst: 40 lines", t, "WARNING", entity_id="worker-ab")]),
        ("worker_stderr_at_death",
         [_ev("log", "stream retired", t)],
         [_ev("log", "worker died with uncollected stderr", t, "ERROR", entity_id="w",
              tail=["Traceback", "ValueError: boom"])]),
        ("slice_degraded",
         [_ev("node", "slice degraded", t, "ERROR", entity_id="s1"),
          _ev("autoscaler", "slice replaced", t + 5, entity_id="s1")],
         [_ev("node", "slice degraded", t, "ERROR", entity_id="s1"),
          _ev("autoscaler", "slice replacement started", t + 1, entity_id="s1"),
          _ev("autoscaler", "slice replacement failed", t + 2, entity_id="s1")]),
        ("recompile_storm",
         [_ev("perf", "jit compile", t, fn="step", n_sigs=int(rng.integers(1, 5)))],
         [_ev("perf", "jit compile", t + i, fn="step", n_sigs=i + 1) for i in range(6)]),
        ("ingest_bound",
         [_ev("perf", "step phases", t + i, wall_s=1.0,
              phases={"ingest": r(0, 0.2), "compute": 0.8}) for i in range(6)],
         [_ev("perf", "step phases", t + i, wall_s=1.0,
              phases={"ingest": r(0.4, 0.6), "compute": 0.4}) for i in range(6)]),
        ("prefill_interference",
         [_ev("perf", "prefill interference", t, entity_id="e1", interleaved_ticks=30,
              interference_frac=r(0, 0.1))],
         [_ev("perf", "prefill interference", t, entity_id="e1", interleaved_ticks=30,
              interference_frac=r(0, 0.1)),
          _ev("perf", "prefill interference", t + 1, entity_id="e1", interleaved_ticks=40,
              interference_frac=r(0.25, 0.5))]),
    ]


@pytest.mark.parametrize("case", range(17))
def test_event_rule_fires_and_stays_silent_as_in_the_jax_package(case):
    rule, healthy, sick = _event_cases(np.random.default_rng(case))[case]
    assert [f["rule"] for f in _same_findings(healthy)] == []
    found = _same_findings(sick)
    assert [f["rule"] for f in found] == [rule]


def _tasks(rng, slow_node=True):
    rows = []
    for node, scale in (("n-fast", 1.0), ("n-slow", 5.0 if slow_node else 1.1)):
        for i in range(8):
            start = T0 + i
            rows.append({"name": "work", "node_id": node, "exec_start": start,
                         "exec_end": start + scale * float(rng.uniform(0.09, 0.11))})
    return rows


def test_slow_node_skew_on_seeded_task_rows():
    rng = np.random.default_rng(17)
    assert _same_findings([], _tasks(rng, slow_node=False)) == []
    found = _same_findings([], _tasks(rng))
    assert [f["rule"] for f in found] == ["slow_node_skew"]
    assert found[0]["evidence"][0]["slow"] == "n-slow"


def test_every_event_rule_at_once_sorts_by_severity():
    rng = np.random.default_rng(18)
    events = [e for _, _, sick in _event_cases(rng) for e in sick]
    found = _same_findings(events, _tasks(rng))
    assert len(found) == 18
    sev = [f["severity"] for f in found]
    assert sev == sorted(sev, key=lambda s: doctor._SEV_ORDER[s])


def _series(vals, tags=None, step=30.0):
    return {"tags": tags or {}, "points": [[T0 + i * step, v] for i, v in enumerate(vals)]}


def test_trend_rules_fire_on_induced_pathologies():
    """``test_resource_accounting.py``'s induced leak, store growth and
    queue climb, and the four trend rules it does not induce."""
    leak = _series([100 + 20 * i for i in range(20)], tags={"worker_id": "wleak"})
    store = _series([(64 + 48 * i) * (1 << 20) for i in range(20)])
    queue = _series([4 + 3 * i for i in range(20)])
    found = _same_trends({"ray_tpu_proc_rss_mb": [leak],
                          "ray_tpu_object_store_bytes": [store],
                          "ray_tpu_sched_queue_depth": [queue]})
    assert {f["rule"] for f in found} == {"rss_growth", "object_store_leak", "queue_depth_climb"}
    rss = next(f for f in found if f["rule"] == "rss_growth")
    assert "wleak" in rss["summary"]
    assert rss["evidence"][0]["slope_mb_per_min"] == pytest.approx(40.0)
    mfu = _series([0.4] * 8 + [0.3] * 8, tags={"rank": "0", "origin": "w"})
    gil = _series([0.5, 0.6, 0.55, 0.7, 0.65], tags={"origin": "head"})
    wait = _series([0.0, 3.0], tags={"lock": "node.registry"})
    hold = _series([0.0, 1.0], tags={"lock": "node.registry"})
    ser = _series([0.4, 0.5, 0.45, 0.6])
    found = _same_trends({"ray_tpu_train_step_mfu": [mfu], "ray_tpu_gil_lateness_frac": [gil],
                          "ray_tpu_lock_wait_s": [wait], "ray_tpu_lock_hold_s": [hold],
                          "ray_tpu_profile_serialization_frac": [ser]})
    assert {f["rule"] for f in found} == {"mfu_regression", "gil_saturation",
                                          "lock_contention", "serialization_hot"}


def test_trend_rules_stay_silent_on_healthy_series():
    flat = _series([100.0 + (i % 3) for i in range(20)], tags={"worker_id": "w"})
    sawtooth = _series([0, 5, 2, 0, 7, 1, 0, 4, 0, 6] * 2)
    shrinking = _series([(512 - 10 * i) * (1 << 20) for i in range(20)])
    warmup = _series([100.0, 400.0, 405.0, 406.0, 406.0, 406.0, 406.0], tags={"worker_id": "w2"})
    steady_mfu = _series([0.4 + 0.001 * (i % 2) for i in range(16)], tags={"rank": "0"})
    assert _same_trends({"ray_tpu_proc_rss_mb": [flat, warmup],
                         "ray_tpu_object_store_bytes": [shrinking],
                         "ray_tpu_sched_queue_depth": [sawtooth],
                         "ray_tpu_train_step_mfu": [steady_mfu]}) == []
    short = _series([100 + 50 * i for i in range(3)], tags={"worker_id": "w"})
    assert _same_trends({"ray_tpu_proc_rss_mb": [short]}) == []


@pytest.mark.parametrize("seed", range(6))
def test_trend_rules_on_seeded_random_walks(seed):
    """Seeded random walks with a drift drawn per series: whatever the
    rules conclude, they conclude in both packages."""
    rng = np.random.default_rng(100 + seed)
    series_map = {}
    for name, scale in (("ray_tpu_proc_rss_mb", 10.0), ("ray_tpu_object_store_bytes", 1 << 24),
                        ("ray_tpu_arena_bytes_used", 1 << 24), ("ray_tpu_sched_queue_depth", 2.0),
                        ("ray_tpu_train_step_mfu", 0.01), ("ray_tpu_gil_lateness_frac", 0.05),
                        ("ray_tpu_profile_serialization_frac", 0.05)):
        rows = []
        for k in range(3):
            drift = float(rng.normal(0, scale))
            walk = np.cumsum(rng.normal(drift, scale, 24)) + 10 * scale
            rows.append(_series(np.abs(walk).tolist(), tags={"worker_id": f"w{k}"}))
        series_map[name] = rows
    _same_trends(series_map)


def _head_reports(stores, window=1800.0, now=None):
    return [mod.head_report(None, None, s, trend_window_s=window)
            for mod, s in zip((doctor, jax_doctor), stores)]


def test_head_report_reads_both_time_series_stores_the_same():
    """Seeded registry snapshots of a leaking worker through both
    packages' stores: ``head_report`` over each finds the same leak."""
    import time

    stores = (tsdb.TimeSeriesStore(), jax_tsdb.TimeSeriesStore())
    rng = np.random.default_rng(3)
    now = time.time()
    for i in range(30):
        snap = {"ray_tpu_proc_rss_mb": {"type": "gauge", "help": "", "values": {
            (("worker_id", "wleak"), ("entity", "worker")): 200.0 + 25 * i + float(rng.random()),
            (("worker_id", "wok"), ("entity", "worker")): 200.0 + float(rng.random())}}}
        for s in stores:
            s.ingest("head", snap, ts=now - 600 + 20 * i)
    port, ref = _head_reports(stores)
    assert port == _ported_findings(ref)
    assert [f["rule"] for f in port] == ["rss_growth"]
    assert port[0]["evidence"][0]["tags"]["worker_id"] == "wleak"


def test_doctor_state_windows_and_caches_as_the_jax_package():
    rng = np.random.default_rng(4)
    sick = [_ev("scheduler", "OOM kill", T0 + i, "WARNING", frac=float(rng.random()))
            for i in range(3)]
    for mod in (doctor, jax_doctor):
        st = mod.DoctorState(event_window_s=60.0)
        st.feed_rows(sick)
        assert [f["rule"] for f in st.diagnose(now=T0 + 10)] == ["oom_kills"]
        assert not st.dirty
        assert st.diagnose(now=T0 + 200) == []  # the evidence aged out
        assert st.window_len() == 0


def test_recompile_storm_fires_on_the_ports_compile_tracker():
    """The port's ``CompileTracker`` wraps a function called at six
    shapes: its ``perf``/``jit compile`` events, read from the port's
    own flight recorder, trip ``recompile_storm`` in both packages."""
    seq0 = max([e.get("seq", 0) for e in events_mod.local_events()], default=0)
    tracker = perf.CompileTracker()
    fn = tracker.wrap(lambda x: (x * 2).sum(), name="rt_doctor_step")
    for n in range(1, 7):
        fn(torch.ones(n, 3))
    fn(torch.ones(6, 3))  # a hit
    rows = [e for e in events_mod.local_events() if e.get("seq", 0) > seq0
            and e["source"] == "perf" and (e.get("data") or {}).get("fn") == "rt_doctor_step"]
    assert [r["data"]["n_sigs"] for r in rows] == [1, 2, 3, 4, 5, 6]
    found = _same_findings(rows)
    assert [f["rule"] for f in found] == ["recompile_storm"]
    assert "rt_doctor_step (6 signatures)" in found[0]["summary"]


def test_mfu_regression_fires_on_the_ports_step_profiler():
    """The port's ``StepProfiler`` on the CPU (peak given) runs 16 steps
    whose second half is slower: its ``ray_tpu_train_step_mfu`` gauge,
    pushed after each step through both packages' stores at a 30 s
    cadence, trips ``mfu_regression`` in both."""
    import time

    prof = perf.StepProfiler(flops_per_token=1e6, tokens_per_step=1000, device="cpu",
                             peak=1e12, rank=7, hbm_every=0)
    stores = (tsdb.TimeSeriesStore(), jax_tsdb.TimeSeriesStore())
    now = time.time()
    for i in range(16):
        with prof.step():
            with prof.phase("compute"):
                time.sleep(0.01 if i < 8 else 0.02)
        snap = {k: v for k, v in metrics.registry().snapshot().items()
                if k == "ray_tpu_train_step_mfu"}
        for s in stores:
            s.ingest("w-train", snap, ts=now - 480 + 30 * i)
    port, ref = _head_reports(stores, window=900.0)
    assert port == _ported_findings(ref)
    assert [f["rule"] for f in port] == ["mfu_regression"]
    assert port[0]["evidence"][0]["tags"] == {"rank": "7", "origin": "w-train"}


def test_render_of_no_findings_and_of_long_evidence():
    assert doctor.render([]) == _ported(jax_doctor.render([]))
    rng = np.random.default_rng(5)
    sick = [_ev("object_store", "spilled object to disk", T0 + i, size_mb=float(rng.random()))
            for i in range(9)]
    _same_findings(sick)
    assert "... 6 more evidence row(s)" in doctor.render(doctor.diagnose(sick))
