"""The port's watchdog plane against the JAX package's: the incident
lifecycle and its ids (``util/incidents.py``), the SLO burn-rate math
(``util/watchdog.py``), the alert sinks and the bundle retention, and, on
the port's CPU runtime, the whole loop: a SIGKILL'd worker's stderr tail
opens an incident within a tick, fires the webhook, freezes a bundle
under the session directory, resolves once the evidence ages out and
re-opens on a repeat kill; the CLI's ``incidents``, ``slo``, ``debug``
and ``doctor --live`` read it.

The cases are ``tests/test_watchdog.py``'s.  The pure ones feed the same
findings, the same TSDB points and the same files to both packages and
hold the results equal: exact for ids, transitions, states, counts and
verdicts, floats within 1e-9 relative.  The webhook posts to an HTTP
server on 127.0.0.1; nothing leaves the host.  No JAX runtime starts;
the live cases run one port runtime under a private ``TMPDIR``, and
every test has its own time limit.
"""

import contextlib
import http.server
import io
import json
import os
import signal
import sys
import tempfile
import threading
import time

import numpy as np
import pytest

from ray_tpu.util import incidents as jax_inc
from ray_tpu.util import tsdb as jax_tsdb
from ray_tpu.util import watchdog as jax_wd
from ray_tpu_torch.util import incidents as inc
from ray_tpu_torch.util import tsdb
from ray_tpu_torch.util import watchdog as wd

LIMIT = 120  # seconds: each test's own limit
T = 30  # seconds: every wait on the runtime


@pytest.fixture(autouse=True)
def time_limit(request):
    def expired(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past its {LIMIT} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old if old is not None else signal.SIG_DFL)


def _wait_for(fn, timeout=T, interval=0.1, desc="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = fn()
        if v:
            return v
        time.sleep(interval)
    raise AssertionError(f"{desc} not met within {timeout}s")


def _same(port, ref):
    """Equal results: exact for everything, floats within 1e-9 relative."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and set(port) == set(ref), (port, ref)
        for k in ref:
            _same(port[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref), (port, ref)
        for a, b in zip(port, ref):
            _same(a, b)
    elif isinstance(ref, float):
        assert port == pytest.approx(ref, rel=1e-9, abs=0.0), (port, ref)
    else:
        assert port == ref, (port, ref)


def _finding(rule="test_rule", entity="e1", severity="WARNING", **kw):
    return dict({"rule": rule, "entity": entity, "severity": severity,
                 "summary": f"{rule} on {entity}", "remedy": "fix it",
                 "count": 1, "evidence": [{"entity_id": entity}]}, **kw)


class _Tables:
    """The same observations on both packages' incident tables; every
    call's result is held equal."""

    def __init__(self, **kw):
        self.t = (inc.IncidentTable(**kw), jax_inc.IncidentTable(**kw))

    def __getattr__(self, name):
        def call(*a, **k):
            outs = [getattr(t, name)(*a, **k) for t in self.t]
            _same(outs[0], outs[1])
            return outs[0]
        return call


# -- the incident lifecycle (pure) ---------------------------------------------

@pytest.mark.parametrize("rule,entity", [("test_rule", "e1"), ("slo:serve_p99", "serve_p99"),
                                         ("worker_stderr_at_death", ""),
                                         ("r", "node-1/worker 7:a|b"), ("r", "x" * 200),
                                         ("r", None)])
def test_incident_ids_match_jax(rule, entity):
    assert inc.incident_id(rule, entity) == jax_inc.incident_id(rule, entity)


def test_incident_open_refresh_resolve_hysteresis():
    t = _Tables(resolve_ticks=3)
    trs = t.observe([_finding()], now=100.0)
    assert [tr for _, tr in trs] == ["open"]
    iid = trs[0][0]["id"]
    assert iid == inc.incident_id("test_rule", "e1")
    assert t.observe([_finding(severity="ERROR")], now=101.0) == []
    assert t.get(iid)["severity"] == "ERROR"
    assert t.observe([], now=102.0) == [] and t.observe([], now=103.0) == []
    assert t.observe([_finding()], now=104.0) == []
    assert t.get(iid)["state"] == "open" and t.get(iid)["clear_streak"] == 0
    t.observe([], now=105.0)
    t.observe([], now=106.0)
    assert [tr for _, tr in t.observe([], now=107.0)] == ["resolve"]
    assert t.get(iid)["state"] == "resolved" and t.get(iid)["resolved_at"] == 107.0


def test_incident_reopen_escalates_flappy():
    t = _Tables(resolve_ticks=1, escalate_reopens=2)
    t.observe([_finding(severity="WARNING")], now=1.0)
    iid = inc.incident_id("test_rule", "e1")
    transitions = []
    now = 2.0
    for _ in range(2):
        transitions += [tr for _, tr in t.observe([], now=now)]
        now += 1
        transitions += [tr for _, tr in t.observe([_finding()], now=now)]
        now += 1
    assert transitions == ["resolve", "reopen", "resolve", "reopen", "escalate"]
    snap = t.get(iid)
    assert snap["reopen_count"] == 2 and snap["escalated"] and snap["severity"] == "ERROR"
    t.observe([_finding(severity="WARNING")], now=now)
    assert t.get(iid)["severity"] == "ERROR"


def test_incident_ack_silences_then_resolves():
    t = _Tables(resolve_ticks=2)
    t.observe([_finding()], now=1.0)
    iid = inc.incident_id("test_rule", "e1")
    assert t.ack("nope") is None
    snap = t.ack(iid, now=2.0)
    assert snap["state"] == "ack" and snap["ack_at"] == 2.0
    assert t.ack(iid) is None
    assert t.observe([_finding()], now=3.0) == []
    t.observe([], now=4.0)
    assert [tr for _, tr in t.observe([], now=5.0)] == ["resolve"]


def test_incident_table_bounded():
    t = _Tables(max_incidents=5, resolve_ticks=1)
    for i in range(8):
        t.observe([_finding(entity=f"e{i}")], now=float(i))
    assert len(t.list()) == 5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_findings_give_equal_transitions(seed):
    """300 ticks of seeded findings (8 rules x 6 entities, flapping, with
    acks between ticks) under a small table: every tick's transitions,
    the final list, the counts and each incident's history are equal."""
    rng = np.random.default_rng(seed)
    t = _Tables(resolve_ticks=2, escalate_reopens=2, max_incidents=20,
                history_per_incident=6)
    sevs = ["INFO", "WARNING", "ERROR", "CRITICAL"]
    seen = set()
    for k in range(300):
        findings = []
        for _ in range(int(rng.integers(0, 5))):
            findings.append(_finding(rule=f"rule{int(rng.integers(8))}",
                                     entity=f"ent{int(rng.integers(6))}",
                                     severity=sevs[int(rng.integers(4))],
                                     count=int(rng.integers(1, 9))))
        for _, tr in t.observe(findings, now=1000.0 + k):
            seen.add(tr)
        if rng.random() < 0.2:
            rows = t.list(include_resolved=False)
            if rows:
                t.ack(rows[int(rng.integers(len(rows)))]["id"], now=1000.5 + k)
    assert {"open", "resolve", "reopen", "escalate"} <= seen
    t.list()
    t.counts()


# -- SLO burn rates (synthetic TSDB, deterministic timestamps) ------------------

NOW = 1_000_000.0


def _fill(stores, name, value_fn, span_s, step_s=10.0, tags=None, mtype="gauge"):
    for st in stores:
        ts = NOW - span_s
        while ts <= NOW:
            st.add_sample(name, value_fn(ts), tags=tags, mtype=mtype, ts=ts)
            ts += step_s


def _tsdbs():
    return tsdb.TimeSeriesStore(), jax_tsdb.TimeSeriesStore()


def _evaluate(slo_kw, stores):
    port = wd.evaluate_slo(wd.make_slo(**slo_kw), stores[0], now=NOW)
    ref = jax_wd.evaluate_slo(jax_wd.make_slo(**slo_kw), stores[1], now=NOW)
    _same(port, ref)
    return port


P99 = dict(name="p99", metric="m", threshold=2.0, fast_window_s=60.0, slow_window_s=600.0)


def test_burn_rate_fires_only_when_both_windows_burn():
    stores = _tsdbs()
    _fill(stores, "m", lambda ts: 5.0, 600.0)
    ev = _evaluate(P99, stores)
    assert ev["fast"]["breach"] and ev["slow"]["breach"] and ev["burning"]
    stores = _tsdbs()
    _fill(stores, "m", lambda ts: 10.0 if ts > NOW - 60 else 0.1, 600.0)
    ev = _evaluate(P99, stores)
    assert ev["fast"]["breach"] and not ev["slow"]["breach"] and not ev["burning"]


def test_burn_rate_window_coverage_guard():
    stores = _tsdbs()
    _fill(stores, "m", lambda ts: 9.9, 90.0)
    ev = _evaluate(P99, stores)
    assert ev["fast"]["evaluable"] and ev["fast"]["breach"]
    assert not ev["slow"]["evaluable"] and not ev["burning"]
    ev = _evaluate(P99, _tsdbs())
    assert not ev["fast"]["evaluable"] and not ev["burning"]


@pytest.mark.parametrize("value,burning", [(0.1, True), (0.8, False)])
def test_burn_rate_floor_objective(value, burning):
    stores = _tsdbs()
    _fill(stores, "m", lambda ts: value, 600.0)
    ev = _evaluate(dict(P99, threshold=0.5, op=">="), stores)
    assert ev["burning"] is burning


@pytest.mark.parametrize("bad,good,burning", [(0.5, 1.5, True), (0.002, 2.0, False)])
def test_burn_rate_ratio_kind_deltas_per_series(bad, good, burning):
    stores = _tsdbs()
    _fill(stores, "req", lambda ts: (ts - (NOW - 600)) * good, 600.0,
          tags={"code_class": "2xx"}, mtype="counter")
    _fill(stores, "req", lambda ts: (ts - (NOW - 600)) * bad, 600.0,
          tags={"code_class": "5xx"}, mtype="counter")
    ev = _evaluate(dict(name="5xx", metric="req", threshold=0.05, kind="ratio",
                        tags={"code_class": "5xx"}, denominator="req",
                        fast_window_s=60.0, slow_window_s=600.0), stores)
    assert ev["burning"] is burning
    if burning:
        assert ev["slow"]["value"] == pytest.approx(0.25, abs=0.05)


@pytest.mark.parametrize("agg", ["avg", "max", "min", "last"])
@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_points_give_equal_verdicts(agg, seed):
    """Seeded noisy series of two label sets, a coverage hole and a step
    change: both packages' verdicts are equal for each aggregation."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(2.0, 1.0, 200)
    stores = _tsdbs()
    for st in stores:
        for i, v in enumerate(vals):
            if 60 <= i < 90:
                continue  # a coverage hole
            for tag in ("a", "b"):
                st.add_sample("lat", float(v + (1.5 if i > 150 else 0.0)
                                           + (0.3 if tag == "b" else 0.0)),
                              tags={"rank": tag}, ts=NOW - 2000.0 + 10.0 * i)
    for thr, op in ((2.0, "<="), (2.5, "<="), (1.0, ">="), (3.0, ">=")):
        for tags in ({}, {"rank": "b"}):
            _evaluate(dict(name="s", metric="lat", threshold=thr, op=op, agg=agg, tags=tags,
                           fast_window_s=300.0, slow_window_s=1800.0), stores)


def test_slo_declarations_match_jax(tmp_path):
    _same(wd.default_slos(), jax_wd.default_slos())
    for bad in (dict(kind="nonsense"), dict(op="<")):
        with pytest.raises(ValueError):
            wd.make_slo("x", "m", 1.0, **bad)
        with pytest.raises(ValueError):
            jax_wd.make_slo("x", "m", 1.0, **bad)
    path = tmp_path / "slos.json"
    path.write_text(json.dumps({"slos": [
        {"name": "serve_p99", "metric": "ray_tpu_serve_http_p99_s", "threshold": 9.0},
        {"name": "custom", "metric": "my_metric", "threshold": 1.0, "op": ">="},
        {"name": "broken", "metric": "x", "threshold": 1.0, "kind": "nonsense"},
    ]}))
    loaded = wd.load_slos_file(str(path))
    _same(loaded, jax_wd.load_slos_file(str(path)))
    assert [s["name"] for s in loaded] == ["serve_p99", "custom"]
    (tmp_path / "bare.json").write_text(json.dumps([{"name": "b", "metric": "m",
                                                     "threshold": 3}]))
    _same(wd.load_slos_file(str(tmp_path / "bare.json")),
          jax_wd.load_slos_file(str(tmp_path / "bare.json")))


def test_slos_json_and_overrides(tmp_path, monkeypatch):
    path = tmp_path / "slos.json"
    path.write_text(json.dumps({"slos": [
        {"name": "serve_p99", "metric": "ray_tpu_serve_http_p99_s", "threshold": 9.0},
        {"name": "custom", "metric": "my_metric", "threshold": 1.0, "op": ">="}]}))

    class _Node:  # the watchdog reads only this in __init__
        session_dir = str(tmp_path)

    monkeypatch.setenv("RAY_TPU_TORCH_SLOS", str(path))
    w = wd.Watchdog(_Node(), cadence=999.0, sinks=inc.SinkSet([]), capture_bundles=False)
    try:
        by_name = {s["name"]: s for s in w.slos()}
        assert by_name["serve_p99"]["threshold"] == 9.0
        assert "custom" in by_name and "mfu_floor" in by_name
        assert all(s["burning"] is False for s in by_name.values())
        w.add_slo("custom", "my_metric", 5.0)
        assert {s["threshold"] for s in w.slos() if s["name"] == "custom"} == {5.0}
        assert w.remove_slo("custom") and not w.remove_slo("custom")
    finally:
        w.stop()


@pytest.mark.parametrize("knob,want", [("0.3", 0.3), ("0.01", 0.05), ("junk", 15.0),
                                       (None, 15.0)])
def test_cadence_knob_under_the_ports_prefix(monkeypatch, knob, want):
    for name in ("RAY_TPU_TORCH_WATCHDOG_S", "RAY_TPU_WATCHDOG_S"):
        if knob is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, knob)
    assert wd.cadence_s() == jax_wd.cadence_s() == want


def test_incremental_doctor_state_cursors():
    from ray_tpu_torch._private.events import EventTable
    from ray_tpu_torch.util.doctor import DoctorState

    table = EventTable()
    rows = [{"source": "log", "severity": "ERROR",
             "message": "worker died with uncollected stderr: kill", "entity_id": "w1",
             "ts": time.time(), "data": {"tail": ["Traceback (most recent call last):"]}}]
    table.add("origin-1", rows)
    st = DoctorState()
    assert st.feed(table=table) is True and st.feed(table=table) is False
    findings = st.diagnose()
    assert any(f["rule"] == "worker_stderr_at_death" for f in findings)
    assert st.diagnose() == findings
    table.add("origin-1", rows)
    assert st.feed(table=table) is True and st.window_len() == 2


# -- sinks and retention -------------------------------------------------------

class _Hook(http.server.BaseHTTPRequestHandler):
    payloads: list = []
    fail_times = 0  # respond 500 this many times before succeeding

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        type(self).payloads.append(json.loads(body))
        if type(self).fail_times > 0:
            type(self).fail_times -= 1
            self.send_response(500)
        else:
            self.send_response(200)
        self.end_headers()

    def log_message(self, *a):
        pass


@contextlib.contextmanager
def _hook_server():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Hook)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    _Hook.payloads = []
    _Hook.fail_times = 0
    try:
        yield f"http://127.0.0.1:{srv.server_port}/hook"
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("mod", [inc, jax_inc], ids=["port", "jax"])
def test_webhook_bounded_retry_and_dead_letter(mod):
    """Both packages' webhook sinks post the same number of times: two
    500s then a delivery, and a dead letter after the retry budget."""
    with _hook_server() as url:
        _Hook.fail_times = 2
        mod.WebhookSink(url, retries=3, backoff_s=0.01).deliver({"transition": "open"})
        assert len(_Hook.payloads) == 3
        _Hook.payloads = []
        _Hook.fail_times = 10 ** 6
        ss = mod.SinkSet([mod.WebhookSink(url, retries=2, backoff_s=0.01)])
        ss.push({"transition": "open", "incident": {"id": "x"}})
        _wait_for(lambda: ss.stats()["dead_letter"].get("webhook") == 1, timeout=10,
                  desc="dead letter counted")
        assert len(_Hook.payloads) == 2
        ss.stop()


def test_sinkset_bounded_queue_drops_oldest():
    class _Stuck:
        name = "stuck"

        def deliver(self, payload):
            time.sleep(10)

    ss = inc.SinkSet([_Stuck()], maxsize=4)
    for i in range(20):
        ss.push({"i": i})
    stats = ss.stats()
    assert stats["queued"] <= 4 and stats["dropped"] >= 15
    ss.stop()


def test_command_and_log_sinks_deliver_each_transition(tmp_path, caplog):
    """A command hook gets each payload on stdin (here: appends it to a
    file, as the card phase's sink does); the log sink writes one line a
    transition; a failing hook is dead-lettered."""
    out = tmp_path / "transitions.jsonl"
    ss = inc.SinkSet([inc.LogSink(), inc.CommandSink(f"cat >> {out}; echo >> {out}"),
                      inc.CommandSink("exit 3")])
    with caplog.at_level("WARNING", logger=inc.__name__):
        for tr in ("open", "ack", "resolve"):
            ss.push({"transition": tr, "incident": {"id": "i1", "severity": "ERROR",
                                                    "summary": "s"}})
        assert ss.flush(timeout_s=10)
        _wait_for(lambda: ss.stats()["delivered"].get("command") == 3, timeout=10,
                  desc="command sink delivered")
    got = [json.loads(ln)["transition"] for ln in out.read_text().splitlines() if ln]
    assert got == ["open", "ack", "resolve"]
    assert ss.stats()["dead_letter"] == {"command": 3}
    assert sum("incident" in r.getMessage() for r in caplog.records) == 3
    ss.stop()


def test_sinks_from_env_match_jax(monkeypatch):
    for port_name, jax_name, value in (
            ("RAY_TPU_TORCH_INCIDENT_WEBHOOK", "RAY_TPU_INCIDENT_WEBHOOK",
             "http://127.0.0.1:9/hook"),
            ("RAY_TPU_TORCH_INCIDENT_CMD", "RAY_TPU_INCIDENT_CMD", "cat > /dev/null")):
        monkeypatch.setenv(port_name, value)
        monkeypatch.setenv(jax_name, value)
    port, ref = inc.sinks_from_env(), jax_inc.sinks_from_env()
    assert [s.name for s in port] == [s.name for s in ref] == ["log", "webhook", "command"]
    assert (port[1].url, port[2].cmd) == (ref[1].url, ref[2].cmd)


def test_prune_bundle_dirs_matches_jax(tmp_path):
    for side in ("port", "jax"):
        for i in range(6):
            d = tmp_path / side / f"b{i}"
            d.mkdir(parents=True)
            os.utime(d, (i, i))
    pruned = inc.prune_bundle_dirs(str(tmp_path / "port"), keep=2)
    ref = jax_inc.prune_bundle_dirs(str(tmp_path / "jax"), keep=2)
    assert [os.path.basename(p) for p in pruned] == [os.path.basename(p) for p in ref]
    assert len(pruned) == 4
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["b4", "b5"]
    assert inc.prune_bundle_dirs(str(tmp_path / "missing"), 1) == []


def test_watchdog_constants_match_jax():
    names = ("DEFAULT_CADENCE_S", "DEFAULT_FAST_WINDOW_S", "DEFAULT_SLOW_WINDOW_S",
             "DEFAULT_MIN_COVERAGE", "BUNDLE_MAX_STREAMS", "BUNDLE_TAIL_LINES",
             "BUNDLE_MAX_TRACES", "BUNDLE_MAX_METRICS", "BUNDLE_EVENT_ROWS",
             "BUNDLE_TSDB_WINDOW_S", "PROFILE_WINDOW_S")
    assert [getattr(wd, n) for n in names] == [getattr(jax_wd, n) for n in names]
    assert (inc.DEFAULT_RESOLVE_TICKS, inc.DEFAULT_ESCALATE_REOPENS, inc.DEFAULT_MAX_INCIDENTS,
            inc.DEFAULT_HISTORY_PER_INCIDENT) == (
        jax_inc.DEFAULT_RESOLVE_TICKS, jax_inc.DEFAULT_ESCALATE_REOPENS,
        jax_inc.DEFAULT_MAX_INCIDENTS, jax_inc.DEFAULT_HISTORY_PER_INCIDENT)
    # the knobs the port dropped hold the JAX defaults
    assert (wd.DOCTOR_WINDOW_ROWS, wd.EVENT_WINDOW_S, wd.RESOLVE_TICKS, wd.ESCALATE_REOPENS,
            wd.TREND_WINDOW_S, wd.BUNDLE_KEEP) == (20_000, 600.0, 3, 3, 1800.0, 20)


# -- live: the loop on a port runtime ------------------------------------------

@pytest.fixture(scope="module")
def watchdog_cluster():
    import ray_tpu_torch as rt

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Hook)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    _Hook.payloads = []
    _Hook.fail_times = 0
    env = {"RAY_TPU_TORCH_WATCHDOG_S": "0.3",
           "RAY_TPU_TORCH_METRICS_PUSH_S": "0.2",
           "RAY_TPU_TORCH_EVENTS_FLUSH_S": "0.2",
           "RAY_TPU_TORCH_LOG_SHIP_S": "0.1",
           "RAY_TPU_TORCH_INCIDENT_WEBHOOK": f"http://127.0.0.1:{srv.server_port}/hook"}
    with tempfile.TemporaryDirectory(prefix="wd_") as d, pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMPDIR", d)
        mp.setattr(tempfile, "tempdir", d)
        for k, v in env.items():
            mp.setenv(k, v)
        rt.init(num_cpus=4)
        try:
            # the head's watchdog again, with a 2.5 s event window, so the
            # incident resolves within the test
            from ray_tpu_torch._private.worker import global_worker

            node = global_worker.node
            node.watchdog.stop()
            node.watchdog = wd.Watchdog(node, event_window_s=2.5, resolve_ticks=3)
            node.watchdog.start()
            yield rt
        finally:
            rt.shutdown()
            srv.shutdown()
            srv.server_close()


def _transitions(iid):
    return [p["transition"] for p in _Hook.payloads
            if p.get("incident", {}).get("id") == iid]


def _kill_noisy_worker(rt):
    @rt.remote
    class Crashy:
        def arm(self):
            print("Traceback (most recent call last):", file=sys.stderr)
            print("RuntimeError: watchdog-canary-stderr", file=sys.stderr)
            sys.stderr.flush()
            return os.getpid()

    a = Crashy.remote()
    pid = rt.get(a.arm.remote(), timeout=T)
    time.sleep(0.4)  # the ship cycle moves the stderr tail to the head
    os.kill(pid, signal.SIGKILL)
    return a


def _cli(*argv):
    from ray_tpu_torch.scripts import cli

    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            cli.main(list(argv))
        except SystemExit as e:
            code = e.code
    return code, buf.getvalue()


def test_sigkill_incident_bundle_resolve_reopen(watchdog_cluster):
    rt = watchdog_cluster
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.experimental.state import api as state

    node = global_worker.node
    iid = inc.incident_id("worker_stderr_at_death", "cluster")
    _kill_noisy_worker(rt)
    opened = _wait_for(lambda: next((i for i in state.list_incidents() if i["id"] == iid),
                                    None), desc="incident opened")
    assert opened["state"] == "open" and opened["severity"] in ("WARNING", "ERROR")
    _wait_for(lambda: any((e.get("data") or {}).get("transition") == "open"
                          and e.get("entity_id") == iid
                          for e in state.list_events(source="incident", limit=1000)),
              timeout=10, desc="incident event recorded")
    _wait_for(lambda: "open" in _transitions(iid), timeout=10, desc="webhook fired")
    snap = _wait_for(lambda: (lambda i: i if i.get("bundle_dir") else None)(
        state.get_incident(iid)), timeout=10, desc="bundle captured")
    bdir = snap["bundle_dir"]
    assert bdir.startswith(os.path.join(node.session_dir, "incidents"))
    for name in ("incident.json", "events.json", "memory.json"):
        assert os.path.isfile(os.path.join(bdir, name)), name
    tails = "".join(open(os.path.join(bdir, "logs", fn), errors="replace").read()
                    for fn in os.listdir(os.path.join(bdir, "logs")))
    assert "watchdog-canary-stderr" in tails

    # the CLI reads the same incident
    code, out = _cli("incidents", "--json")
    assert code == 0 and iid in {r["id"] for r in json.loads(out)}
    code, out = _cli("doctor", "--live", "--json")
    assert code == 1 and any(f["evidence"][0]["incident_id"] == iid for f in json.loads(out))
    code, out = _cli("incidents", "--history", iid)
    assert code == 0 and "open" in out and "bundle:" in out

    _wait_for(lambda: state.get_incident(iid)["state"] == "resolved", desc="auto-resolved")
    _wait_for(lambda: "resolve" in _transitions(iid), timeout=10, desc="resolve pushed")
    _kill_noisy_worker(rt)
    again = _wait_for(lambda: (lambda i: i if i and i["state"] == "open" else None)(
        next((i for i in state.list_incidents() if i["id"] == iid), None)),
        desc="incident re-opened")
    assert again["reopen_count"] >= 1
    assert [h["transition"] for h in again["history"]].count("open") == 1
    _wait_for(lambda: "reopen" in _transitions(iid), timeout=10, desc="reopen pushed")
    code, out = _cli("incidents", "--ack", iid)
    assert code == 0 and out.startswith(f"acked {iid}")
    assert state.get_incident(iid)["state"] == "ack"
    with pytest.raises(ValueError):
        state.ack_incident("no-such-incident")
    with pytest.raises(ValueError):
        state.get_incident("no-such-incident")
    _wait_for(lambda: "ack" in _transitions(iid), timeout=10, desc="ack pushed")
    stats = node.watchdog.stats()
    assert stats["ticks"] > 5 and stats["avg_tick_ms"] < 100, stats


def test_an_slo_burns_opens_an_incident_and_resolves_after_removal(watchdog_cluster):
    """``add_slo`` on the head's own RSS with a threshold below it burns
    within its windows, opens ``slo:<name>``, and resolves after
    ``remove_slo``; ``slo`` prints it burning (exit 1), then not."""
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.experimental.state import api as state

    node = global_worker.node
    node.watchdog.add_slo("head_rss", "ray_tpu_proc_rss_mb", 1.0, op="<=", agg="avg",
                          tags={"worker_id": "head"}, fast_window_s=1.0,
                          slow_window_s=3.0, severity="WARNING")
    iid = inc.incident_id("slo:head_rss", "head_rss")
    snap = _wait_for(lambda: next((i for i in state.list_incidents()
                                   if i["id"] == iid and i["state"] == "open"), None),
                     desc="slo incident opened")
    assert "burning" in snap["summary"]
    rows = {s["name"]: s for s in state.list_slos()}
    assert rows["head_rss"]["burning"]
    code, out = _cli("slo")
    assert code == 1 and "head_rss" in out and "BURNING" in out
    bdir = _wait_for(lambda: state.get_incident(iid).get("bundle_dir"), desc="bundle")
    assert os.path.isfile(os.path.join(bdir, "tsdb", "ray_tpu_proc_rss_mb.json"))
    assert node.watchdog.remove_slo("head_rss")
    _wait_for(lambda: state.get_incident(iid)["state"] == "resolved", desc="slo resolved")
    code, out = _cli("slo", "--json")
    assert "head_rss" not in {s["name"] for s in json.loads(out)}


def test_healthy_run_opens_zero_incidents(watchdog_cluster):
    rt = watchdog_cluster
    from ray_tpu_torch.experimental.state import api as state

    @rt.remote
    def f(x):
        return x * 2

    _wait_for(lambda: all(i["state"] == "resolved" for i in state.list_incidents()),
              desc="prior incidents resolved")
    assert sum(rt.get([f.remote(i) for i in range(50)], timeout=T)) == 2450
    time.sleep(1.5)
    assert [i for i in state.list_incidents() if i["state"] in ("open", "ack")] == []
    assert all(not s["burning"] for s in state.list_slos())
    code, _ = _cli("doctor", "--live")
    assert code == 0


def test_doctor_report_rpc_and_cli_share_head_path(watchdog_cluster):
    from ray_tpu_torch.experimental.state import api as state
    from ray_tpu_torch.util.doctor import run_doctor

    rpc = state.doctor_report()
    assert isinstance(rpc, list)
    assert all({"rule", "severity", "summary", "remedy", "count", "evidence"} <= set(f)
               for f in rpc)
    assert isinstance(run_doctor(), list)


def test_debug_dump_writes_cluster_bundle(watchdog_cluster):
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.experimental.state import api as state

    path = state.debug_dump(label="testdump")
    assert os.path.isdir(path) and path.endswith("testdump")
    assert path.startswith(global_worker.node.session_dir)
    assert {"incident.json", "events.json", "memory.json"} <= set(os.listdir(path))
    assert os.path.isdir(os.path.join(path, "logs"))
    code, out = _cli("debug", "dump", "--label", "clidump")
    assert code == 0 and out.strip().endswith("clidump") and os.path.isdir(out.strip())


def test_a_chatty_stderr_actor_opens_no_burst_and_tracebacks_still_do(watchdog_cluster):
    """C13: a healthy actor that writes 200 plain lines to stderr opens no
    ``log_error_burst`` incident (the store counts a stderr line only
    when it carries an error level word or lies in a traceback); one that
    writes 20 tracebacks behind a launcher's ``[rank0]: `` prefix (each a
    head, a frame and its exception) still opens it."""
    rt = watchdog_cluster
    from ray_tpu_torch.experimental.state import api as state

    iid = inc.incident_id("log_error_burst", "cluster")

    def burst_open():
        return any(i["id"] == iid and i["state"] in ("open", "ack")
                   for i in state.list_incidents())

    @rt.remote
    class Writer:
        def chat(self, n):
            for i in range(n):
                print(f"step {i}: loss {1.0 / (i + 1):.4f} (progress to stderr)",
                      file=sys.stderr)
            sys.stderr.flush()
            return n

        def fail(self, n):
            for i in range(n):
                print("[rank0]: Traceback (most recent call last):", file=sys.stderr)
                print(f'[rank0]:   File "job.py", line {i}, in step', file=sys.stderr)
                print(f"[rank0]: ValueError: bad batch {i}", file=sys.stderr)
            sys.stderr.flush()
            return n

    _wait_for(lambda: not burst_open(), desc="no burst open before the test")
    chatty = Writer.remote()
    try:
        assert rt.get(chatty.chat.remote(200), timeout=T) == 200
        _wait_for(lambda: state.get_log(grep="progress to stderr", limit=1000)["records"]
                  and len(state.get_log(grep="progress to stderr",
                                        limit=1000)["records"]) == 200,
                  desc="the 200 lines shipped")
        time.sleep(1.5)  # five watchdog ticks over them
        assert not burst_open(), state.list_incidents()
        assert not [e for e in state.list_events(source="log", limit=1000)
                    if "error burst" in e["message"]]
        failing = Writer.remote()
        try:
            assert rt.get(failing.fail.remote(20), timeout=T) == 20
            _wait_for(burst_open, desc="the traceback burst opened")
        finally:
            rt.kill(failing)
    finally:
        rt.kill(chatty)
