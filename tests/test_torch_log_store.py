"""The port's log plane against the JAX package's: the context stamps and
the rotation-safe tailer (``_private/log_plane.py``), the head's bounded
log store (``util/log_store.py``), the doctor's log rules, and, on the
port's CPU runtime, every consume surface: ``get_log``'s filters, the
trace join, driver streaming, a SIGKILL'd worker's stderr tail read from
the head, a job's log, a remote node's print and the ``logs`` command.

The cases are ``tests/test_log_plane.py``'s.  The pure ones feed the same
inputs (lines, file operations, seeded records at fixed timestamps) to
both packages and hold the results equal: exact for lines, sources,
sequence numbers, counts and events; a shipped record's wall-clock
timestamp is the one field left out, since each tailer stamps its own
read.  No JAX runtime starts; the live cases run one port cluster (a
head and a real node agent) under a private ``TMPDIR``, and every test
has its own time limit.
"""

import contextlib
import io
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

from ray_tpu._private import log_plane as jax_lp
from ray_tpu.util import doctor as jax_doctor
from ray_tpu.util import log_store as jax_ls
from ray_tpu_torch._private import log_plane as lp
from ray_tpu_torch.util import doctor
from ray_tpu_torch.util import log_store as ls

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_700_000_000.0
LIMIT = 120  # seconds: each test's own limit
T = 60  # seconds: every wait on the runtime


@pytest.fixture(autouse=True)
def time_limit(request):
    def expired(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past its {LIMIT} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old if old is not None else signal.SIG_DFL)


def _wait_for(fn, timeout=T, interval=0.1):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = fn()
        if v:
            return v
        time.sleep(interval)
    raise AssertionError(f"condition not met within {timeout}s: {fn}")


# -- the stamp protocol --------------------------------------------------------

@pytest.mark.parametrize("line,default", [
    ("plain", "e"), ("plain", "o"), ("\x1frt1|broken", "o"), ("", "o"),
    ("\x1frt1|W|j1|t1|a1|tr1\x1ftext with | bars", "o"), ("a\x1fb", "e")])
def test_parse_line_matches_jax(line, default):
    assert lp.parse_line(line, default) == jax_lp.parse_line(line, default)


def test_stamp_roundtrip():
    s = lp.format_stamp("o") + "hello world"
    src, job, task, actor, trace, text = lp.parse_line(s)
    assert src == "o" and text == "hello world"
    assert lp.parse_line(s) == jax_lp.parse_line(s)
    assert lp.parse_line("plain", "e") == ("e", "", "", "", "", "plain")
    assert lp.parse_line("\x1frt1|broken")[5] == "\x1frt1|broken"


def test_stamp_tracks_context_epoch():
    from ray_tpu_torch._private.worker import global_worker as gw

    old_task = gw.current_task_id
    try:
        gw.current_task_id = b"\xab\xcd"
        assert lp.parse_line(lp.format_stamp("o") + "x")[2] == "abcd"
        gw.current_task_id = b"\x12\x34"
        assert lp.parse_line(lp.format_stamp("o") + "x")[2] == "1234"
        gw.current_task_id = None
        assert lp.parse_line(lp.format_stamp("o") + "x")[2] == ""
    finally:
        gw.current_task_id = old_task


def _stamped_stream(mod, path, rotate=1 << 30):
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND)
    rot = mod._RotatingFile(path, rotate, fds=(fd,))
    return fd, mod.ContextStampingStream(fd, "o", rot)


def _both_streams(tmp_path, script, rotate=1 << 30):
    """Run ``script(stream)`` on each package's stamping stream; return
    each file's parsed lines (and the paths)."""
    out = []
    for name, mod in (("port", lp), ("jax", jax_lp)):
        path = str(tmp_path / f"{name}.log")
        fd, st = _stamped_stream(mod, path, rotate)
        try:
            script(st)
            st.flush()
        finally:
            os.close(fd)
        out.append(path)
    texts = [[lp.parse_line(ln) for ln in open(p).read().splitlines()] for p in out]
    assert texts[0] == texts[1]
    return texts[0], out


def test_stamping_stream_print_shapes(tmp_path):
    def script(st):
        print("one line", file=st)
        st.write("single call line\n")
        st.write("partial ")
        st.write("continued")
        st.write(" end\n")
        st.write("a\nb\nc\n")
        st.write("multi with tail\npartial2")

    parsed, _ = _both_streams(tmp_path, script)
    texts = [p[5] for p in parsed]
    assert texts == ["one line", "single call line", "partial continued end",
                     "a", "b", "c", "multi with tail", "partial2"]
    assert all(p[0] == "o" for p in parsed)
    assert not any("\x1f" in t for t in texts)


def test_stamping_stream_write_record(tmp_path):
    def script(st):
        st.write("partial print ")
        st.write_record("E", "logger error line")

    parsed, _ = _both_streams(tmp_path, script)
    assert parsed[0][5] == "partial print "
    assert parsed[1][0] == "E" and parsed[1][5] == "logger error line"


def test_rotating_file_caps_and_keeps_backup(tmp_path):
    def script(st):
        for i in range(200):
            st.write(f"line number {i:04d} with padding text\n")

    _, paths = _both_streams(tmp_path, script, rotate=2000)
    sizes = []
    for path in paths:
        assert os.path.exists(path + ".1")
        assert os.path.getsize(path) < 4000
        assert "line number 0199" in open(path + ".1").read() + open(path).read()
        sizes.append((os.path.getsize(path), os.path.getsize(path + ".1")))
    assert sizes[0] == sizes[1]


# -- the tailer ----------------------------------------------------------------

def _monitors(**kw):
    shipped = ([], [])
    mons = (lp.LogMonitor("test-node", ingest_fn=lambda o, recs, m: shipped[0].extend(recs), **kw),
            jax_lp.LogMonitor("test-node", ingest_fn=lambda o, recs, m: shipped[1].extend(recs),
                              **kw))
    return mons, shipped


def _no_ts(recs):
    return [r[1:] for r in recs]


def _drive(tmp_path, steps, **kw):
    """Apply the same file operations under each package's tailer; the
    shipped records (their timestamps aside) must be equal."""
    mons, shipped = _monitors(**kw)
    paths = [str(tmp_path / f"{name}.log") for name in ("port", "jax")]
    for mon, path in zip(mons, paths):
        mon.register("w", path, pid=123)
    results = []
    for step in steps:
        got = [step(mon, path) for mon, path in zip(mons, paths)]
        assert got[0] == got[1], step
        results.append(got[0])
    assert _no_ts(shipped[0]) == _no_ts(shipped[1])
    return shipped[0], results


def _append(text):
    def step(mon, path):
        with open(path, "a") as f:
            f.write(text)
    return step


def _poll(now=None):
    return lambda mon, path: mon.poll_once(now=now) if now is not None else mon.poll_once()


def test_monitor_tails_and_parses(tmp_path):
    shipped, res = _drive(tmp_path, [_append(lp.format_stamp("o") + "hello\nunstamped\n"),
                                     _poll(), _poll()])
    assert res[1] == 2 and res[2] == 0
    assert shipped[0][lp.REC_LINE] == "hello" and shipped[1][lp.REC_SRC] == "o"


def test_monitor_survives_rotation_without_loss(tmp_path):
    def rotate(mon, path):
        os.replace(path, path + ".1")

    shipped, _ = _drive(tmp_path, [
        _append("".join(f"pre {i}\n" for i in range(10))), _poll(),
        _append("old tail line\n"), rotate,
        _append("".join(f"post {i}\n" for i in range(5))), _poll(), _poll()])
    assert [r[lp.REC_LINE] for r in shipped] == (
        [f"pre {i}" for i in range(10)] + ["old tail line"] + [f"post {i}" for i in range(5)])


def test_monitor_rotation_terminates_partial_line(tmp_path):
    def rotate(mon, path):
        os.replace(path, path + ".1")

    shipped, _ = _drive(tmp_path, [_append("no newline yet"), _poll(), rotate,
                                   _append("new file line\n"), _poll(), _poll()])
    assert [r[lp.REC_LINE] for r in shipped] == ["no newline yet", "new file line"]


def test_monitor_survives_truncation(tmp_path):
    shipped, _ = _drive(tmp_path, [_append("a\nb\n"), _poll(),
                                   lambda mon, path: os.truncate(path, 0), _poll(),
                                   _append("after truncate\n"), _poll()])
    assert [r[lp.REC_LINE] for r in shipped] == ["a", "b", "after truncate"]


def test_monitor_rate_limit_suppression_marker(tmp_path):
    polled = {}

    def first(mon, path):  # right after registration: one second's budget
        polled[id(mon)] = time.time()
        return mon.poll_once(now=polled[id(mon)])

    def later(mon, path):  # a quiet 2 s later: the bucket has refilled
        return mon.poll_once(now=polled[id(mon)] + 2.0)

    shipped, _ = _drive(tmp_path, [_append("".join(f"spam {i}\n" for i in range(100))),
                                   first, _append("after storm\n"), later], rate_lps=5)
    assert len([r for r in shipped if r[lp.REC_SRC] != "m"]) == 6
    markers = [r for r in shipped if r[lp.REC_SRC] == "m"]
    assert len(markers) == 1 and "(suppressed 95 lines)" in markers[0][lp.REC_LINE]
    assert shipped[-1][lp.REC_LINE] == "after storm"


def test_monitor_unregister_final_drain(tmp_path):
    def unregister(mon, path):
        mon.unregister("w")
        return mon.streams()

    shipped, res = _drive(tmp_path, [_poll(), _append("last words\nFatal: dying now"),
                                     unregister])
    assert [r[lp.REC_LINE] for r in shipped] == ["last words", "Fatal: dying now"]
    assert "w" not in res[2]


# -- the store (pure, synthetic time) -------------------------------------------

def _rec(stream, line, src="o", job="", task="", actor="", trace="", ts=T0):
    return (ts, stream, src, job, task, actor, trace, line)


def _stores(**kw):
    events = ([], [])
    return (ls.LogStore(emit_fn=lambda *a, **k: events[0].append((a, k)), **kw),
            jax_ls.LogStore(emit_fn=lambda *a, **k: events[1].append((a, k)), **kw)), events


def _both(stores, fn):
    outs = [fn(s) for s in stores]
    assert outs[0] == outs[1], outs
    return outs[0]


def test_store_ingest_query_filters():
    stores, _ = _stores(max_lines_per_stream=100, max_total_bytes=1 << 20, max_streams=10)
    batch = [_rec("w1", "alpha", job="j1", task="t1"),
             _rec("w1", "beta error", src="e", job="j1", task="t2"),
             _rec("w2", "gamma", job="j2", trace="tr9")]
    by_job = _both(stores, lambda s: s.ingest("node-1", batch,
                                              metas={"w1": {"pid": 11}, "w2": {"pid": 22}},
                                              now=T0))
    assert set(by_job) == {"j1", "j2"}
    rows, cursor = _both(stores, lambda s: s.query(task="t1"))
    assert [r["line"] for r in rows] == ["alpha"] and cursor == 3
    rows, _ = _both(stores, lambda s: s.query(errors=True))
    assert [r["line"] for r in rows] == ["beta error"]
    rows, _ = _both(stores, lambda s: s.query(grep="GAMMA"))
    assert rows and rows[0]["stream"] == "w2" and rows[0]["pid"] == 22
    assert len(_both(stores, lambda s: s.query(trace="tr9"))[0]) == 1
    _both(stores, lambda s: s.ingest("node-1", [_rec("w1", "delta", job="j1")], now=T0 + 1))
    rows, c2 = _both(stores, lambda s: s.query(since_seq=cursor))
    assert [r["line"] for r in rows] == ["delta"] and c2 == 4


def test_store_caps_and_retirement():
    stores, _ = _stores(max_lines_per_stream=5, max_total_bytes=1 << 20, max_streams=10)
    _both(stores, lambda s: s.ingest("n", [_rec("w", f"line {i}") for i in range(20)], now=T0))
    rows, _ = _both(stores, lambda s: s.query(stream="w", limit=100))
    assert len(rows) == 5 and rows[0]["line"] == "line 15"
    assert _both(stores, lambda s: s.stats())[0]["total_lines"] == 20
    for s in stores:
        s.retire("w")
    assert _both(stores, lambda s: s.tail_text("w", n=2)) == ["line 18", "line 19"]
    assert _both(stores, lambda s: s.retire_stale(0.0, now=T0 + 10)) == ["w"]
    assert all("w" not in s for s in stores)


def test_store_byte_pressure_sheds_oldest():
    stores, _ = _stores(max_lines_per_stream=10_000, max_total_bytes=3000, max_streams=10)
    _both(stores, lambda s: s.ingest("n", [_rec("quiet", "x" * 100) for _ in range(20)],
                                     now=100.0))
    _both(stores, lambda s: s.ingest("n", [_rec("busy", "y" * 100) for _ in range(20)],
                                     now=200.0))
    rows = {r["stream"]: r for r in _both(stores, lambda s: s.stats())}
    assert rows["quiet"]["lines"] < rows["busy"]["lines"]


def test_store_error_burst_emits_event():
    """Six stderr lines that carry ``ERROR`` make one burst in both
    stores (the JAX store counts any stderr line, the port's those with
    an error marker: here both count all six), and a second six inside
    the window make none."""
    stores, events = _stores(max_lines_per_stream=1000, max_total_bytes=1 << 20,
                             max_streams=10, burst_n=5, burst_window_s=30.0)
    _both(stores, lambda s: s.ingest("n", [_rec("w", f"ERROR err {i}", src="e")
                                           for i in range(6)], now=T0))
    assert events[0] == events[1] and len(events[0]) == 1
    (source, message), kw = events[0][0]
    assert source == "log" and "error burst" in message and kw["entity_id"] == "w"
    _both(stores, lambda s: s.ingest("n", [_rec("w", f"ERROR err2 {i}", src="e")
                                           for i in range(6)], now=T0 + 1))
    assert events[0] == events[1] and len(events[0]) == 1


@pytest.mark.parametrize("line,port_bursts", [
    ("step 3: loss 0.25", False), ("warning: slow batch", False),
    ("error without a level word", False), ("ERROR:root:bad batch", True),
    ("2026-10-18 05:00:00 CRITICAL disk full", True), ("FATAL: cuda lost", True),
    ("Traceback (most recent call last):", True),
    ("[rank0]: Traceback (most recent call last):", True)])
def test_a_stderr_line_bursts_only_with_an_error_marker(line, port_bursts):
    """The one difference from the JAX store (ROADMAP C13): six such
    stderr lines make a burst in the JAX store always, in the port's only
    when they carry an error level word or a traceback head (behind a
    rank prefix too).  Every read (``errors=True`` included) stays
    equal."""
    stores, events = _stores(max_lines_per_stream=1000, max_total_bytes=1 << 20,
                             max_streams=10, burst_n=5, burst_window_s=30.0)
    _both(stores, lambda s: s.ingest("n", [_rec("w", line, src="e") for _ in range(6)],
                                     now=T0))
    assert len(events[1]) == 1 and len(events[0]) == int(port_bursts)
    assert ls.burst_line("e", line) == (port_bursts, "Traceback" in line)
    rows = _both(stores, lambda s: s.query(errors=True))
    assert len(rows[0]) == 6
    _both(stores, lambda s: s.counters())


@pytest.mark.parametrize("prefix", ["", "[rank0]: "])
def test_every_line_of_a_stderr_traceback_counts(prefix):
    """C13: on stderr, a traceback's head, its indented frames and the
    exception that ends it each count toward a burst, behind a
    launcher's rank prefix too; the plain line after it does not.  A
    stdout record leaves the stream's traceback open."""
    lines = [("Traceback (most recent call last):", True, True),
             ('  File "train.py", line 7, in step', True, True),
             ("    loss = model(batch)", True, True),
             ("RuntimeError: CUDA error: an illegal memory access", True, False),
             ("step 8: loss 0.25", False, False)]
    state = False
    for line, counts, after in lines:
        assert ls.burst_line("e", prefix + line, state) == (counts, after), line
        state = after
    assert ls.burst_line("o", "step 9", True) == (False, True)
    events = []
    store = ls.LogStore(burst_n=4 * 3, burst_window_s=30.0,
                        emit_fn=lambda *a, **k: events.append(a))
    store.ingest("n", [_rec("w", prefix + line, src="e") for _ in range(3)
                       for line, _, _ in lines], now=T0)
    assert len(events) == 1 and "12 error/traceback lines" in events[0][1]


def test_store_defaults_match_jax():
    port, ref = ls.LogStore(), jax_ls.LogStore()
    keys = ("max_lines_per_stream", "max_total_bytes", "max_streams", "burst_n",
            "burst_window_s")
    assert [getattr(port, k) for k in keys] == [getattr(ref, k) for k in keys] == [
        10_000, 32 << 20, 512, 50, 30.0]


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_record_streams_give_equal_reads(seed):
    """2,000 seeded records from 12 streams (stdout, stderr, logger levels,
    tracebacks, suppression markers) under tight caps, with retirement
    and LRU eviction: every read of the two stores is equal — query under
    each filter, tail_text, counters, stats, and what retire_stale drops.
    The burst events differ only by C13's rule (see below)."""
    rng = np.random.default_rng(seed)
    caps = dict(max_lines_per_stream=150, max_total_bytes=60_000, max_streams=9,
                burst_n=4, burst_window_s=5.0)
    stores, events = _stores(**caps)
    # the burst events differ in one way (ROADMAP C13): the port counts a
    # stderr line only with an error marker or inside a traceback.  A
    # third JAX store fed the same records, with each stderr line the port
    # does not count relabelled stdout, emits exactly the port's events.
    # Whether a line is inside a traceback is its stream's state, read
    # from a fourth (port) store fed the records one at a time.
    relabelled_events = []
    relabelled = jax_ls.LogStore(emit_fn=lambda *a, **k: relabelled_events.append((a, k)),
                                 **caps)
    probe = ls.LogStore(**caps)

    def relabel(rec, metas, node, now):
        st = probe._streams.get(rec[1])
        counts, _ = ls.burst_line(rec[2], rec[7], st is not None and st.in_traceback)
        probe.ingest(node, [rec], metas, now=now)
        if rec[2] == "e" and not counts:
            return rec[:2] + ("o",) + rec[3:]
        return rec
    srcs = ["o", "o", "o", "e", "I", "W", "E", "C", "m"]
    names = [f"worker-{i:02d}" for i in range(12)]
    for k in range(40):
        now = T0 + 2.0 * k
        batch = []
        for _ in range(50):
            stream = names[int(rng.integers(len(names)))]
            src = srcs[int(rng.integers(len(srcs)))]
            u = rng.random()
            line = ("Traceback (most recent call last):" if u < 0.03
                    else f'  File "{stream}.py", line {int(rng.integers(100))}' if u < 0.06
                    else f"{stream} says {int(rng.integers(1_000_000))}")
            batch.append(_rec(stream, line, src=src, job=f"j{int(rng.integers(3))}",
                              task=f"t{int(rng.integers(20))}",
                              actor=f"a{int(rng.integers(4))}" if rng.random() < 0.3 else "",
                              trace=f"tr{int(rng.integers(5))}" if rng.random() < 0.2 else "",
                              ts=now))
        metas = {s: {"pid": 1000 + i} for i, s in enumerate(names)}
        _both(stores, lambda s: s.ingest("node-a" if k % 2 else "node-b", batch, metas, now=now))
        node = "node-a" if k % 2 else "node-b"
        relabelled.ingest(node, [relabel(r, metas, node, now) for r in batch], metas, now=now)
        if k % 7 == 3:
            victim = names[int(rng.integers(len(names)))]
            for s in (*stores, relabelled, probe):
                s.retire(victim)
    assert events[0] == relabelled_events and events[0]
    assert len(events[1]) > len(events[0])  # the JAX store also bursts on plain stderr
    for kw in ({}, {"errors": True}, {"job": "j1"}, {"task": "t3"}, {"actor": "a2"},
               {"trace": "tr4"}, {"grep": "SAYS 1"}, {"node": "node-a"}, {"pid": 1003},
               {"since_seq": 1500}, {"limit": 7}, {"stream": names[5], "errors": True}):
        _both(stores, lambda s: s.query(**kw))
    for name in names:
        _both(stores, lambda s: s.tail_text(name, n=20))
        _both(stores, lambda s: s.tail_text(name, n=20, errors_only=True))
    _both(stores, lambda s: s.counters())
    rows = _both(stores, lambda s: s.stats())
    assert len(rows) <= 9 and sum(r["bytes"] for r in rows) <= 60_000
    _both(stores, lambda s: s.retire_stale(10.0, now=T0 + 200.0))
    _both(stores, lambda s: s.stats())


@pytest.mark.parametrize("src,line", [("e", "x"), ("E", "x"), ("C", "x"), ("o", "x"),
                                      ("W", "Traceback (most recent call last):"),
                                      ("o", " Traceback (")])
def test_is_error_record_matches_jax(src, line):
    assert ls.is_error_record(src, line) == jax_ls.is_error_record(src, line)


def test_doctor_log_rules_fire_and_stay_silent():
    assert doctor.diagnose([], []) == jax_doctor.diagnose([], []) == []
    burst = {"source": "log", "severity": "WARNING",
             "message": "error burst: 60 error/traceback lines in 30s from worker-ab",
             "entity_id": "worker-ab"}
    death = {"source": "log", "severity": "ERROR",
             "message": "worker died with uncollected stderr: exited with code -9",
             "entity_id": "ab", "data": {"tail": ["Fatal: boom"]}}
    findings = doctor.diagnose([burst, death], [])
    # equal but for the remedy's command name
    assert [dict(f, remedy=f["remedy"].replace("ray_tpu_torch", "ray_tpu"))
            for f in findings] == jax_doctor.diagnose([burst, death], [])
    rules = {f["rule"]: f for f in findings}
    assert "worker-ab" in rules["log_error_burst"]["summary"]
    assert rules["worker_stderr_at_death"]["severity"] == "ERROR"
    assert "Fatal: boom" in rules["worker_stderr_at_death"]["summary"]
    quiet = {"source": "log", "severity": "DEBUG", "message": "log stream retired",
             "entity_id": "w"}
    assert doctor.diagnose([quiet], []) == []


def test_disabled_plane_keeps_plain_capture(tmp_path):
    code = ("import sys\n"
            "from ray_tpu_torch._private.log_plane import redirect_process_output\n"
            f"redirect_process_output({str(tmp_path / 'cap.log')!r})\n"
            "print('disabled-path line')\n"
            "sys.stdout.flush()\n")
    env = dict(os.environ, RAY_TPU_TORCH_LOG_PLANE="0")
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=60, cwd=ROOT)
    content = open(tmp_path / "cap.log").read()
    assert "disabled-path line" in content and "\x1f" not in content


# -- live: the consume surfaces on a port cluster ------------------------------

@pytest.fixture(scope="module")
def log_cluster():
    """A port head (4 CPUs) and one real node agent (2 CPUs), shipping
    logs every 0.1 s (the workers and the agent inherit the env)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster

    with tempfile.TemporaryDirectory(prefix="logs_") as d, pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMPDIR", d)
        mp.setattr(tempfile, "tempdir", d)
        mp.setenv("RAY_TPU_TORCH_LOG_SHIP_S", "0.1")
        cluster = Cluster(initialize_head=True, real_processes=True,
                          head_node_args={"num_cpus": 4})
        try:
            cluster.agent_node = cluster.add_node(num_cpus=2)
            yield rt, cluster
        finally:
            cluster.shutdown()


def _state():
    from ray_tpu_torch.experimental.state import api as state

    return state


def test_worker_print_correlated_end_to_end(log_cluster):
    rt, _ = log_cluster
    state = _state()

    @rt.remote
    def chatty():
        print("needle-from-task")
        return rt.get_runtime_context().task_id

    task_id = rt.get(chatty.remote(), timeout=T).hex()
    rows = _wait_for(lambda: state.get_log(grep="needle-from-task")["records"])
    r = rows[0]
    assert r["task"] == task_id and r["stream"].startswith("worker-") and r["src"] == "o"
    assert state.get_log(task=task_id)["records"]
    assert r["stream"] in {row["stream"] for row in state.list_logs()}


def test_actor_stderr_and_logger_records(log_cluster):
    rt, _ = log_cluster
    state = _state()

    @rt.remote
    class Talker:
        def speak(self):
            print("to-stderr-needle", file=sys.stderr)
            from ray_tpu_torch._private.logging_utils import get_logger

            get_logger("ray_tpu_torch.testmod").warning("logger-needle")
            return rt.get_runtime_context().actor_id

    a = Talker.remote()
    actor_id = rt.get(a.speak.remote(), timeout=T).hex()
    err = _wait_for(lambda: state.get_log(grep="to-stderr-needle", errors=True)["records"])
    assert err[0]["actor"] == actor_id
    logged = _wait_for(lambda: state.get_log(grep="logger-needle")["records"])
    assert logged[0]["src"] == "W"
    assert state.get_log(actor=actor_id)["records"]
    rt.kill(a)


def test_trace_join(log_cluster):
    rt, _ = log_cluster
    state = _state()
    from ray_tpu_torch.util import tracing

    @rt.remote
    def traced_work():
        print("trace-needle-line")
        return 1

    with tracing.trace("log-join-test") as ctx:
        rt.get(traced_work.remote(), timeout=T)
    trace_id = ctx["trace_id"]
    rows = _wait_for(lambda: state.get_log(trace=trace_id)["records"])
    assert any("trace-needle-line" in r["line"] for r in rows)
    trace = _wait_for(lambda: (lambda t: t if t and t.get("logs") else None)(
        state.get_trace(trace_id)))
    assert any("trace-needle-line" in r["line"] for r in trace["logs"])


def test_driver_stream_and_follow_cursor(log_cluster):
    rt, _ = log_cluster
    state = _state()
    from ray_tpu_torch._private.log_plane import make_driver_log_callback
    from ray_tpu_torch._private.worker import global_worker

    got = []
    global_worker.client.subscribe(f"logs:{global_worker.job_id}",
                                   make_driver_log_callback(out_fn=got.append))

    @rt.remote
    def noisy():
        print("driver-stream-needle")

    rt.get(noisy.remote(), timeout=T)
    _wait_for(lambda: any("driver-stream-needle" in s for s in got))
    line = next(s for s in got if "driver-stream-needle" in s)
    assert line.startswith("(worker-") and "pid=" in line and "node=" in line
    cursor = state.get_log(grep="driver-stream-needle")["cursor"]
    rt.get(noisy.remote(), timeout=T)
    fresh = _wait_for(lambda: state.get_log(grep="driver-stream-needle",
                                            since_seq=cursor)["records"])
    assert all(r["seq"] > cursor for r in fresh)


@pytest.mark.parametrize("where", ["head", "agent"])
def test_sigkill_worker_stderr_retrievable_after_death(log_cluster, where):
    """A SIGKILL'd worker's last stderr lines are read back from the head
    after the process is gone, on the head's node and on the agent's;
    its stream shows ``retired``."""
    rt, cluster = log_cluster
    state = _state()
    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

    node = "node-head" if where == "head" else cluster.agent_node
    needle = f"final-stderr-needle-{where}"

    @rt.remote(max_retries=0)
    def doomed(text):
        print(text, "before the bullet", file=sys.stderr)
        sys.stderr.flush()
        os.kill(os.getpid(), 9)

    with pytest.raises(Exception):
        rt.get(doomed.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
            rt.get_runtime_context().node_id if where == "head" else node,
            soft=False)).remote(needle), timeout=T)
    rows = _wait_for(lambda: state.get_log(grep=needle, errors=True)["records"])
    stream = rows[0]["stream"]
    meta = _wait_for(lambda: [s for s in state.list_logs()
                              if s["stream"] == stream and s["retired"]])[0]
    assert meta["retired"]
    assert any(needle in ln for ln in state.tail_log(stream, n=50, errors=True))


def test_job_logs_unified_surface(log_cluster):
    rt, cluster = log_cluster
    state = _state()
    from ray_tpu_torch.job_submission import JobSubmissionClient

    client = JobSubmissionClient()
    try:
        job_id = client.submit_job(entrypoint=f"{sys.executable} -c "
                                              "\"print('job-driver-needle')\"")
        assert client.wait_until_finish(job_id, timeout=T) == "SUCCEEDED"
        rows = _wait_for(lambda: state.get_log(stream=f"job-{job_id}", limit=1000)["records"])
        assert any("job-driver-needle" in r["line"] for r in rows)
        assert "job-driver-needle" in client.get_job_logs(job_id)
        streams = {r["stream"]: r for r in state.list_logs()}
        assert streams[f"job-{job_id}"]["job"] == job_id
    finally:
        client.close()


def test_cross_node_print_reaches_head_and_driver(log_cluster, capsys):
    rt, cluster = log_cluster
    state = _state()
    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

    node_b = cluster.agent_node

    @rt.remote(scheduling_strategy=NodeAffinitySchedulingStrategy(node_b))
    class RemoteTalker:
        def speak(self):
            print("cross-node-needle")
            return rt.get_runtime_context().node_id

    a = RemoteTalker.remote()
    assert rt.get(a.speak.remote(), timeout=T) == node_b
    rows = _wait_for(lambda: state.get_log(grep="cross-node-needle")["records"])
    assert rows[0]["node"] == node_b and rows[0]["actor"]
    chunks = []

    def saw_line():
        chunks.append(capsys.readouterr().out)
        return [ln for ln in "".join(chunks).splitlines()
                if "cross-node-needle" in ln and ln.startswith("(")]

    assert f"node={node_b}" in _wait_for(saw_line, timeout=15)[0]
    rt.kill(a)


def test_cli_logs_command(log_cluster):
    rt, _ = log_cluster
    state = _state()
    from ray_tpu_torch.scripts import cli

    @rt.remote
    def printer():
        print("cli-logs-needle")

    rt.get(printer.remote(), timeout=T)
    _wait_for(lambda: state.get_log(grep="cli-logs-needle")["records"])

    def run(*argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(list(argv))
        return buf.getvalue()

    table = run("logs")
    assert "STREAM" in table and "worker-" in table
    out = run("logs", "--grep", "cli-logs-needle")
    assert "cli-logs-needle" in out and out.strip().startswith("(worker-")
