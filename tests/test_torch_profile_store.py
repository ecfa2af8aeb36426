"""The port's continuous-profiling plane against the JAX package's: the
sampler's frame folding (``_private/sampling_profiler.py``), the head's
profile store and its cost ledger (``util/profile_store.py``), the
duty-cycled lock timing (``_private/locks.py``), and, on the port's CPU
runtime, every process's profile reaching the head.

The cases are ``tests/test_continuous_profiling.py``'s.  The pure ones
feed the same inputs (the same frames, the same seeded buckets at fixed
timestamps) to both packages' functions and hold every result equal:
exact for counts, ids, stacks and classes, floats within 1e-9 relative.
Each keeps the JAX test's own checks on the port's results.  No JAX
runtime starts; the live cases run the port's runtime under a private
``TMPDIR``, and every test has its own time limit.
"""

import collections
import os
import signal
import sys
import tempfile
import threading
import time

import numpy as np
import pytest

from ray_tpu._private import locks as jax_locks
from ray_tpu._private import sampling_profiler as jax_sp
from ray_tpu.util import profile_store as jax_ps
from ray_tpu_torch._private import locks
from ray_tpu_torch._private import sampling_profiler as sp
from ray_tpu_torch.util import profile_store as ps

T0 = 1_700_000_000.0  # aligned epoch: bucket math must be deterministic
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


def _same(port, ref):
    """Equal results: exact for everything, floats within 1e-9 relative."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and set(port) == set(ref), (port, ref)
        for k in ref:
            _same(port[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert type(port) is type(ref) and len(port) == len(ref), (port, ref)
        for a, b in zip(port, ref):
            _same(a, b)
    elif isinstance(ref, float):
        assert port == pytest.approx(ref, rel=1e-9, abs=0.0), (port, ref)
    else:
        assert port == ref, (port, ref)


def _stores(**kw):
    return ps.ProfileStore(**kw), jax_ps.ProfileStore(**kw)


def _both(stores, fn):
    outs = [fn(s) for s in stores]
    _same(outs[0], outs[1])
    return outs[0]


def _bucket(ts, folded, ticks=100.0, busy=50.0):
    return {"ts": ts, "folded": dict(folded), "ticks": ticks,
            "busy_ticks": busy}


# -- frame folding and classification ----------------------------------------

def _deep_frame(depth):
    if depth:
        return _deep_frame(depth - 1)
    return sys._getframe()


@pytest.mark.parametrize("depth,max_depth", [(60, 24), (60, 128), (0, 64), (5, 3)],
                         ids=["deep", "deep_uncut", "shallow", "tiny_cap"])
def test_fold_frame_matches_jax(depth, max_depth):
    """The same frame folds to the same string in both packages: deep
    stacks keep their root-most and leaf-most frames around a mid-stack
    marker, shallow ones stay whole."""
    frame = _deep_frame(depth)
    folded = sp.fold_frame(frame, max_depth)
    assert folded == jax_sp.fold_frame(frame, max_depth)
    assert sp.TRUNCATION_MARKER == jax_sp.TRUNCATION_MARKER
    parts = folded.split("|")
    assert parts[-1].endswith(":_deep_frame")
    if depth == 60 and max_depth == 24:
        shallow_root = sp.fold_frame(sys._getframe(), 128).split("|")[0]
        assert len(parts) == 24 and sp.TRUNCATION_MARKER in parts
        assert parts[0] == shallow_root
        i = parts.index(sp.TRUNCATION_MARKER)
        assert 0 < i < len(parts) - 1 and parts[i + 1].endswith(":_deep_frame")
    whole = len(sp.fold_frame(frame, 10_000).split("|"))
    if whole <= max_depth:
        assert sp.TRUNCATION_MARKER not in parts and len(parts) == whole
    else:
        assert sp.TRUNCATION_MARKER in parts and len(parts) == max_depth


_FILES = ("a.py", "node.py", "pickle.py", "serialization.py", "locks.py", "worker.py",
          "client.py", "api.py", "selectors.py", "socket.py", "threading.py", "user.py",
          "wire.py", "copyreg.py", "struct.py", "actor.py", "sharding.py")
_FUNCS = ("f", "wait", "select", "dumps", "save", "_handle", "recv", "get", "run", "step",
          "sleep", "readinto", "_timed_acquire", "poll")


def _seeded_stacks(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        depth = int(rng.integers(1, 7))
        out.append("|".join(f"{_FILES[rng.integers(len(_FILES))]}:"
                            f"{_FUNCS[rng.integers(len(_FUNCS))]}" for _ in range(depth)))
    return out


def test_classify_stack_matches_jax():
    """The JAX test's stacks, torch's own frames, and 500 seeded stacks
    fall in the same class in both packages (the table matches file
    basenames, so torch/serialization.py counts as serialize)."""
    cases = {
        "a.py:f|selectors.py:select": "idle",
        "a.py:f|threading.py:wait": "idle",
        "node.py:dispatch|pickle.py:dumps": "serialize",
        "client.py:request|node.py:_handle": "dispatch",
        "locks.py:_timed_acquire": "lock_wait",
        "mymodel.py:train_step": "other",
        # what a pipeline stage's stacks hold in the port
        "worker.py:_execute_task|serialization.py:save|serialization.py:_save": "serialize",
        "worker.py:_execute_task|gpt2.py:forward|functional.py:linear": "exec",
        "graph_module.py:__call__|node.py:map_arg": "dispatch",
        "worker.py:main|compiled.py:_loop|channel.py:read": "idle",
    }
    for stack, want in cases.items():
        assert ps.classify_stack(stack) == jax_ps.classify_stack(stack) == want, stack
    for stack in _seeded_stacks(500):
        assert ps.classify_stack(stack) == jax_ps.classify_stack(stack), stack
    assert ps.BUSY_CLASSES == jax_ps.BUSY_CLASSES
    assert (ps._CLASS_BY_FILE, ps._IDLE_LEAF_FUNCS, ps._IDLE_LEAF_FILES) == (
        jax_ps._CLASS_BY_FILE, jax_ps._IDLE_LEAF_FUNCS, jax_ps._IDLE_LEAF_FILES)


def test_collapsed_from_report_matches_jax():
    rows = [{"stack": s, "samples": i + 1} for i, s in enumerate(_seeded_stacks(30, seed=1))]
    assert sp.collapsed_from_report(rows) == jax_sp.collapsed_from_report(rows)


# -- the store (pure, synthetic time) ------------------------------------------

def test_store_query_window_overlap():
    stores = _stores(bucket_s=60.0)
    for st in stores:
        st.ingest("w1", [_bucket(T0, {"a.py:f|b.py:g": 10})], now=T0)
    q = _both(stores, lambda st: st.query(5.0, now=T0 + 30.0))
    assert q["samples"] == 10 and q["origins"] == ["w1"]
    assert _both(stores, lambda st: st.query(5.0, now=T0 - 90.0))["samples"] == 0


def test_store_byte_cap_decays_fine_to_coarse():
    stores = _stores(bucket_s=10.0, coarse_s=100.0, max_bytes_per_origin=4096,
                     coarse_top_k=5)
    for st in stores:
        for i in range(40):
            folded = {f"mod{i}.py:fn{j}|leaf{i}_{j}.py:hot": 3 for j in range(8)}
            st.ingest("w1", [_bucket(T0 + 10.0 * i, folded)], now=T0 + 10.0 * i)
    row = _both(stores, lambda st: st.stats(now=T0 + 400.0))[0]
    assert row["bytes"] <= 4096 and row["coarse_buckets"] >= 1
    q = _both(stores, lambda st: st.query(1e6, now=T0 + 400.0))
    assert "(decayed)" in q["folded"]
    assert q["samples"] == 40 * 8 * 3


def test_store_origin_lru_eviction():
    stores = _stores(max_origins=3)
    for st in stores:
        for i, name in enumerate(("a", "b", "c", "d")):
            st.ingest(name, [_bucket(T0, {"x.py:f": 1})], now=T0 + i)
    rows = _both(stores, lambda st: st.stats(now=T0 + 10))
    assert {r["origin"] for r in rows} == {"b", "c", "d"}


def test_store_prune_ages_fine_then_drops_coarse():
    stores = _stores(bucket_s=10.0, coarse_s=100.0, fine_retention_s=50.0,
                     coarse_retention_s=300.0)
    for st in stores:
        st.ingest("w1", [_bucket(T0, {"x.py:f": 5})], now=T0)
        st.prune(now=T0 + 100.0)
    row = _both(stores, lambda st: st.stats(now=T0 + 100.0))[0]
    assert row["buckets"] == 0 and row["coarse_buckets"] == 1
    assert _both(stores, lambda st: st.query(1e6, now=T0 + 100.0))["samples"] == 5
    for st in stores:
        st.prune(now=T0 + 1000.0)
    assert _both(stores, lambda st: st.query(1e6, now=T0 + 1000.0))["samples"] == 0


def test_store_retires_dead_origins():
    stores = _stores()
    retired = []
    for st in stores:
        st.ingest("alive", [_bucket(T0, {"x.py:f": 1})], now=T0)
        st.ingest("dead", [_bucket(T0, {"x.py:f": 1})], now=T0)
        st.ingest("alive", [_bucket(T0 + 100, {"x.py:f": 1})], now=T0 + 100)
        retired.append(st.retire_stale(60.0, now=T0 + 100.0))
    assert retired[0] == retired[1] == ["dead"]
    assert {r["origin"] for r in _both(stores, lambda st: st.stats(now=T0 + 100.0))} == {"alive"}


def test_store_diff_scales_baseline_to_recent_span():
    stores = _stores(bucket_s=10.0)
    for st in stores:
        for i in range(6):
            st.ingest("w1", [_bucket(T0 + 10.0 * i, {"a.py:f": 10})], now=T0 + 10.0 * i)
        st.ingest("w1", [_bucket(T0 + 60.0, {"b.py:g": 30})], now=T0 + 60.0)
    d = _both(stores, lambda st: st.diff(60.0, 10.0, now=T0 + 70.0))
    assert d["samples_a"] == 60 and d["samples_b"] == 30
    assert d["delta"]["a.py:f"] == pytest.approx(-10.0)
    assert d["delta"]["b.py:g"] == pytest.approx(30.0)
    lines = {}
    for ln in d["collapsed"].splitlines():
        stack, a, b = ln.rsplit(" ", 2)
        lines[stack] = (int(a), int(b))
    assert lines["a.py:f"] == (10, 0) and lines["b.py:g"] == (0, 30)


def test_store_cost_ledger_columns_sum_to_wall():
    stores = _stores(bucket_s=10.0)
    for st in stores:
        st.ingest("head", [_bucket(T0, {"node.py:_handle": 50, "pickle.py:dumps": 50},
                                   ticks=100.0, busy=100.0)],
                  meta={"lateness_frac": 0.0}, now=T0)
        st.ingest("w1", [_bucket(T0, {"worker.py:_main_loop|user.py:fn": 80},
                                 ticks=80.0, busy=80.0)], now=T0)
    led = _both(stores, lambda st: st.cost_ledger(
        10.0, tasks=1000, roles={"head": "head", "w1": "worker"}, now=T0 + 5.0))
    cols = led["columns"]
    assert led["per_task_wall_us"] == pytest.approx(10_000.0)
    assert led["sum_over_wall"] == pytest.approx(1.0, abs=0.01)
    assert cols["head_dispatch_us"] == pytest.approx(5000.0, rel=0.01)
    assert cols["serialize_us"] == pytest.approx(5000.0, rel=0.01)
    assert cols["worker_exec_us"] == 0.0
    assert led["overlapped_worker_cpu_us"] == pytest.approx(10_000.0, rel=0.01)
    for st in stores:
        st.ingest("head", [], meta={"lateness_frac": 0.5, "ticks": 0}, now=T0)
    led2 = _both(stores, lambda st: st.cost_ledger(10.0, tasks=1000, roles={"head": "head"},
                                                   now=T0 + 5.0))
    assert led2["columns"]["gil_wait_us"] > 0
    assert led2["sum_over_wall"] == pytest.approx(1.0, abs=0.01)


def test_store_class_rates_util_uses_busy_ticks():
    stores = _stores(bucket_s=10.0)
    for st in stores:
        st.ingest("w", [_bucket(T0, {"a.py:f": 400}, ticks=100.0, busy=30.0)], now=T0)
    r = _both(stores, lambda st: st.class_rates(100.0, origin="w", now=T0 + 5.0))
    assert r["raw_busy"] == pytest.approx(4.0) and r["util"] == pytest.approx(0.3)
    assert set(r["classes"]) == set(ps.BUSY_CLASSES)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_ingest_sequences_give_equal_queries(seed):
    """300 seeded batches from 6 origins over 40 minutes, with meta and
    byte pressure: every read of the two stores is equal — query, the
    collapsed lines, diff, stats, class rates, serialization share,
    the cost ledger, and the retirement of origins that stop."""
    rng = np.random.default_rng(seed)
    stacks = _seeded_stacks(60, seed=seed + 10)
    stores = _stores(bucket_s=30.0, coarse_s=300.0, max_bytes_per_origin=6000,
                     coarse_top_k=12, fine_retention_s=900.0, coarse_retention_s=1800.0)
    origins = ["head"] + [f"w{i}" for i in range(5)]
    batches = []
    for k in range(300):
        origin = origins[int(rng.integers(len(origins)))]
        ts = T0 + 8.0 * k
        folded = {stacks[int(i)]: int(rng.integers(1, 9))
                  for i in rng.integers(0, len(stacks), int(rng.integers(1, 8)))}
        ticks = float(rng.integers(10, 60))
        busy = float(rng.integers(0, int(ticks) + 1))
        meta = {"lateness_frac": round(float(rng.random()) * 0.4, 4), "ticks": ticks,
                "interval_s": 2.0, "period_s": 0.005}
        batches.append((origin, [_bucket(ts, folded, ticks, busy)], meta, ts + 1.0))
    for st in stores:
        for origin, buckets, meta, now in batches:
            st.ingest(origin, buckets, meta, now=now)
            if int(now) % 97 == 0:
                st.prune(now=now)
    now = T0 + 8.0 * 300
    roles = {"head": "head", "w0": "worker", "w1": "worker", "w2": "worker"}
    for window in (60.0, 600.0, 3600.0):
        _both(stores, lambda st: st.query(window, now=now))
        _both(stores, lambda st: st.query(window, origin="w1", now=now))
        _both(stores, lambda st: st.collapsed(window, now=now))
        _both(stores, lambda st: st.class_rates(window, now=now))
        _both(stores, lambda st: st.class_rates(window, origin="head", now=now))
        _both(stores, lambda st: st.serialization_frac(window, now=now))
        _both(stores, lambda st: st.cost_ledger(window, tasks=123, roles=roles, now=now))
    _both(stores, lambda st: st.diff(600.0, 120.0, now=now))
    _both(stores, lambda st: st.diff(600.0, 120.0, origin="w3", now=now))
    rows = _both(stores, lambda st: st.stats(now=now))
    assert rows and all(r["bytes"] <= 6000 for r in rows)
    _both(stores, lambda st: st.retire_stale(120.0, now=now))
    _both(stores, lambda st: st.stats(now=now))


# -- the sampler ---------------------------------------------------------------

def test_continuous_profiler_ships_into_store():
    """A busy thread's stacks reach the port's store with their duty
    denominators; the shipped meta carries the JAX sampler's keys."""
    st = ps.ProfileStore(bucket_s=1.0)
    p = sp.ContinuousProfiler("test-origin", ingest_fn=st.ingest, burst_s=0.03,
                              interval_s=0.05, period_s=0.002, ship_every_s=0.1)
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            sum(i * i for i in range(500))

    t = threading.Thread(target=spin, daemon=True)
    t.start()
    p.start()
    try:
        deadline = time.time() + 10.0
        while time.time() < deadline and st.query(60.0).get("samples", 0) == 0:
            time.sleep(0.05)
    finally:
        p.stop()
        stop.set()
        t.join(timeout=2.0)
    q = st.query(60.0)
    assert q["samples"] > 0 and q["origins"] == ["test-origin"] and q["ticks"] > 0
    assert st.stats()[0]["period_s"] == pytest.approx(0.002)
    ref = jax_sp.ContinuousProfiler("ref", ingest_fn=lambda *a: None)
    _, meta = p.drain()
    _, ref_meta = ref.drain()
    assert set(meta) == set(ref_meta)


def test_continuous_profiler_backoff_and_reset_match_jax():
    """The same burst fingerprints move both samplers' intervals alike:
    static stacks double the interval up to its cap, a change resets it."""
    port = sp.ContinuousProfiler("t", ingest_fn=lambda *a, **k: None, interval_s=0.5,
                                 max_interval_s=4.0)
    ref = jax_sp.ContinuousProfiler("t", ingest_fn=lambda *a, **k: None, interval_s=0.5,
                                    max_interval_s=4.0)
    seq = [collections.Counter({"a.py:f|b.py:wait": 5})] * 6 + [
        collections.Counter({"a.py:f|c.py:work": 5})] + [
        collections.Counter({"a.py:f|c.py:work": 5})] * 3
    intervals = []
    for c in seq:
        port._adapt(c)
        ref._adapt(c)
        assert port._cur_interval == ref._cur_interval
        intervals.append(port._cur_interval)
    assert max(intervals[:6]) > 0.5 and intervals[6] == 0.5


@pytest.mark.parametrize("knob", ["0", "false", "no", "1", ""])
def test_the_profiler_switch_under_the_ports_prefix(monkeypatch, knob):
    monkeypatch.setenv("RAY_TPU_TORCH_CONT_PROFILE", knob)
    monkeypatch.setenv("RAY_TPU_CONT_PROFILE", knob)
    assert sp.continuous_enabled() == jax_sp.continuous_enabled() == (
        knob not in ("0", "false", "no"))


def test_interval_knob_and_constant_duty(monkeypatch):
    """``RAY_TPU_TORCH_CONT_PROFILE_INTERVAL_S`` sets the burst interval
    as the JAX knob does; the burst length and period are the JAX
    defaults, taken from the constructor."""
    monkeypatch.setenv("RAY_TPU_TORCH_CONT_PROFILE_INTERVAL_S", "0.2")
    monkeypatch.setenv("RAY_TPU_CONT_PROFILE_INTERVAL_S", "0.2")
    port = sp.ContinuousProfiler("t", ingest_fn=lambda *a: None)
    ref = jax_sp.ContinuousProfiler("t", ingest_fn=lambda *a: None)
    assert (port.interval_s, port.burst_s, port.period_s, port.max_interval_s) == (
        ref.interval_s, ref.burst_s, ref.period_s, ref.max_interval_s) == (0.2, 0.05, 0.005, 1.6)


# -- lock timing ---------------------------------------------------------------

def test_timed_lock_hammer_measures_contention():
    locks.reset_lock_stats()
    lk = locks.make_lock("test.hammer")
    assert type(lk).__name__ == "_TimedLock"
    locks.arm_timing(True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    n = 20_000

    def hammer():
        for _ in range(n):
            with lk:
                pass

    try:
        ths = [threading.Thread(target=hammer) for _ in range(4)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
    finally:
        sys.setswitchinterval(old)
        locks.arm_timing(None)
    row = locks.lock_stats()["test.hammer"]
    assert set(row) == set(jax_locks._stat_row("test.parity_keys"))
    assert row["contended"] > 0 and row["wait_s"] > 0 and row["hold_s"] > 0
    assert row["max_wait_s"] > 0
    raw = row["acquires"] / locks.timing_scale()
    assert raw == pytest.approx(4 * n, rel=0.15)


def test_timed_lock_disarmed_is_passthrough():
    locks.reset_lock_stats()
    locks.arm_timing(False)
    try:
        lk = locks.make_lock("test.quiet")
        for _ in range(500):
            with lk:
                pass
        assert locks.lock_stats()["test.quiet"]["acquires"] == 0
        assert lk.acquire() is True
        assert lk.acquire(False) is False
        lk.release()
        assert lk.locked() is False
    finally:
        locks.arm_timing(None)


def _lock_finding(name, row):
    """The doctor's ``lock_contention`` rule over one lock's row, read as
    the gauges' growth from zero."""
    from ray_tpu_torch.util import doctor

    tags = {"lock": name}
    series = {m: [{"tags": tags, "points": [(0.0, 0.0), (1.0, row[k])]}]
              for m, k in (("ray_tpu_lock_wait_s", "wait_s"), ("ray_tpu_lock_hold_s", "hold_s"))}
    return doctor._trend_rule_lock_contention(series)


def test_a_long_hold_is_not_read_as_a_convoy():
    """One thread holds the lock 0.6 s; another starts to wait on it in a
    0.05 s armed window.  Each counts only its part inside that window,
    the holder's hold too, so the rows show one waiter behind one hold
    and the doctor sees no convoy (the JAX timing counts the whole wait,
    scaled by wall/armed, against the waiter's own hold alone: ROADMAP
    C10)."""
    locks.arm_timing(False)
    locks.reset_lock_stats()
    lk = locks.make_lock("test.long_hold")
    got = threading.Event()

    def waiter():
        with lk:
            got.set()
    try:
        locks.arm_timing(True)
        lk.acquire()
        th = threading.Thread(target=waiter)
        th.start()
        time.sleep(0.05)
        locks.arm_timing(False)
        time.sleep(0.55)
        lk.release()
        assert got.wait(10)
        th.join(10)
        row = locks.lock_stats()["test.long_hold"]
        scale = locks.timing_scale()
    finally:
        locks.arm_timing(None)
    assert row["contended"] >= 1 and row["max_wait_s"] > 0.4  # the whole wait, raw
    assert _lock_finding("test.long_hold", row) is None, row
    assert row["max_hold_s"] > 0.5
    assert row["wait_s"] <= 0.1 * scale and row["hold_s"] >= 0.03 * scale
    assert row["wait_s"] < 2.0 * row["hold_s"]


def test_a_convoy_is_still_read_as_one():
    """Four threads queue on a lock each holds 10 ms, stepping out 1 ms
    between holds: about three wait behind every hold, and the doctor's
    ``lock_contention`` says so."""
    locks.reset_lock_stats()
    lk = locks.make_lock("test.convoy")

    def worker():
        for _ in range(20):
            with lk:
                time.sleep(0.01)
            time.sleep(0.001)  # let a waiter in before the next acquire
    locks.arm_timing(True)
    try:
        ths = [threading.Thread(target=worker) for _ in range(4)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        row = locks.lock_stats()["test.convoy"]
    finally:
        locks.arm_timing(None)
    assert row["hold_s"] >= 4 * 20 * 0.01 * 0.9
    assert row["wait_s"] >= 2.0 * row["hold_s"], row
    finding = _lock_finding("test.convoy", row)
    assert finding is not None and finding["rule"] == "lock_contention"


def test_a_hold_that_began_before_the_window_counts_from_its_open():
    """A hold taken while timing was off is still under way when the
    window opens, and a thread waits behind it there.  The window opens
    on held locks: that hold counts from the open, so the rows show one
    waiter behind one hold, not a wait behind no hold at all (the JAX
    timing counts such a hold nowhere)."""
    locks.arm_timing(False)
    locks.reset_lock_stats()
    lk = locks.make_lock("test.open_hold", rlock=True)
    waiting, got = threading.Event(), threading.Event()

    def waiter():
        waiting.set()
        with lk:
            got.set()
    try:
        lk.acquire()  # untimed: the window is shut
        locks.arm_timing(True)
        th = threading.Thread(target=waiter)
        th.start()
        assert waiting.wait(10)
        time.sleep(0.1)
        lk.release()
        assert got.wait(10)
        th.join(10)
        row = locks.lock_stats()["test.open_hold"]
    finally:
        locks.arm_timing(None)
    assert row["contended"] == 1 and row["hold_s"] >= 0.09, row
    assert row["wait_s"] < 2.0 * row["hold_s"], row
    scaled = {k: v * 20 for k, v in row.items()}  # past LOCK_WAIT_MIN_S
    assert _lock_finding("test.open_hold", scaled) is None, row


def test_a_waiters_turn_for_the_gil_after_the_release_is_no_lock_wait():
    """The holder releases after 10 ms and keeps the GIL 40 ms more (a
    long switch interval), so the waiter returns from its acquire 50 ms
    after it began.  Only the 10 ms the lock was held count as its wait:
    the rest is the GIL's, which ``gil_saturation`` reads.  With the wait
    counted to the acquire's return, as the JAX timing counts it, the
    doctor would read 25 waits of one thread as a convoy."""
    locks.reset_lock_stats()
    lk = locks.make_lock("test.handoff")
    ready, done = threading.Event(), threading.Event()
    rounds, whole = 25, []

    def waiter():
        for _ in range(rounds):
            assert ready.wait(10)
            ready.clear()
            t0 = time.perf_counter()
            with lk:
                whole.append(time.perf_counter() - t0)
            done.set()
    old = sys.getswitchinterval()
    sys.setswitchinterval(0.5)
    locks.arm_timing(True)
    th = threading.Thread(target=waiter)
    th.start()
    try:
        for _ in range(rounds):
            with lk:
                ready.set()
                time.sleep(0.01)  # the waiter blocks on the lock
            t = time.perf_counter()
            while time.perf_counter() - t < 0.04:
                pass  # the GIL stays here
            assert done.wait(10)
            done.clear()
        th.join(10)
        row = locks.lock_stats()["test.handoff"]
    finally:
        locks.arm_timing(None)
        sys.setswitchinterval(old)
    assert sum(whole) > 1.0  # what the JAX timing would count as wait
    assert row["contended"] >= rounds // 2, row  # a waiter late to block waits on nothing
    assert row["wait_s"] < 2.0 * row["hold_s"], row
    assert _lock_finding("test.handoff", row) is None, row


def test_condition_on_timed_rlock():
    rlk = locks.make_lock("test.cond", rlock=True)
    cond = threading.Condition(rlk)
    box = []

    def waiter():
        with cond:
            while not box:
                cond.wait(timeout=5.0)
            box.append("seen")

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cond:
        box.append("x")
        cond.notify()
    t.join(timeout=5.0)
    assert not t.is_alive() and box == ["x", "seen"]
    with rlk:
        with rlk:
            pass


def test_reset_lock_stats_restarts_epoch():
    locks.arm_timing(True)
    time.sleep(0.01)
    locks.reset_lock_stats()
    locks.arm_timing(None)
    assert locks.timing_scale() < 100.0


def test_making_a_lock_starts_no_thread_and_the_profiler_starts_the_metronome():
    """Importing a module that makes a lock starts nothing; the timing
    metronome starts with a continuous profiler, the plane that
    publishes the lock gauges, and the profiler's publish tick writes
    them."""
    import subprocess

    code = (
        "import threading\n"
        "from ray_tpu_torch._private import locks, sampling_profiler as sp\n"
        "from ray_tpu_torch.util import metrics\n"
        "lk = locks.make_lock('x.y')\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "p = sp.ContinuousProfiler('t', ingest_fn=lambda *a: None, interval_s=0.05,"
        " burst_s=0.01, period_s=0.002)\n"
        "p.start()\n"
        "names = {t.name for t in threading.enumerate()}\n"
        "assert {'cont-profiler', 'ray_tpu_torch-lock-metronome'} <= names, names\n"
        "import time; locks.arm_timing(True)\n"
        "with lk: pass\n"
        "locks.arm_timing(None); time.sleep(0.3); p.stop()\n"
        "snap = metrics.registry().snapshot()\n"
        "assert 'ray_tpu_lock_wait_s' in snap and 'ray_tpu_profiler_duty_frac' in snap, sorted(snap)\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=60,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_an_idle_agent_stays_listed_between_its_backed_off_bursts():
    """At a 0.2 s push the history horizon is 2.4 s, while an idle agent's
    profiler backs off to a burst every 4, 8, then 16 s.  Its origin stays
    in ``list_profiles`` from its first burst on: the head retires a
    profile origin only after two of the profiler's longest intervals."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.experimental.state import api as state

    with tempfile.TemporaryDirectory(prefix="prof_idle_") as d, \
            pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMPDIR", d)
        mp.setattr(tempfile, "tempdir", d)
        mp.setenv("RAY_TPU_TORCH_METRICS_PUSH_S", "0.2")
        mp.delenv("RAY_TPU_TORCH_CONT_PROFILE_INTERVAL_S", raising=False)
        cluster = Cluster(initialize_head=True, real_processes=True,
                          head_node_args={"num_cpus": 1})
        try:
            from ray_tpu_torch._private.worker import global_worker

            assert global_worker.node._profile_retire_s == 2 * 16.0
            agent = f"agent:{cluster.add_node(num_cpus=1)}"
            deadline = time.monotonic() + T
            while agent not in {r["origin"] for r in state.list_profiles()}:
                assert time.monotonic() < deadline, "the agent's first burst"
                time.sleep(0.2)
            seen = []
            t_end = time.monotonic() + 16.0
            while time.monotonic() < t_end:
                seen.append(agent in {r["origin"] for r in state.list_profiles()})
                time.sleep(0.5)
            assert all(seen), f"the agent's origin left {seen.count(False)} of {len(seen)} reads"
            row = next(r for r in state.list_profiles() if r["origin"] == agent)
            assert row["interval_s"] > 2.0  # it did back off
        finally:
            cluster.shutdown()


# -- live: every process's profile reaches the head ----------------------------

@pytest.fixture(scope="module")
def prof_cluster():
    """A port head and one node agent, the profiler bursting every 0.2 s
    and pushing every 0.5 s (the workers and the agent inherit the env)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster

    env = {"RAY_TPU_TORCH_METRICS_PUSH_S": "0.5",
           "RAY_TPU_TORCH_CONT_PROFILE_INTERVAL_S": "0.2"}
    with tempfile.TemporaryDirectory(prefix="prof_") as d, pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMPDIR", d)
        mp.setattr(tempfile, "tempdir", d)
        for k, v in env.items():
            mp.setenv(k, v)
        cluster = Cluster(initialize_head=True, real_processes=True,
                          head_node_args={"num_cpus": 2})
        try:
            cluster.agent_node = cluster.add_node(num_cpus=2)
            yield rt, cluster
        finally:
            cluster.shutdown()


def test_live_profiles_reach_store_and_state_api(prof_cluster):
    """Every worker that ran a task, the agent and the head show in
    ``list_profiles``; the merged profile, the diff and the ledger read
    as the JAX test reads them."""
    rt, cluster = prof_cluster
    from ray_tpu_torch.experimental.state import api as state
    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

    @rt.remote
    def f(x):
        import os as _os

        sum(i * i for i in range(20_000))
        return _os.environ["RAY_TPU_TORCH_WORKER_ID"]

    remote_f = f.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
        cluster.agent_node, soft=False))
    wids = set()
    deadline = time.time() + T
    while time.time() < deadline:
        wids |= set(rt.get([f.remote(i) for i in range(20)], timeout=T))
        wids |= set(rt.get([remote_f.remote(i) for i in range(10)], timeout=T))
        origins = {r["origin"] for r in state.list_profiles()}
        if {"head", f"agent:{cluster.agent_node}"} | wids <= origins:
            break
        time.sleep(0.2)
    rows = state.list_profiles()
    origins = {r["origin"] for r in rows}
    assert {"head", f"agent:{cluster.agent_node}"} | wids <= origins, (origins, wids)
    assert {"origin", "buckets", "bytes", "samples", "gil_frac"} <= set(rows[0])
    prof = state.get_profile(window_s=600.0)
    assert prof["samples"] > 0 and prof["ticks"] > 0
    assert any(o.startswith("head") for o in prof["origins"])
    d = state.profile_diff(window_a=600.0, window_b=60.0)
    assert "collapsed" in d and d["samples_b"] >= 0
    led = state.profile_ledger(window_s=60.0)
    assert set(led["columns"]) == {"driver_submit_us", "head_dispatch_us", "worker_exec_us",
                                   "serialize_us", "lock_wait_us", "gil_wait_us", "other_us"}
    assert led["sum_us"] == pytest.approx(sum(led["columns"].values()), rel=0.01)
    names = {m["name"] for m in state.list_metrics()}
    assert {"ray_tpu_gil_lateness_frac", "ray_tpu_profiler_duty_frac",
            "ray_tpu_profile_serialization_frac"} <= names


def test_the_lock_metronome_reads_idle_to_the_sampler():
    """The metronome that arms the timed locks spends its life waiting;
    the sampler files its stack as idle, not as a busy ``lock_wait``
    thread beside every profiled process's real work."""
    p = sp.ContinuousProfiler("t", ingest_fn=lambda *a: None, interval_s=60.0)
    p.start()
    try:
        tid = next(t.ident for t in threading.enumerate()
                   if t.name == "ray_tpu_torch-lock-metronome")
        classes = []
        for _ in range(20):
            frame = sys._current_frames()[tid]
            classes.append(ps.classify_stack(sp.fold_frame(frame, 24)))
            assert sp.is_idle_leaf(frame) == (classes[-1] == "idle")
            time.sleep(0.01)
        assert classes.count("idle") >= 19, classes
    finally:
        p.stop()


# -- the GIL-lateness reading (ROADMAP C14) -----------------------------------
#
# The one difference from the JAX sampler: the port bounds a burst's GIL
# wait by the CPU the process's other threads used in it and leaves the
# sampler's own CPU out (``sampling_profiler.gil_lateness_frac``); the JAX
# reading is (elapsed - ticks * period) / elapsed.  So an idle worker whose
# wake-ups run late on a busy host reads 0 here, where the JAX package's
# ``gil_saturation`` read such a worker as core-bound.

@pytest.mark.parametrize("elapsed,expected,own,cpu", [
    (0.1, 0.05, 0.0, 0.1), (0.1, 0.05, 0.0, 0.0), (0.1, 0.05, 0.02, 0.03),
    (0.06, 0.05, 0.0, 0.2), (0.05, 0.06, 0.0, 0.05)])
def test_gil_lateness_reading_is_the_jax_reading_bounded_by_other_threads_cpu(
        elapsed, expected, own, cpu):
    jax_reading = max(0.0, min(1.0, (elapsed - expected) / elapsed))
    got = sp.gil_lateness_frac(elapsed, expected, own, cpu)
    bound = max(0.0, min(elapsed - expected - own, cpu - own)) / elapsed
    assert got == pytest.approx(min(jax_reading, max(0.0, bound)), abs=1e-12)
    if own == 0.0 and cpu >= elapsed:  # other threads held a core throughout
        assert got == pytest.approx(jax_reading, abs=1e-12)


_PROBE = """
import json, sys, threading
from ray_tpu_torch._private import sampling_profiler as sp

stop = threading.Event()

def spin():
    x = 0
    while not stop.is_set():
        x += 1

import os
os.nice(int(sys.argv[2]))  # behind the host's other work in its run queue
for _ in range(int(sys.argv[1])):
    threading.Thread(target=spin, daemon=True).start()
p = sp.ContinuousProfiler("probe", ingest_fn=lambda *a, **k: None)
out = []
for _ in range(8):
    p._burst()
    out.append(p.lateness_frac)
stop.set()
print(json.dumps(out))
"""


def _probe_lateness(spinning_threads, nice=0):
    import json
    import subprocess

    out = subprocess.run([sys.executable, "-c", _PROBE, str(spinning_threads), str(nice)],
                         capture_output=True, text=True, timeout=T,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout)


def _gil_finding(readings):
    from ray_tpu_torch.util import doctor

    pts = [(T0 + i, v) for i, v in enumerate(readings)]
    return doctor._trend_rule_gil_saturation(
        {"ray_tpu_gil_lateness_frac": [{"tags": {"origin": "w"}, "points": pts}]})


def test_an_idle_worker_on_a_busy_host_opens_no_gil_saturation():
    """Every core of the host spins in other processes and the idle probe
    runs behind them (niced): its ticks wake late, but nothing in it held
    the GIL, so its reading stays under the rule's threshold and
    ``gil_saturation`` stays closed."""
    import subprocess

    hogs = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(os.cpu_count() or 1)]
    try:
        readings = _probe_lateness(0, nice=19)
    finally:
        for h in hogs:
            h.kill()
            h.wait(timeout=10)
    assert max(readings) < sp_threshold(), readings
    assert _gil_finding(readings) is None


def test_a_worker_spinning_python_threads_still_opens_gil_saturation():
    readings = _probe_lateness(3)
    assert min(readings) >= sp_threshold(), readings
    f = _gil_finding(readings)
    assert f is not None and f["rule"] == "gil_saturation"


def sp_threshold():
    from ray_tpu_torch.util import doctor

    return doctor.GIL_SATURATION_FRAC

