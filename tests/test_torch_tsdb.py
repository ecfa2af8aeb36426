"""The port's metrics store (``util/tsdb.py``), its registry merge and
pusher (``util/metrics.py``) and its ``/proc`` sampler
(``_private/resource_spec.py``) against the JAX package's, on the CPU
with no runtime.

The cases are ``tests/test_resource_accounting.py``'s pure ones (its
lines 29-260).  The same ingest sequence (seeded snapshots at fixed
timestamps) goes through both packages' stores, and every ``query``,
``list_metrics``, ``stats`` and expiry result is equal; each case also
keeps the JAX test's own checks on the port's results.
"""

import signal
import threading
import time

import numpy as np
import pytest

from ray_tpu.util import metrics as jax_metrics
from ray_tpu.util import tsdb as jax_tsdb
from ray_tpu._private import resource_spec as jax_rs
from ray_tpu_torch._private import resource_spec as rs
from ray_tpu_torch.util import metrics, tsdb

T0 = 1_700_000_000.0  # fixed epoch: downsample buckets must be deterministic
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


def _stores(**kw):
    return tsdb.TimeSeriesStore(**kw), jax_tsdb.TimeSeriesStore(**kw)


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


def _both(stores, fn):
    outs = [fn(s) for s in stores]
    _same(outs[0], outs[1])
    return outs[0]


def test_module_constants_and_knobs_match():
    assert (tsdb.DEFAULT_RAW_POINTS, tsdb.DEFAULT_M1_POINTS, tsdb.DEFAULT_M10_POINTS,
            tsdb.DEFAULT_MAX_BYTES, tsdb.ORIGIN_EXPIRY_INTERVALS, tsdb._AGGS) == (
        jax_tsdb.DEFAULT_RAW_POINTS, jax_tsdb.DEFAULT_M1_POINTS, jax_tsdb.DEFAULT_M10_POINTS,
        jax_tsdb.DEFAULT_MAX_BYTES, jax_tsdb.ORIGIN_EXPIRY_INTERVALS, jax_tsdb._AGGS)
    assert metrics.push_interval_s() == jax_metrics.push_interval_s() == 5.0


@pytest.mark.parametrize("knob,value,want", [("0.2", 0.2, 0.2), ("0.01", 0.05, 0.05),
                                             ("junk", 5.0, 5.0)])
def test_push_interval_knob_under_the_ports_prefix(monkeypatch, knob, value, want):
    """``RAY_TPU_TORCH_METRICS_PUSH_S`` means what ``RAY_TPU_METRICS_PUSH_S``
    means to the JAX package (floored at 0.05 s, 5 s when unparsable)."""
    monkeypatch.setenv("RAY_TPU_TORCH_METRICS_PUSH_S", knob)
    monkeypatch.setenv("RAY_TPU_METRICS_PUSH_S", knob)
    assert metrics.push_interval_s() == jax_metrics.push_interval_s() == want == value


def test_tsdb_downsampling_sum_max_last():
    """Each 1-min/10-min bucket keeps (last, max, min, sum, count) so any
    aggregation stays answerable after the raw ring rolled over."""
    stores = _stores(raw_points=10, m1_points=100, m10_points=100)
    n = 360  # 30 min of 5 s samples
    vals = np.random.default_rng(0).normal(100.0, 10.0, n).tolist()
    for s in stores:
        for i, v in enumerate(vals):
            s.add_sample("m", v, tags={"k": "v"}, origin="w", ts=T0 + i * 5)
    now = T0 + n * 5
    for agg in ("last", "max", "min", "sum", "avg", "count"):
        for step in (5, 60, 600):
            q = _both(stores, lambda s: s.query("m", window_s=n * 5 + 60, step_s=step,
                                                agg=agg, now=now))
            assert q["series"][0]["points"], (agg, step)
    # the JAX test's own checks, on the port's store, over its ramp
    ts = stores[0].__class__(raw_points=10, m1_points=100, m10_points=100)
    for i in range(n):
        ts.add_sample("m", float(i), tags={"k": "v"}, origin="w", ts=T0 + i * 5)
    q = ts.query("m", window_s=n * 5, step_s=60, agg="sum", now=now)
    interior = [p[1] for p in q["series"][0]["points"][2:-2]]
    assert interior and all((v - 66) % 12 == 0 for v in interior)
    assert all(b - a == 144 for a, b in zip(interior, interior[1:]))
    q = ts.query("m", window_s=n * 5 + 60, step_s=60, agg="count", now=now)
    assert sum(p[1] for p in q["series"][0]["points"]) == pytest.approx(n, rel=0.08)


def test_tsdb_histograms_become_count_and_sum_series():
    stores = _stores()
    rng = np.random.default_rng(1)
    for i in range(5):
        counts = rng.integers(0, 10, 3).tolist()
        snap = {"lat_s": {"type": "histogram", "help": "h", "values": {
            (("k", "v"),): {"buckets": counts, "bounds": (0.1, 1.0),
                            "sum": float(rng.random() * 10), "count": sum(counts)}}},
                "depth": {"type": "gauge", "help": "g", "values": {(): float(i)}}}
        for s in stores:
            s.ingest("w1", snap, ts=T0 + i)
    rows = _both(stores, lambda s: s.list_metrics())
    assert {m["name"] for m in rows} == {"lat_s_count", "lat_s_sum", "depth"}
    for name in ("lat_s_count", "lat_s_sum", "depth"):
        q = _both(stores, lambda s: s.query(name, window_s=60, step_s=1, now=T0 + 10))
        assert q["series"][0]["tags"]["origin"] == "w1"
    assert q["type"] == "gauge"


def test_tsdb_retention_cap_under_10k_series_load():
    """The byte cap holds under synthetic 10k-series load; eviction is
    least-recently-updated first, the same series in both stores."""
    cap = 300_000
    stores = _stores(max_bytes=cap, raw_points=64, m1_points=16, m10_points=8)
    for s in stores:
        for i in range(10_000):
            s.add_sample("m", float(i), tags={"s": str(i)}, origin="o", ts=T0 + i * 0.1)
    stats = _both(stores, lambda s: s.stats())
    assert stats["est_bytes"] <= cap and stats["evicted_series"] > 0
    assert stats["num_series"] < 10_000
    for tag in ("9999", "0", "5000"):
        _both(stores, lambda s: s.query("m", window_s=10_000, tags={"s": tag}, now=T0 + 1000))
    assert stores[0].query("m", window_s=10_000, tags={"s": "9999"}, now=T0 + 1000)["series"]
    assert not stores[0].query("m", window_s=10_000, tags={"s": "0"}, now=T0 + 1000)["series"]


def test_tsdb_24h_of_5s_history_stays_under_cap():
    """24 h of 5 s samples, two processes wide, stays under the cap via
    staged downsampling; the day, the last hour and the day at a raw
    step read the same from both stores."""
    cap = 8 << 20
    stores = _stores(max_bytes=cap)
    n = (24 * 3600) // 5
    for s in stores:
        for origin in ("w1", "w2"):
            for i in range(n):
                s.add_sample("rss", 100.0 + i * 0.01, tags={"w": origin}, origin=origin,
                             ts=T0 + i * 5)
    assert stores[0].memory_bytes() == stores[1].memory_bytes() <= cap
    assert _both(stores, lambda s: s.stats())["evicted_series"] == 0
    now = T0 + n * 5
    q = _both(stores, lambda s: s.query("rss", window_s=24 * 3600, step_s=600,
                                        tags={"w": "w1"}, now=now))
    pts = q["series"][0]["points"]
    assert len(pts) >= 130 and pts[0][1] < pts[-1][1]
    q = _both(stores, lambda s: s.query("rss", window_s=3600, step_s=5, tags={"w": "w1"},
                                        now=now))
    assert len(q["series"][0]["points"]) >= 700
    q = _both(stores, lambda s: s.query("rss", window_s=24 * 3600, step_s=5,
                                        tags={"w": "w1"}, now=now))
    assert q["series"][0]["points"][0][0] <= now - 20 * 3600, "window not covered"


def test_tsdb_origin_expiry():
    stores = _stores()
    for s in stores:
        s.add_sample("m", 1.0, origin="dead", ts=T0)
        s.add_sample("m", 2.0, origin="live", ts=T0 + 100)
    assert _both(stores, lambda s: s.expire_stale(30.0, now=T0 + 110)) == 1
    q = _both(stores, lambda s: s.query("m", window_s=1000, now=T0 + 110))
    assert {x["tags"]["origin"] for x in q["series"]} == {"live"}
    assert set(_both(stores, lambda s: s.origins())) == {"live"}


def test_tsdb_expire_stale_drops_idle_series_under_live_origin():
    stores = _stores()
    for s in stores:
        s.add_sample("rss", 1.0, tags={"pid": "1"}, origin="agent", ts=T0)
        for i in range(5):
            s.add_sample("rss", 2.0, tags={"pid": "2"}, origin="agent", ts=T0 + 100 + i)
    assert _both(stores, lambda s: s.expire_stale(60.0, now=T0 + 105)) == 1
    q = _both(stores, lambda s: s.query("rss", window_s=1000, now=T0 + 105))
    assert {x["tags"]["pid"] for x in q["series"]} == {"2"}
    assert "agent" in stores[0].origins()


@pytest.mark.parametrize("window,step,agg", [(0, 0, None), (-5, 0, None), (30, 600, None),
                                              (60, 0, None), (60, 5, "avg"), (60, 7, "min"),
                                              (1e9, 5, "max")])
def test_tsdb_query_edge_cases(monkeypatch, window, step, agg):
    """Empty and negative windows, a step past the window, the default
    step (the push interval, here 5 s in both packages), and an unknown
    metric, each equal; an unknown aggregation raises in both."""
    monkeypatch.delenv("RAY_TPU_TORCH_METRICS_PUSH_S", raising=False)
    monkeypatch.delenv("RAY_TPU_METRICS_PUSH_S", raising=False)
    stores = _stores()
    for s in stores:
        for i in range(10):
            s.add_sample("m", float(i), origin="o", ts=T0 + i * 5)
    now = T0 + 50
    q = _both(stores, lambda s: s.query("m", window_s=window, step_s=step, agg=agg, now=now))
    if window <= 0:
        assert q["series"][0]["points"] == []
    if step > window > 0:
        assert len(q["series"][0]["points"]) == 1 and q["series"][0]["points"][0][1] == 9.0
    assert _both(stores, lambda s: s.query("nope", window_s=60, now=now))["series"] == []
    for s in stores:
        with pytest.raises(ValueError):
            s.query("m", agg="p99")


def test_tsdb_ingest_of_seeded_registry_snapshots():
    """Registry snapshots of three origins (gauges, counters, a
    histogram, label sets with and without ``origin``), 40 pushes at a
    fixed 0.5 s cadence, then expiry of one origin: every listing and
    query equal."""
    rng = np.random.default_rng(2)
    stores = _stores()
    origins = ["head", "w-a", "w-b"]
    for k in range(40):
        for o in origins:
            if o == "w-b" and k >= 25:
                continue  # w-b died at push 25
            snap = {
                "g": {"type": "gauge", "help": "gauge",
                      "values": {(("dev", str(d)),): float(rng.normal()) for d in range(2)}},
                "c": {"type": "counter", "help": "ctr",
                      "values": {(): float(k * 3 + rng.integers(0, 3))}},
                "h": {"type": "histogram", "help": "hist",
                      "values": {(("fn", "step"),): {"buckets": [k, 1], "bounds": (0.5,),
                                                      "sum": float(k) * 0.25, "count": k + 1}}},
                "tagged": {"type": "gauge", "help": "", "values": {
                    (("origin", "elsewhere"),): float(k)}},
            }
            for s in stores:
                s.ingest(o, snap, ts=T0 + 0.5 * k)
    now = T0 + 20.0
    _both(stores, lambda s: s.list_metrics())
    for name in ("g", "c", "h_count", "h_sum", "tagged"):
        for agg in (None, "max", "sum", "avg"):
            _both(stores, lambda s: s.query(name, window_s=30, step_s=0.5, agg=agg, now=now))
    _both(stores, lambda s: s.query("g", window_s=30, step_s=2, tags={"dev": "1"}, now=now))
    assert _both(stores, lambda s: s.expire_stale(6.0, now=now)) > 0
    assert "w-b" not in _both(stores, lambda s: s.origins())
    _both(stores, lambda s: (s.list_metrics(), s.stats()))


# -- metrics satellites (pure) -----------------------------------------------

def _registries():
    return metrics._Registry(), jax_metrics._Registry()


def test_registry_merge_expires_dead_origins():
    regs = _registries()
    snap = {"m": {"type": "gauge", "help": "", "values": {(): 1.0}}}
    for r in regs:
        r.merge("w-dead", snap)
    time.sleep(0.15)
    for r in regs:
        r.merge("w-live", snap)
    assert [r.expire_origins(0.1) for r in regs] == [["w-dead"], ["w-dead"]]
    keys = _both(regs, lambda r: set(r.snapshot()["m"]["values"]))
    assert keys == {(("origin", "w-live"),)}
    for r in regs:
        r.merge("w-live", snap)
    assert [r.expire_origins(10.0) for r in regs] == [[], []]


def test_registry_merge_replaces_origins_previous_series():
    regs = _registries()
    pushes = [("agent", {"rss": {"type": "gauge", "help": "", "values": {
                  (("pid", "1"),): 10.0, (("pid", "2"),): 20.0}}}),
              ("agent", {"rss": {"type": "gauge", "help": "", "values": {
                  (("pid", "2"),): 21.0}}}),
              ("other", {"rss": {"type": "gauge", "help": "", "values": {
                  (("pid", "9"),): 5.0}}}),
              ("agent", {"rss": {"type": "gauge", "help": "", "values": {
                  (("pid", "2"),): 22.0}}})]
    for origin, snap in pushes:
        for r in regs:
            r.merge(origin, snap)
        _both(regs, lambda r: r.snapshot())
    keys = set(regs[0].snapshot()["rss"]["values"])
    assert keys == {(("pid", "2"), ("origin", "agent")), (("pid", "9"), ("origin", "other"))}


def test_merge_snapshots_and_prometheus_text_equal_the_jax_packages():
    a = {"x": {"type": "gauge", "help": "h \"q\"", "values": {(("k", 'a"b\n'),): 1.5}},
         "lat": {"type": "histogram", "help": "", "values": {
             (): {"buckets": [1, 2, 0], "bounds": (0.1, 1.0), "sum": 0.75, "count": 3}}}}
    b = {"x": {"type": "gauge", "help": "", "values": {(("k", "b"),): 2.0}}}
    merged = metrics.merge_snapshots(a, b)
    assert merged == jax_metrics.merge_snapshots(a, b)
    assert metrics.prometheus_text(merged) == jax_metrics.prometheus_text(merged)


def test_metric_remove_retires_label_series():
    g = metrics.Gauge("rt_test_remove", "t")
    g.set(1.0, tags={"worker": "a"})
    g.set(2.0, tags={"worker": "b"})
    assert sorted(d["worker"] for d in g.label_sets()) == ["a", "b"]
    assert g.remove({"worker": "a"}) is True
    assert g.remove({"worker": "a"}) is False
    assert list(metrics.registry().snapshot()["rt_test_remove"]["values"]) == [(("worker", "b"),)]


def _pusher_gaps(mod, interval, send_s, n=8):
    mod.Counter("rt_test_spacing", "t").inc()
    stamps = []

    def slow_send(msg):
        stamps.append((time.monotonic(), msg["type"], msg["origin"]))
        time.sleep(send_s)

    pusher = mod.MetricsPusher(slow_send, origin="t", interval_s=interval).start()
    deadline = time.monotonic() + 10
    while len(stamps) < n and time.monotonic() < deadline:
        time.sleep(0.02)
    pusher.stop()
    assert len(stamps) >= n
    assert {(t, o) for _, t, o in stamps} == {("metrics_report", "t")}
    gaps = sorted(b[0] - a[0] for a, b in zip(stamps, stamps[1:]))
    return gaps[len(gaps) // 2]


def test_metrics_pusher_deadline_spacing_under_slow_send():
    """A send that takes ~60% of the interval must not stretch the
    spacing in either package: deadline ticks keep the grid."""
    interval = 0.1
    port = _pusher_gaps(metrics, interval, 0.06)
    ref = _pusher_gaps(jax_metrics, interval, 0.06)
    assert port == pytest.approx(interval, abs=0.03)
    assert ref == pytest.approx(interval, abs=0.03)


def test_metrics_pusher_stops_on_a_closed_client_and_retries_failed_sends():
    """``closed_fn`` ends the loop; a failing send is retried at the next
    grid tick, not given up on."""
    metrics.Counter("rt_test_retry", "t").inc()
    calls = []
    closed = threading.Event()

    def flaky(msg):
        calls.append(time.monotonic())
        if len(calls) <= 2:
            raise OSError("transient")
        if len(calls) >= 4:
            closed.set()

    pusher = metrics.MetricsPusher(flaky, origin="t", interval_s=0.05,
                                   closed_fn=closed.is_set).start()
    pusher._thread.join(10)
    assert not pusher._thread.is_alive()
    assert len(calls) == 4


def test_grid_ticks_skip_overrun_points_and_flag_stalls():
    """The shared ticker keeps its phase after a slow body and reports
    a stall when one tick came more than two intervals late, in both
    packages."""
    outs = []
    for mod in (metrics, jax_metrics):
        n, flags, t0 = 0, [], time.monotonic()
        for stalled in mod.grid_ticks(0.2, lambda t: time.sleep(t) or n >= 6):
            n += 1
            flags.append(stalled)
            if n == 3:
                time.sleep(0.7)
        outs.append(flags)
        assert time.monotonic() - t0 < 5.0
    assert outs[0] == outs[1] == [False, False, False, True, False, False]


# -- the /proc sampler --------------------------------------------------------

def test_proc_sampler_reads_this_process_as_the_jax_sampler_does():
    """RSS, CPU% and open fds of this process: the same keys, RSS within
    a few MB of the JAX sampler's, CPU% from the second sample on, a
    vanished pid gives None, and the snapshot is registry-shaped."""
    import os

    port, ref = rs.ProcSampler(), jax_rs.ProcSampler()
    a, b = port.sample(os.getpid()), ref.sample(os.getpid())
    assert set(a) == set(b) == {"rss_mb", "cpu_pct", "open_fds"}
    assert abs(a["rss_mb"] - b["rss_mb"]) < 64 and a["rss_mb"] > 5
    assert a["cpu_pct"] == b["cpu_pct"] == 0.0  # no baseline yet
    t0 = time.process_time()
    while time.process_time() - t0 < 0.2:
        pass
    assert port.sample(os.getpid())["cpu_pct"] > 0
    assert port.sample(2 ** 22 + 12345) is None
    ents = [({"entity": "head", "worker_id": "head", "node": "n"}, os.getpid()),
            ({"entity": "worker", "worker_id": "gone", "node": "n"}, 2 ** 22 + 12345)]
    snap, raw = rs.resource_metrics_snapshot(port, ents)
    jsnap, jraw = jax_rs.resource_metrics_snapshot(ref, ents)
    assert set(snap) == set(jsnap) == {rs.PROC_RSS_MB, rs.PROC_CPU_PCT, rs.PROC_OPEN_FDS}
    assert (rs.PROC_RSS_MB, rs.PROC_CPU_PCT, rs.PROC_OPEN_FDS) == (
        jax_rs.PROC_RSS_MB, jax_rs.PROC_CPU_PCT, jax_rs.PROC_OPEN_FDS)
    assert [list(m["values"]) for m in snap.values()] == [list(m["values"]) for m in jsnap.values()]
    assert [(t, p) for t, p, _ in raw] == [(t, p) for t, p, _ in jraw] == [ents[0]]
    assert set(rs.host_stats()) == set(jax_rs.host_stats())
