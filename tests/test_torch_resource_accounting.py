"""The port's resource-accounting plane on a live port cluster on the CPU:
the metrics push from workers and node agents, the head's merged
registry and TSDB, the ``/proc`` samplers, ``query_metric``, the memory
audit, ``top``, ``perf``, the doctor and their CLI commands.

The cases are ``tests/test_resource_accounting.py``'s cluster ones (its
lines 357-506 and 535), by name, on a port cluster; the dashboard
endpoints (its line 508) are not ported.  Beside them: the push cadence
knob at 0.2 s (a worker's first push comes after its start-up, and an
origin is expired only after it stopped pushing), one pusher per worker
process, the card-memory gauges of a half-card actor, the step
profiler's phases in ``perf``, and which sampler owns a pid when the head
and a node agent share a host.

One cluster serves the module: a port head (``num_cpus=4``, two fake
cards) and one real node agent with 2 CPUs, started once under a
private ``TMPDIR``.  Every test has its own time limit and every wait is
bounded.
"""

import contextlib
import io
import os
import signal
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private.worker import global_worker
from ray_tpu_torch.experimental.state import api as state
from ray_tpu_torch.scripts import cli
from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PUSH_S = 0.2
T = 60  # seconds: every get and wait in this file
LIMIT = 150  # seconds: each test's own limit


@pytest.fixture(autouse=True)
def time_limit(request):
    def expired(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past its {LIMIT} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old if old is not None else signal.SIG_DFL)


@pytest.fixture(scope="module")
def ra_cluster():
    """A head and one node agent with a fast push and event flush (the
    workers and the agent inherit the env)."""
    from ray_tpu_torch.cluster_utils import Cluster

    env = {"RAY_TPU_TORCH_METRICS_PUSH_S": str(PUSH_S),
           "RAY_TPU_TORCH_EVENTS_FLUSH_S": "0.3"}
    with tempfile.TemporaryDirectory(prefix="ra_") as d, pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMPDIR", d)
        mp.setattr(tempfile, "tempdir", d)
        for k, v in env.items():
            mp.setenv(k, v)
        cluster = Cluster(initialize_head=True, real_processes=True,
                          head_node_args={"num_cpus": 4, "num_gpus": 2})
        try:
            # a worker's series starts 1 s after its start-up here, or 8 s
            # after it registered, not the head's 10 s and 60 s
            # (test_a_workers_series_starts_after_its_warm_up)
            global_worker.node.WORKER_WARMUP_S = 1.0
            global_worker.node.WORKER_START_BOUND_S = 8.0
            cluster.agent_node = cluster.add_node(num_cpus=2)
            yield cluster
        finally:
            cluster.shutdown()


def _wait_for(pred, timeout=T, interval=0.1):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(interval)
    raise AssertionError("condition not met within timeout")


def _cli(*argv):
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            cli.main(list(argv))
        except SystemExit as e:
            code = e.code
    return code, buf.getvalue()


# -- test_resource_accounting.py's cluster cases -----------------------------

def test_query_metric_returns_live_series(ra_cluster):
    @rt.remote
    def tick(i):
        return i

    rt.get([tick.remote(i) for i in range(20)], timeout=T)

    def has_series():
        # a worker's series starts once its warm-up after its first task
        # is over (the fixture's WORKER_WARMUP_S)
        q = state.query_metric("ray_tpu_proc_rss_mb", window_s=120, step_s=PUSH_S)
        return any(len(s["points"]) >= 3 and s["tags"].get("worker_id") not in (None, "head")
                   for s in q["series"])
    _wait_for(has_series)
    names = {m["name"] for m in state.list_metrics()}
    assert {"ray_tpu_proc_rss_mb", "ray_tpu_sched_queue_depth", "ray_tpu_num_workers",
            "ray_tpu_tasks"} <= names
    q = state.query_metric("ray_tpu_proc_rss_mb", window_s=120)
    tags = [s["tags"] for s in q["series"]]
    assert any(t.get("worker_id") not in (None, "head") for t in tags)
    assert all("origin" in t for t in tags)
    vals = [p[1] for s in q["series"] for p in s["points"]]
    assert vals and all(5.0 < v < 100_000 for v in vals)
    with pytest.raises(ValueError):
        state.query_metric("ray_tpu_proc_rss_mb", agg="p99")


def test_memory_audit_attributes_bytes_to_owners(ra_cluster):
    @rt.remote
    def produce():
        return np.zeros(600_000, dtype=np.uint8)

    @rt.remote
    class Holder:
        def make(self):
            return np.zeros(800_000, dtype=np.uint8)

    driver_ref = rt.put(np.zeros(1_000_000, dtype=np.uint8))
    task_refs = [produce.remote() for _ in range(3)]
    rt.wait(task_refs, num_returns=len(task_refs), timeout=T)
    holder = Holder.remote()
    actor_ref = holder.make.remote()
    rt.wait([actor_ref], num_returns=1, timeout=T)

    audit = state.memory_summary(limit=50)
    assert audit["total_bytes"] >= 1_000_000 + 3 * 600_000 + 800_000
    assert audit["attributed_frac"] >= 0.95
    kinds = {o["owner_kind"] for o in audit["by_owner"]}
    assert {"driver", "worker", "actor"} <= kinds
    actor_row = next(o for o in audit["by_owner"] if o["owner_kind"] == "actor")
    assert actor_row["owner_label"].startswith("Holder:")
    assert actor_row["bytes"] >= 800_000
    assert all(r["pin_reason"] in ("handle", "task_arg", "contained", "lineage")
               for r in audit["rows"])
    assert all(r["age_s"] >= 0 for r in audit["rows"])
    rt.kill(holder)
    del driver_ref, task_refs, actor_ref


def test_memory_audit_flags_orphans_after_actor_death(ra_cluster):
    @rt.remote
    class Leaker:
        def make(self):
            return np.zeros(700_000, dtype=np.uint8)

    leaker = Leaker.remote()
    ref = leaker.make.remote()
    rt.wait([ref], num_returns=1, timeout=T)
    rt.kill(leaker)

    def orphaned():
        audit = state.memory_summary(limit=50)
        return [r for r in audit["rows"] if r.get("orphan") and r["size"] >= 700_000]
    rows = _wait_for(orphaned)
    assert rows[0]["owner_kind"] == "actor"
    assert state.memory_summary(limit=0)["orphan_bytes"] >= 700_000
    del ref


def test_top_and_memory_cli_render_live(ra_cluster):
    @rt.remote
    def spin():
        t0 = time.time()
        while time.time() - t0 < 0.3:
            pass
        return 1

    refs = [spin.remote() for _ in range(4)]
    _wait_for(lambda: any(w.get("rss_mb") for w in state.top_snapshot()["workers"]))
    rt.get(refs, timeout=T)

    code, frame = _cli("top", "--iterations", "1", "--sort", "rss")
    assert code == 0
    assert "ray_tpu_torch top" in frame and "WORKER" in frame and "NODE" in frame
    assert "MB" in frame  # a sampled RSS actually rendered

    held = rt.put(np.zeros(500_000, dtype=np.uint8))
    code, out = _cli("memory", "--limit", "5")
    assert code == 0 and "attributed to an owner" in out
    assert "driver" in out and "OWNER" in out
    code, out = _cli("metrics")
    assert code == 0 and "ray_tpu_proc_rss_mb" in out
    del held


def test_list_objects_truncation_marker(ra_cluster):
    refs = [rt.put(np.zeros(10, dtype=np.uint8)) for _ in range(5)]
    page = state.list_state_page("objects", limit=2)
    assert len(page["rows"]) == 2 and page["total"] >= 5 and page["truncated"] is True
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert len(state.list_objects(limit=2)) == 2
    assert any("truncated" in str(x.message) for x in w)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        state.list_objects(limit=100_000)
    assert not [x for x in w if "truncated" in str(x.message)]
    del refs


def test_doctor_healthy_run_has_no_trend_findings(ra_cluster):
    from ray_tpu_torch.util.doctor import run_doctor

    @rt.remote
    def work(i):
        return i * 2

    rt.get([work.remote(i) for i in range(30)], timeout=T)
    time.sleep(0.8)  # a few TSDB ticks over the settled state
    findings = run_doctor()
    trend_rules = {"rss_growth", "object_store_leak", "queue_depth_climb", "mfu_regression"}
    assert not [f for f in findings if f["rule"] in trend_rules], [f["evidence"] for f in findings]


# -- the port's own cases ----------------------------------------------------

@rt.remote
class _Booter:
    """An actor whose worker pushes only after a slow start-up."""

    def __init__(self, boot_s):
        time.sleep(boot_s)

    def wid(self):
        return os.environ["RAY_TPU_TORCH_WORKER_ID"]


def _origins():
    return set(global_worker.node.worker_metrics_registry.origin_seen)


def test_origins_expire_only_after_their_pushes_stop(ra_cluster):
    """At a 0.2 s push the expiry window is 0.6 s.  A worker that takes
    2 s to start (as one importing torch does) is never expired while it
    lives: its origin enters at its first push and stays through 15
    intervals; killed, it leaves within the window (plus a tick)."""
    node = global_worker.node
    assert node._origin_expiry_s == pytest.approx(3 * PUSH_S)
    a = _Booter.remote(2.0)
    wid = rt.get(a.wid.remote(), timeout=T)
    _wait_for(lambda: wid in _origins())
    t_end = time.monotonic() + 15 * PUSH_S
    while time.monotonic() < t_end:
        assert wid in _origins()
        time.sleep(PUSH_S / 2)
    assert state.query_metric("ray_tpu_object_put_latency_s_count", window_s=60,
                              tags={"origin": wid}) is not None
    rt.kill(a)
    t0 = time.monotonic()
    _wait_for(lambda: wid not in _origins(), timeout=10 * PUSH_S + 5)
    assert time.monotonic() - t0 < 10 * PUSH_S + 5
    expired = [e for e in rt_events() if e["message"] == "metrics origin expired"
               and e.get("entity_id") == wid]
    assert expired


def rt_events():
    from ray_tpu_torch._private import events as events_mod

    return events_mod.local_events()


def test_a_reused_worker_pushes_one_series_per_metric(ra_cluster):
    """Tasks reuse pooled workers; each worker's pusher ships its own
    counter once, under its own origin, with the count of the tasks it
    ran."""
    @rt.remote
    def count(i):
        from ray_tpu_torch.util.metrics import Counter

        Counter("rt_ra_tasks_total", "tasks this worker ran").inc()
        return os.environ["RAY_TPU_TORCH_WORKER_ID"]

    wids = rt.get([count.remote(i) for i in range(40)], timeout=T)
    ran = {w: wids.count(w) for w in set(wids)}

    def pushed():
        snap = global_worker.node.worker_metrics_registry.snapshot()
        vals = (snap.get("rt_ra_tasks_total") or {}).get("values", {})
        got = {}
        for key, v in vals.items():
            origin = dict(key)["origin"]
            assert origin not in got, f"two series from {origin}"
            got[origin] = v
        return got if got == {w: float(n) for w, n in ran.items()} else None
    _wait_for(pushed)


@rt.remote(num_gpus=0.5)
class _CardShare:
    def memory(self):
        from ray_tpu_torch.util import perf

        return perf.publish_device_memory()

    def wid(self):
        return os.environ["RAY_TPU_TORCH_WORKER_ID"]


def test_device_memory_gauges_of_card_share_actors_reach_top_and_the_tsdb(ra_cluster):
    """Two half-card actors publish ``util/perf.py``'s device-memory gauges
    (host RSS on the CPU): each one's pushed value is its own reading,
    and ``top`` lists a device-memory row beside each actor's worker."""
    actors = [_CardShare.remote() for _ in range(2)]
    samples = rt.get([a.memory.remote() for a in actors], timeout=T)
    wids = rt.get([a.wid.remote() for a in actors], timeout=T)
    time.sleep(2 * PUSH_S)

    def pushed():
        q = state.query_metric("ray_tpu_hbm_bytes_in_use", window_s=60)
        last = {s["tags"]["origin"]: s["points"][-1][1] for s in q["series"] if s["points"]}
        return last if set(wids) <= set(last) else None
    last = _wait_for(pushed)
    for wid, sample in zip(wids, samples):
        assert last[wid] == float(sample["bytes_in_use"])
    top = state.top_snapshot()
    rows = {r["tags"].get("origin"): r for r in top["hbm"]}
    assert set(wids) <= set(rows)
    workers = {w["worker_id"]: w for w in top["workers"]}
    assert all(workers[w]["kind"] == "actor" for w in wids)
    for a in actors:
        rt.kill(a)


def test_the_proc_sampler_forgets_a_vanished_pid():
    """A pid that left the sampled set loses its CPU baseline, and the
    tick that drops it does not raise (a raise there stopped every later
    head sampler tick)."""
    from ray_tpu_torch._private.resource_spec import ProcSampler, resource_metrics_snapshot

    sampler = ProcSampler()
    me = ({"entity": "head", "worker_id": "head", "node": "n"}, os.getpid())
    gone = ({"entity": "worker", "worker_id": "w", "node": "n"}, os.getppid())
    snap, raw = resource_metrics_snapshot(sampler, [me, gone])
    assert len(raw) == 2 and set(sampler._prev) == {os.getpid(), os.getppid()}
    snap, raw = resource_metrics_snapshot(sampler, [me])
    assert [pid for _, pid, _ in raw] == [os.getpid()]
    assert set(sampler._prev) == {os.getpid()}


@rt.remote(num_gpus=0.5)
class _PoolShare:
    """One of a pool's half-card actors: each call publishes its device
    memory, as a scoring actor on the card does."""

    def score(self, x):
        from ray_tpu_torch.util import perf

        perf.publish_device_memory()
        return x * 2

    def wid(self):
        return os.environ["RAY_TPU_TORCH_WORKER_ID"]


C6_READS = 24


def test_top_reads_right_after_a_pool_map_lack_no_field(ra_cluster):
    """``top``'s first read once lacked a field of one of a pool's two
    actors on the card.  Here a pool of two half-card actors at a 0.2 s
    push maps, and ``top_snapshot()`` is read right after each of 24
    maps; every read must hold both actors' RSS, CPU, worker row and
    device-memory row.  A miss is reported with its field and the actor's
    origin expiries.  Run after another test's actors died, this read
    lacked both actors' RSS and CPU every time while the sampler's
    ``forget_missing`` raised on a vanished pid (every tick after the
    first worker death failed before it refreshed the head's rows)."""
    from ray_tpu_torch.util import ActorPool

    actors = [_PoolShare.remote() for _ in range(2)]
    wids = rt.get([a.wid.remote() for a in actors], timeout=T)
    pool = ActorPool(actors)
    assert list(pool.map(lambda a, x: a.score.remote(x), range(8))) == [2 * i for i in range(8)]
    time.sleep(2 * PUSH_S)

    def misses():
        top = state.top_snapshot()
        rows = {w["worker_id"]: w for w in top["workers"]}
        card_rows = {r["tags"].get("origin") for r in top["hbm"]}
        out = {}
        for w in wids:
            lack = [f for f in ("rss_mb", "cpu_pct") if rows.get(w, {}).get(f) is None]
            lack += [] if w in rows else ["worker_row"]
            lack += [] if w in card_rows else ["card_row"]
            if lack:
                out[w] = lack
        return out

    record = []
    for i in range(C6_READS):
        got = list(pool.map(lambda a, x: a.score.remote(x), range(8)))
        assert got == [2 * j for j in range(8)]
        m = misses()
        if m:
            record.append((i, m))
    expiries = {w: sum(1 for e in rt_events() if e["message"] == "metrics origin expired"
                       and e.get("entity_id") == w) for w in wids}
    for a in actors:
        rt.kill(a)
    assert not record, (f"{len(record)} of {C6_READS} reads lacked a field "
                        f"(read, {{worker: fields}}): {record}; origin expiries {expiries}")


@rt.remote
class _Trainer:
    def run(self, steps):
        from ray_tpu_torch.util import perf

        prof = perf.StepProfiler(flops_per_token=1e6, tokens_per_step=1000, device="cpu",
                                 peak=1e12, rank=3, hbm_every=1)
        fn = prof.wrap_jit(lambda x: float(x.sum()), name="rt_ra_step")
        for i in range(steps):
            with prof.step(tokens=1000):
                with prof.phase("ingest"):
                    time.sleep(0.002)
                fn(np.ones(1000 + i % 2))
        return prof.summary()["steps"]


def test_perf_summary_and_cli_read_a_profiled_loop(ra_cluster):
    t = _Trainer.remote()
    assert rt.get(t.run.remote(8), timeout=T) == 8

    def summary():
        s = state.perf_summary(window_s=300)
        mine = [k for k in s["steps"]["last_mfu"] if k.endswith(":rank3")]
        return s if s["steps"]["count"] >= 8 and mine else None
    s = _wait_for(summary)
    assert set(s["steps"]["phases"]) >= {"ingest", "compile", "compute"}
    assert sum(p["frac"] for p in s["steps"]["phases"].values()) == pytest.approx(1.0, abs=1e-3)
    assert any(k.endswith(":rank3") for k in s["steps"]["last_mfu"])
    comp = [e for e in s["compiles"] if e["fn"] == "rt_ra_step"]
    assert comp and comp[0]["n_sigs"] == 2
    _wait_for(lambda: state.perf_summary(window_s=300)["mfu_trend"])
    code, out = _cli("perf")
    assert code == 0 and "profiled steps" in out and "live MFU" in out
    rt.kill(t)


def test_the_agent_samples_its_own_workers_and_the_head_none_of_them(ra_cluster):
    """A worker on the agent's node is sampled by the agent alone (its
    ``ray_tpu_proc_rss_mb`` series carry the agent's node as origin, and
    none from the head names its pid), and ``top`` shows its RSS; the
    agent reports itself too."""
    node_b = ra_cluster.agent_node

    @rt.remote(scheduling_strategy=NodeAffinitySchedulingStrategy(node_b))
    def where():
        return os.environ["RAY_TPU_TORCH_WORKER_ID"], os.getpid()

    wid, pid = rt.get(where.remote(), timeout=T)

    def sampled():
        q = state.query_metric("ray_tpu_proc_rss_mb", window_s=60)
        rows = [s["tags"] for s in q["series"] if s["tags"].get("pid") == str(pid)]
        agent = [s["tags"] for s in q["series"] if s["tags"].get("entity") == "agent"]
        return (rows, agent) if rows and agent else None
    rows, agent = _wait_for(sampled)
    assert {r["origin"] for r in rows} == {node_b}
    assert {r["worker_id"] for r in rows} == {wid}
    assert agent[0]["node"] == node_b
    _wait_for(lambda: any(w["worker_id"] == wid and w.get("rss_mb")
                          for w in state.top_snapshot()["workers"]))


@rt.remote
class _Cold:
    def wid(self):
        return os.environ["RAY_TPU_TORCH_WORKER_ID"]


def test_a_cold_started_agent_worker_is_not_a_leak(ra_cluster):
    """A worker that the agent starts cold imports torch under the
    sampler: its RSS climbs by about 200 MB over a dozen 0.2 s samples.
    Its history starts at its own first push, so the doctor's
    ``rss_growth`` rule does not read the start-up as a leak, and the
    series it keeps is flat."""
    from ray_tpu_torch.util.doctor import RSS_GROWTH_MIN_MB, run_doctor

    a = _Cold.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
        ra_cluster.agent_node)).remote()
    try:
        wid = rt.get(a.wid.remote(), timeout=T)

        def history():
            q = state.query_metric("ray_tpu_proc_rss_mb", window_s=60,
                                   tags={"worker_id": wid})
            pts = [v for s in q["series"] for _, v in s["points"]]
            return pts if len(pts) >= 3 else None
        pts = _wait_for(history)
        time.sleep(0.8)
        leaks = [f["evidence"] for f in run_doctor() if f["rule"] == "rss_growth"]
    finally:
        rt.kill(a)
    assert not leaks, leaks
    assert max(pts) - min(pts) < RSS_GROWTH_MIN_MB, pts


def test_cli_commands_exit_zero_against_the_cluster(ra_cluster):
    """``python -m ray_tpu_torch metrics``, ``top --iterations 1``,
    ``memory``, ``perf`` and ``doctor`` as separate processes against this
    cluster (its address and key in the environment): each exits 0,
    ``doctor`` 1 exactly when the head reports findings."""
    host, port = global_worker.node.tcp_address
    env = {**os.environ, "RAY_TPU_TORCH_ADDRESS": f"tcp://{host}:{port}",
           "RAY_TPU_TORCH_AUTHKEY": global_worker.node.authkey.hex()}
    want_doctor = 1 if state.doctor_report() else 0
    for argv, want, text in ((["metrics"], 0, "ray_tpu_proc_rss_mb"),
                             (["top", "--iterations", "1"], 0, "ray_tpu_torch top"),
                             (["memory"], 0, "ray_tpu_torch memory"),
                             (["perf"], 0, "ray_tpu_torch perf"),
                             (["doctor"], want_doctor, "ray_tpu_torch doctor")):
        out = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *argv], cwd=ROOT,
                             env=env, capture_output=True, text=True, timeout=T)
        assert out.returncode == want, (argv, out.stdout[-2000:], out.stderr[-2000:])
        assert text in out.stdout, (argv, out.stdout[-2000:])


@rt.remote
class _Allocator:
    """Allocates ``steps`` blocks of ``mb`` MB, ``step_s`` apart, in its
    constructor (the shape of a stage that builds its model there) and
    again in ``grow``."""

    def __init__(self, steps, step_s, mb=25):
        self.blocks = []
        self.grow(steps, step_s, mb)

    def wid(self):
        return os.environ["RAY_TPU_TORCH_WORKER_ID"]

    def grow(self, steps, step_s, mb=25):
        for _ in range(steps):
            self.blocks.append(b"\x01" * (mb << 20))  # written, so resident
            time.sleep(step_s)
        return self.wid()


def _rss_growth_workers():
    from ray_tpu_torch.util.doctor import run_doctor

    return {f["evidence"][0]["tags"].get("worker_id") for f in run_doctor()
            if f["rule"] == "rss_growth"}


def test_a_workers_series_starts_after_its_warm_up():
    """C12: the head keeps a worker's ``/proc`` rows from
    ``WORKER_WARMUP_S`` (10 s) after its first task or constructor on, or
    from ``WORKER_START_BOUND_S`` (60 s) after it registered if that comes
    first; the head's own rows always, and no row of a worker it does not
    know."""
    from ray_tpu_torch._private.node import Node
    from ray_tpu_torch._private.resource_spec import PROC_RSS_MB

    assert (Node.WORKER_WARMUP_S, Node.WORKER_START_BOUND_S) == (10.0, 60.0)
    head = Node.__new__(Node)  # _history_rows reads only the map of start times
    now = time.time()
    head._history_from = {"warm": now - 0.5, "warming": now + 1.0}
    key = lambda wid: (("entity", "worker"), ("worker_id", wid))  # noqa: E731
    snap = {PROC_RSS_MB: {"type": "gauge", "help": "", "values": {
        key("warm"): 1.0, key("warming"): 2.0, key("booting"): 3.0,
        (("entity", "head"),): 4.0}}}
    kept = head._history_rows(snap)[PROC_RSS_MB]["values"]
    assert sorted(kept.values()) == [1.0, 4.0]


def test_an_actor_that_allocates_in_its_constructor_is_not_a_leak(ra_cluster):
    """C12: a worker's trend series starts a warm-up after its first
    finished task or actor constructor.  An actor whose constructor
    allocates 300 MB in 12 steps at a 0.2 s push, then idles, opens no
    ``rss_growth``; the series the TSDB keeps for it is flat."""
    from ray_tpu_torch.util.doctor import RSS_GROWTH_MIN_MB, TREND_MIN_POINTS

    a = _Allocator.remote(12, 0.25)
    try:
        wid = rt.get(a.wid.remote(), timeout=T)

        def history():
            q = state.query_metric("ray_tpu_proc_rss_mb", window_s=120,
                                   tags={"worker_id": wid})
            pts = [v for s in q["series"] for _, v in s["points"]]
            return pts if len(pts) >= TREND_MIN_POINTS else None
        pts = _wait_for(history)
        assert wid not in _rss_growth_workers()
    finally:
        rt.kill(a)
    assert max(pts) - min(pts) < RSS_GROWTH_MIN_MB, pts


def test_an_actor_that_keeps_allocating_after_its_constructor_is_a_leak(ra_cluster):
    """The other half of C12: after its constructor, an actor that keeps
    allocating (4 MB every 0.1 s for 8 s) reads as ``rss_growth`` naming
    its worker while it grows."""
    a = _Allocator.remote(0, 0.0)
    try:
        wid = rt.get(a.wid.remote(), timeout=T)
        a.grow.remote(80, 0.1, 4)
        _wait_for(lambda: wid in _rss_growth_workers(), timeout=20)
    finally:
        rt.kill(a)


def test_a_task_that_keeps_allocating_in_its_first_call_is_a_leak(ra_cluster, tmp_path):
    """C12's bound: a fresh worker (its own ``env_vars``) whose first task
    keeps allocating (2 MB every 0.1 s) gets its series
    ``WORKER_START_BOUND_S`` (8 s here) after it registered, while that
    task still runs, and reads as ``rss_growth`` naming it."""
    stop, wid_file = tmp_path / "stop", tmp_path / "wid"

    @rt.remote(max_retries=0, runtime_env={"env_vars": {"RA_FIRST_CALL_LEAK": "1"}})
    def leak(stop, wid_file, limit_s):
        with open(wid_file, "w") as f:
            f.write(os.environ["RAY_TPU_TORCH_WORKER_ID"])
        blocks, t0 = [], time.monotonic()
        while not os.path.exists(stop) and time.monotonic() - t0 < limit_s:
            blocks.append(b"\x01" * (2 << 20))  # written, so resident
            time.sleep(0.1)
        return len(blocks)

    ref = leak.remote(str(stop), str(wid_file), 40.0)
    try:
        wid = _wait_for(lambda: wid_file.exists() and wid_file.read_text())
        _wait_for(lambda: wid in _rss_growth_workers(), timeout=30)
    finally:
        stop.touch()
    assert rt.get(ref, timeout=T) < 400  # it ended on the stop, not its limit


def test_a_later_head_in_the_same_process_reports_only_its_own_events():
    """The process's event ring outlives ``shutdown``: three worker deaths
    an earlier session left in it are not a later head's.  Its
    ``list_events``, ``doctor_report`` and ``perf_summary`` read only what
    was emitted since its own start, and the doctor's ``worker_churn``
    rule fires on this session's own deaths alone."""
    code = (
        "import ray_tpu_torch as rt\n"
        "from ray_tpu_torch._private import events\n"
        "from ray_tpu_torch.experimental.state import api as state\n"
        "for i in range(3):\n"
        "    events.emit('worker_pool', f'worker died: earlier {i}', severity='WARNING')\n"
        "    events.emit('perf', 'step phases', severity='DEBUG', wall_s=1.0,\n"
        "                phases={'ingest': 0.9, 'other': 0.1})\n"
        "rt.init(num_cpus=1, num_gpus=0)\n"
        "try:\n"
        "    rows = state.list_events(limit=1000, source='worker_pool')\n"
        "    assert not [r for r in rows if 'earlier' in r['message']], rows\n"
        "    assert state.doctor_report() == []\n"
        "    assert state.perf_summary()['steps']['count'] == 0\n"
        "    for i in range(3):\n"
        "        events.emit('worker_pool', f'worker died: now {i}', severity='WARNING')\n"
        "    found = state.doctor_report()\n"
        "    assert [f['rule'] for f in found] == ['worker_churn'], found\n"
        "    assert all('now' in e['message'] for e in found[0]['evidence']), found\n"
        "finally:\n"
        "    rt.shutdown()\n")
    with tempfile.TemporaryDirectory(prefix="ral_") as d:  # short: the head's unix socket
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             env={**os.environ, "TMPDIR": d},
                             capture_output=True, text=True, timeout=T)
    assert out.returncode == 0, out.stderr[-3000:]
