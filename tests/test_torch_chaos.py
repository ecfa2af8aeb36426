"""The port's chaos harness (``ray_tpu_torch.devtools.chaos``) against the
JAX package's, with the chaos cases of ``tests/test_slice_recovery.py``
and ``tests/test_serve_chaos.py`` run on the port's runtime alone (no JAX
head).

The harness's seeded picks are a pure function of the seed and the node
set: both packages' ``ChaosMonkey.pick`` walk the same sequence over the
same fake head.  The live cases are cut to size: a slice of 2 real agent
processes (the JAX test's 16 hold a training gang) takes a scheduled
drop, pause, slow window and SIGKILL; a Serve deployment of 2 replicas
under 16 keep-alive clients (the JAX test: 64) loses one to
``kill_serve_replica``.  Every process runs under a private ``TMPDIR``
and each test has its own time limit.
"""

import http.client
import os
import signal
import tempfile
import threading
import time
from dataclasses import dataclass

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.worker import global_worker

T = 60  # seconds: every wait in this file


@pytest.fixture(autouse=True)
def time_limit(request):
    def expired(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past its 90 s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(90)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old if old is not None else signal.SIG_DFL)


@pytest.fixture
def private_tmp():
    with tempfile.TemporaryDirectory(prefix="chaos_") as tmp, \
            pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMPDIR", tmp)
        mp.setattr(tempfile, "tempdir", tmp)
        yield tmp


def _wait_for(fn, timeout=T, interval=0.1, desc="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = fn()
        if v:
            return v
        time.sleep(interval)
    raise AssertionError(f"{desc} not met within {timeout}s")


# -- seeded targeting, against the JAX harness --------------------------------

@dataclass
class _FakeNodeState:
    node_id: str
    alive: bool
    slice_id: str


class _FakeHead:
    def __init__(self, rows):
        self.lock = threading.Lock()
        self.nodes = {r.node_id: r for r in rows}


@pytest.mark.parametrize("seed", [0, 1, 7, 42])
def test_seeded_picks_match_the_jax_harness(seed):
    """The same head (6 hosts in two slices, one dead, one with no pid)
    and seed give both harnesses the same sequence of targets, per slice
    and over every node."""
    from ray_tpu.devtools.chaos import ChaosMonkey as JaxMonkey

    from ray_tpu_torch.devtools.chaos import ChaosMonkey

    rows = [_FakeNodeState(f"n{i}", alive=i != 2, slice_id="s0" if i < 4 else "s1")
            for i in range(6)]
    procs = {f"n{i}": 1000 + i for i in range(6) if i != 5}
    ours = ChaosMonkey(node=_FakeHead(rows), procs=procs, seed=seed)
    ref = JaxMonkey(node=_FakeHead(rows), procs=procs, seed=seed)
    for slice_id in ("s0", None, "s1", "s0", None, "s0", "s1", None):
        assert ours.pick(slice_id) == ref.pick(slice_id)
    assert ours.members_of_slice("s0") == ref.members_of_slice("s0") == ["n0", "n1", "n3"]
    with pytest.raises(RuntimeError, match="no targetable node"):
        ChaosMonkey(node=_FakeHead(rows), procs={}, seed=seed).pick("s1")


def test_unknown_op_is_refused():
    from ray_tpu_torch.devtools.chaos import ChaosMonkey, Injection

    with pytest.raises(ValueError, match="unknown chaos op"):
        ChaosMonkey(node=_FakeHead([]), procs={}).inject(Injection(0.0, "melt", target="x"))


# -- a slice of real agents under a seeded schedule ---------------------------

def test_a_scheduled_slice_chaos_run_lands_on_the_flight_recorder(private_tmp):
    """Two agent processes form slice ``s0``: a scheduled drop, pause and
    slow window hit them, then a seeded SIGKILL of a member.  Every
    injection fires in order and lands on the flight recorder (source
    ``chaos``), the head sees the member die, and the doctor reads the
    slice as degraded."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.devtools.chaos import ChaosMonkey, Injection
    from ray_tpu_torch.util.doctor import diagnose

    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 1, "num_gpus": 0},
                real_processes=True)
    try:
        members = [c.add_node(num_cpus=1, slice_id="s0") for _ in range(2)]
        node = global_worker.node
        _wait_for(lambda: all(node.nodes[m].alive for m in members), desc="agents up")
        cm = ChaosMonkey(node=node, procs=dict(c.agents), seed=7, schedule=[
            Injection(at_s=0.0, op="drop", target=members[0], frac=1.0, duration_s=0.3),
            Injection(at_s=0.1, op="pause", target=members[1], duration_s=0.3),
            Injection(at_s=0.2, op="slow", target=members[0], duration_s=0.3, duty=0.5),
            Injection(at_s=0.8, op="sigkill", slice_id="s0"),
        ]).start()
        _wait_for(lambda: len(cm.injections) >= 5, desc="the schedule's injections")
        ops = [r["op"] for r in cm.injections]
        assert ops[:3] == ["drop", "pause", "slow"] and "sigkill" in ops and "resume" in ops
        victim = next(r for r in cm.injections if r["op"] == "sigkill")
        assert victim["target"] in members and victim["slice_id"] == "s0"
        _wait_for(lambda: not node.nodes[victim["target"]].alive, desc="the member's death")
        events = node._list_state_page("events", 100_000, {"source": "chaos"})[0]
        got = [e["message"] for e in events]
        assert {"inject drop", "inject pause", "inject slow", "inject resume",
                "inject sigkill"} <= set(got), got
        rows = node._list_state_page("events", 100_000)[0]
        assert "slice_degraded" in {f["rule"] for f in diagnose(rows)}
        cm.stop()
    finally:
        c.shutdown()


# -- a Serve replica killed under load ----------------------------------------

class _SoakStats:
    def __init__(self):
        self.lock = threading.Lock()
        self.latencies = []   # (t_end, served-attempt latency) per 200
        self.lost = []        # 500/504: accepted, then failed
        self.refused = 0      # only ever 503s
        self.errors = []      # transport failures


def _soak(port, path, n_clients, duration_s, deadline_s=30.0):
    """Closed-loop keep-alive clients (the JAX test's): a 503 waits out
    Retry-After and retries; a request is lost only if it was accepted and
    then failed."""
    stats = _SoakStats()
    t_end = time.monotonic() + duration_s

    def client_loop():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=T)
        try:
            while time.monotonic() < t_end:
                req_deadline = time.monotonic() + deadline_s
                while True:
                    t_a = time.monotonic()
                    try:
                        conn.request("GET", path, headers={"X-Serve-Deadline-S": f"{deadline_s}"})
                        resp = conn.getresponse()
                        body = resp.read()
                        status = resp.status
                    except Exception as e:  # noqa: BLE001 — a transport failure
                        conn.close()
                        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=T)
                        if time.monotonic() >= req_deadline:
                            with stats.lock:
                                stats.errors.append(repr(e))
                            break
                        continue
                    if status == 200:
                        with stats.lock:
                            stats.latencies.append((time.monotonic(), time.monotonic() - t_a))
                        break
                    if status == 503 and time.monotonic() < req_deadline:
                        time.sleep(min(float(resp.headers.get("Retry-After") or 0.2), 0.5))
                        continue
                    with stats.lock:
                        if status == 503:
                            stats.refused += 1
                        else:
                            stats.lost.append((status, body[:200]))
                    break
        finally:
            conn.close()

    threads = [threading.Thread(target=client_loop, name=f"soak-{i}") for i in range(n_clients)]
    for t in threads:
        t.start()
    return stats, threads


def _p99(vals):
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(len(vals) * 0.99))] if vals else 0.0


def test_chaos_soak_replica_kill(private_tmp):
    """``kill_serve_replica`` mid-soak: no request lost, no transport
    error, the replica replaced, the ingress's deaths and retries grew,
    p99 under 10 s, the injection on record, and no open
    ``ingress_shedding`` or ``drain_stuck`` (the gates of
    ``tests/test_serve_chaos.py:174-300`` without its watchdog block)."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.devtools.chaos import ChaosMonkey
    from ray_tpu_torch.experimental.state import api as state
    from ray_tpu_torch.util import doctor

    ray_tpu_torch.init(num_cpus=6, num_gpus=0)
    try:
        client = serve.start(serve.HTTPOptions(host="127.0.0.1", port=0))

        @serve.deployment(name="Soak16", num_replicas=2, max_concurrent_queries=64,
                          max_queued_requests=512, ray_actor_options={"max_concurrency": 64})
        class Soak:
            def __call__(self, request=None):
                time.sleep(0.03)
                return "ok"

        serve.run(Soak.bind(), port=0)
        _, port = serve.get_http_address()
        stats0 = ray_tpu_torch.get(client.proxy.ingress_stats.remote(), timeout=T)
        stats, threads = _soak(port, "/Soak16", 16, 5.0)
        time.sleep(1.5)
        t_kill = time.monotonic()
        rec = ChaosMonkey().kill_serve_replica("Soak16", controller=client.controller)
        assert rec["op"] == "kill_replica" and rec["pid"] > 0
        dead_tag = rec["target"]

        def replaced():
            info = ray_tpu_torch.get(client.controller.get_routing_info.remote("Soak16"),
                                     timeout=T)
            tags = {t for t, _ in info["replicas"]}
            return dead_tag not in tags and len(tags) >= 2
        _wait_for(replaced, interval=0.25, desc="the dead replica's replacement")
        recovery_s = time.monotonic() - t_kill
        for t in threads:
            t.join(timeout=T)
        assert not any(t.is_alive() for t in threads), "soak clients wedged"
        assert stats.lost == [], f"lost idempotent requests: {stats.lost[:5]}"
        assert stats.errors == [], f"transport failures: {stats.errors[:5]}"
        assert len(stats.latencies) > 16, "the soak made no progress"
        during = [l for ts, l in stats.latencies if 0 <= ts - t_kill <= max(recovery_s, 2.0)]
        assert _p99(during) < 10.0
        stats1 = ray_tpu_torch.get(client.proxy.ingress_stats.remote(), timeout=T)
        assert stats1["replica_deaths"] > stats0["replica_deaths"]
        assert stats1["retries"] > stats0["retries"]
        rows = _wait_for(lambda: (lambda r: r if any(
            e.get("source") == "chaos" and e.get("message") == "inject kill_replica"
            for e in r) else None)(state.list_events(limit=100_000)),
            desc="the injection on record")
        open_rules = {f["rule"] for f in doctor.diagnose(rows)}
        assert "ingress_shedding" not in open_rules and "drain_stuck" not in open_rules
        serve.delete("Soak16")
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
