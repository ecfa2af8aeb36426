"""The port's trend autoscaling (``autoscaler/policy.py``) against the
JAX package's: ``TrendPolicy.decide`` on ``tests/test_autoscaler_policy.py``'s
series and on seeded ones, with the doctor silent on the same series;
then ``TrendAutoscaler`` on the port's CPU runtime: a queue climb in the
head's TSDB launches a node (a recording provider, then a real node agent
through ``LocalNodeProvider``) and lands in the flight recorder, the
slice fallback of the idle check, a slice's capacity in the bin-pack, the
replica scaler over the port's Serve controller, and slice repair.

Decisions are held equal exactly (action, reason, amount, deployment,
evidence).  No JAX runtime starts; every runtime here runs under a
private ``TMPDIR``, and every test has its own time limit.
"""

import dataclasses
import signal
import tempfile
import time

import numpy as np
import pytest

from ray_tpu.autoscaler import policy as jax_policy
from ray_tpu.util.doctor import diagnose_trends as jax_diagnose_trends
from ray_tpu_torch.autoscaler import (
    AutoscalingConfig,
    Decision,
    TrendAutoscaler,
    TrendPolicy,
    TrendPolicyConfig,
)
from ray_tpu_torch.autoscaler import policy
from ray_tpu_torch.autoscaler.node_provider import NodeProvider
from ray_tpu_torch.util.doctor import diagnose_trends

LIMIT = 150  # seconds: each test's own limit
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


def _series(name, points, tags=None):
    return {name: [{"tags": tags or {}, "points": points}]}


def _ramp(start, end, n=8, t0=0.0, dt=60.0):
    return [[t0 + i * dt, start + (end - start) * i / (n - 1)] for i in range(n)]


def _decide(sm, now=1000.0, **cfg):
    """Both packages' policies on the same series; the decisions must be
    equal field for field."""
    port = TrendPolicy(TrendPolicyConfig(**cfg)).decide(sm, now=now)
    ref = jax_policy.TrendPolicy(jax_policy.TrendPolicyConfig(**cfg)).decide(sm, now=now)
    assert [dataclasses.asdict(d) for d in port] == [dataclasses.asdict(d) for d in ref]
    return port


def test_queue_slope_scales_up_before_doctor_would_fire():
    sm = _series("ray_tpu_sched_queue_depth", _ramp(10, 17))
    decisions = _decide(sm)
    assert [d.action for d in decisions] == ["scale_up_nodes"]
    assert decisions[0].reason == "queue_depth_slope"
    assert decisions[0].evidence["slope_per_min"] >= 1.0
    assert diagnose_trends(sm) == jax_diagnose_trends(sm) == []


def test_queue_decision_respects_cooldown():
    sm = _series("ray_tpu_sched_queue_depth", _ramp(10, 20))
    pols = (TrendPolicy(TrendPolicyConfig(cooldown_s=60.0)),
            jax_policy.TrendPolicy(jax_policy.TrendPolicyConfig(cooldown_s=60.0)))
    for now, fires in ((1000.0, True), (1030.0, False), (1061.0, True)):
        got = [bool(p.decide(sm, now=now)) for p in pols]
        assert got == [fires, fires]


def test_router_backlog_scales_replicas_per_deployment():
    sm = _series("ray_tpu_serve_router_queue_len", [[i * 10.0, 3.0] for i in range(8)],
                 tags={"deployment": "bert"})
    decisions = _decide(sm)
    assert len(decisions) == 1
    d = decisions[0]
    assert d.action == "scale_up_replicas" and d.deployment == "bert" and d.amount >= 1
    assert _decide(_series("ray_tpu_serve_router_queue_len", _ramp(6, 1),
                           tags={"deployment": "bert"})) == []


def test_rss_trend_acts_below_doctor_leak_threshold():
    sm = _series("ray_tpu_proc_rss_mb", _ramp(100, 140, n=10, dt=30.0),
                 tags={"worker_id": "w1"})
    decisions = _decide(sm)
    assert [d.action for d in decisions] == ["scale_up_nodes"]
    assert decisions[0].reason == "rss_trend"
    assert diagnose_trends(sm) == jax_diagnose_trends(sm) == []


def test_short_or_flat_series_never_decide():
    sm = {}
    sm.update(_series("ray_tpu_sched_queue_depth", _ramp(10, 20, n=3)))
    sm.update(_series("ray_tpu_proc_rss_mb", [[i * 30.0, 100.0] for i in range(10)]))
    assert _decide(sm) == []


@pytest.mark.parametrize("seed", range(5))
def test_seeded_series_give_equal_decisions(seed):
    """Seeded queue, router and RSS series of several label sets, with
    noise, plateaus and drains, under two configs: equal decisions."""
    rng = np.random.default_rng(seed)
    sm = {}
    for name, base, slope in (("ray_tpu_sched_queue_depth", 5.0, 1.5),
                              ("ray_tpu_serve_router_queue_len", 1.0, 0.05),
                              ("ray_tpu_proc_rss_mb", 100.0, 6.0)):
        rows = []
        for k in range(4):
            n = int(rng.integers(3, 14))
            s = slope * float(rng.uniform(-0.5, 1.5))
            pts = [[30.0 * i, max(0.0, base + s * i + float(rng.normal(0, 0.5)))]
                   for i in range(n)]
            tags = ({"deployment": f"d{k}"} if "router" in name else {"worker_id": f"w{k}"})
            rows.append({"tags": tags, "points": pts})
        sm[name] = rows
    _decide(sm)
    _decide(sm, min_points=4, queue_ratio=1.2, rss_growth_min_mb=8.0, max_step=3)


def test_policy_defaults_and_metric_names_match_jax():
    assert dataclasses.asdict(TrendPolicyConfig()) == dataclasses.asdict(
        jax_policy.TrendPolicyConfig())
    assert policy.POLICY_METRICS == jax_policy.POLICY_METRICS


# -- TrendAutoscaler on the port's runtime -------------------------------------

class _RecordingProvider(NodeProvider):
    def __init__(self):
        super().__init__({}, "rec")
        self.created = []
        self.nodes = []

    def non_terminated_nodes(self):
        return list(self.nodes)

    def create_node(self, node_config, count=1):
        ids = [f"rec-{len(self.nodes) + i}" for i in range(count)]
        self.nodes += ids
        self.created.append((dict(node_config), count))
        return ids

    def terminate_node(self, node_id):
        self.nodes.remove(node_id)


@pytest.fixture
def runtime():
    """A fresh port runtime a test (a decision reads the whole TSDB)."""
    import ray_tpu_torch as rt

    with tempfile.TemporaryDirectory(prefix="policy_") as d, pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMPDIR", d)
        mp.setattr(tempfile, "tempdir", d)
        rt.init(num_cpus=2, num_gpus=0)
        try:
            yield rt
        finally:
            rt.shutdown()


def _node():
    from ray_tpu_torch._private.worker import global_worker

    return global_worker.node


def _ingest_queue_climb(node):
    now = time.time()
    for i in range(10):
        node.tsdb.ingest("head", {"ray_tpu_sched_queue_depth": {
            "type": "gauge", "help": "", "values": {(): 10.0 + i}}}, ts=now - (10 - i) * 30.0)


def test_trend_autoscaler_scales_from_live_tsdb_and_emits_event(runtime):
    from ray_tpu_torch.experimental.state import api as state

    node = _node()
    prov = _RecordingProvider()
    scaler = TrendAutoscaler(node, prov, AutoscalingConfig(min_workers=0, max_workers=4,
                                                           idle_timeout_s=3600.0))
    _ingest_queue_climb(node)
    scaler.update()
    assert prov.created, "no node launched from the TSDB trend"
    deadline = time.time() + 20
    rows = []
    while time.time() < deadline and not rows:
        rows = [e for e in state.list_events(limit=5000, source="autoscaler")
                if "scale decision" in e.get("message", "")]
        time.sleep(0.2)
    assert rows, "scale decision never reached the flight recorder"
    d = rows[-1].get("data") or {}
    assert d.get("reason") == "queue_depth_slope" and d.get("action") == "scale_up_nodes"


def test_idle_check_falls_back_to_head_slice_index(runtime):
    node = _node()
    prov = _RecordingProvider()
    prov.nodes = ["prov-slice-1"]
    scaler = TrendAutoscaler(node, prov, AutoscalingConfig(min_workers=0, idle_timeout_s=0.0))
    node.add_node_state("h0", {"CPU": 1.0}, slice_id="prov-slice-1")
    node.add_node_state("h1", {"CPU": 1.0}, slice_id="prov-slice-1")
    try:
        assert scaler._slice_members("prov-slice-1") == ["h0", "h1"]
        assert scaler._node_is_idle("prov-slice-1")
        with node.lock:
            node.nodes["h0"].available["CPU"] = 0.0
        assert not scaler._node_is_idle("prov-slice-1")
        scaler.update()
        assert prov.nodes == ["prov-slice-1"], "idle scale-down killed a busy slice"
    finally:
        node.remove_node_state("h0")
        node.remove_node_state("h1")


def test_scale_up_counts_whole_slice_capacity(runtime):
    """Card demand the card-less head cannot take bin-packs against one
    provider node's capacity (4 hosts with a card each): one slice, not
    four."""
    node = _node()
    prov = _RecordingProvider()
    scaler = TrendAutoscaler(node, prov, AutoscalingConfig(
        min_workers=0, max_workers=8, upscaling_speed=8, idle_timeout_s=3600.0,
        worker_node={"num_cpus": 1, "num_gpus": 1, "slice_hosts": 4}))
    with node.lock:
        for _ in range(4):
            node.pending_tasks.append({"resources": {"GPU": 1.0}})
    try:
        scaler.update()
        assert len(prov.created) == 1 and prov.created[0][1] == 1, prov.created
    finally:
        with node.lock:
            node.pending_tasks.clear()
            node._starved.clear()


def test_replica_decisions_go_through_replica_scaler(runtime):
    prov = _RecordingProvider()
    calls = []
    scaler = TrendAutoscaler(_node(), prov, AutoscalingConfig(idle_timeout_s=3600.0),
                             replica_scaler=lambda dep, n: calls.append((dep, n)))
    scaler.apply(Decision("scale_up_replicas", "router_backlog", amount=2, deployment="bert"))
    assert calls == [("bert", 2)]


class _SliceProvider(_RecordingProvider):
    """Provider nodes that are 2-host slices whose members the head
    knows; ``replace_slice`` comes from ``NodeProvider``."""

    def __init__(self, node):
        super().__init__()
        self.node = node

    def create_node(self, node_config, count=1):
        ids = super().create_node(node_config, count)
        for sid in ids:
            for h in range(2):
                self.node.add_node_state(f"{sid}-h{h}", {"CPU": 1.0}, slice_id=sid)
        return ids

    def slice_members(self, node_id):
        return [f"{node_id}-h{h}" for h in range(2)]

    def terminate_node(self, node_id):
        super().terminate_node(node_id)
        for m in self.slice_members(node_id):
            self.node.remove_node_state(m)


def test_repair_replaces_a_slice_with_a_dead_member(runtime):
    """One dead member host makes the slice degraded; ``repair_slices``
    creates the replacement first, then terminates the old slice, with
    its start and end in the flight recorder and ``list_slices`` showing
    the new slice healthy."""
    from ray_tpu_torch.experimental.state import api as state

    node = _node()
    prov = _SliceProvider(node)
    scaler = TrendAutoscaler(node, prov, AutoscalingConfig(min_workers=0, max_workers=4,
                                                           idle_timeout_s=3600.0))
    (sid,) = prov.create_node({"num_cpus": 1}, 1)
    try:
        rows = {r["slice_id"]: r for r in state.list_slices()}
        assert rows[sid]["alive_members"] == 2 and not rows[sid]["degraded"]
        with node.lock:
            node.nodes[f"{sid}-h1"].alive = False
        assert {r["slice_id"]: r for r in state.list_slices()}[sid]["degraded"]
        replaced = scaler.repair_slices()
        assert [old for old, _ in replaced] == [sid]
        new = replaced[0][1]
        assert prov.nodes == [new] and prov.created[-1][1] == 1
        rows = {r["slice_id"]: r for r in state.list_slices()}
        assert rows[sid]["alive_members"] == 0 and rows[new]["alive_members"] == 2
        assert not rows[new]["degraded"]
        msgs = [e["message"] for e in state.list_events(limit=5000, source="autoscaler")]
        assert "slice replacement started" in msgs and "slice replaced" in msgs
    finally:
        for n in list(prov.nodes):
            prov.terminate_node(n)


def test_serve_replica_scaler_grows_a_deployments_goal(runtime):
    """``serve_replica_scaler`` calls the port's controller, which grows
    the deployment's replica goal by the decision's amount."""
    rt = runtime
    from ray_tpu_torch import serve

    @serve.deployment(num_replicas=1)
    class Echo:
        def __call__(self, request):
            return "ok"

    serve.run(Echo.bind(), port=0, timeout_s=T)
    try:
        scale = policy.serve_replica_scaler()
        scale("Echo", 1)
        deadline = time.time() + T
        while time.time() < deadline:
            if serve.status()["Echo"]["num_replicas_goal"] == 2:
                break
            time.sleep(0.2)
        assert serve.status()["Echo"]["num_replicas_goal"] == 2
    finally:
        serve.shutdown()


def test_trend_autoscaler_launches_a_real_agent_through_local_provider(runtime):
    """A queue climb in the head's TSDB makes ``TrendAutoscaler`` launch
    a real node agent through the port's ``LocalNodeProvider``; the agent
    joins, and terminating it leaves the cluster."""
    from ray_tpu_torch.autoscaler import LocalNodeProvider

    node = _node()
    prov = LocalNodeProvider(node)
    scaler = TrendAutoscaler(node, prov, AutoscalingConfig(
        min_workers=0, max_workers=1, idle_timeout_s=3600.0, worker_node={"num_cpus": 1}))
    _ingest_queue_climb(node)
    try:
        scaler.update()
        (nid,) = prov.non_terminated_nodes()
        deadline = time.time() + T
        while time.time() < deadline:
            with node.lock:
                ns = node.nodes.get(nid)
                if ns is not None and ns.alive:
                    break
            time.sleep(0.2)
        with node.lock:
            assert node.nodes[nid].alive and node.nodes[nid].total["CPU"] == 1.0
    finally:
        prov.shutdown()
    deadline = time.time() + T
    while time.time() < deadline:
        with node.lock:
            if not any(ns.alive for n, ns in node.nodes.items() if n != "node-head"):
                break
        time.sleep(0.2)
    with node.lock:
        assert not any(ns.alive for n, ns in node.nodes.items() if n != "node-head")
