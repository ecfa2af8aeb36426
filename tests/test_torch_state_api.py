"""The port's state API on a head with a fake-card agent: the head's
``list_state``/``summarize_state``/``get_trace`` handlers and
``ray_tpu_torch.experimental.state``.

One ``Cluster`` serves the module: a head with no card and a real agent
process holding one fake card (``add_node(num_gpus=1)``: the grant is
``CUDA_VISIBLE_DEVICES`` only).  A fixed scenario runs on it: 2 actors
(one on the card), 5 tasks (1 failing), 1 placement group and 1 put.
Every table's columns are held to the rows the JAX package's head makes
(``ray_tpu/_private/node.py`` ``_list_state_page``: the GCS dataclasses'
fields, the object registry's rows, the workers' literal, ``JobInfo``)
without a JAX head.  Each test has its own time limit.
"""

import ast
import dataclasses
import pathlib
import signal
import tempfile
import time
import warnings

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private.worker import global_worker
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.experimental import state
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.placement_group import placement_group

ROOT = pathlib.Path(__file__).resolve().parents[1]
T = 60  # seconds: every wait in this file


@pytest.fixture(autouse=True)
def time_limit(request):
    def expired(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past its 120 s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old if old is not None else signal.SIG_DFL)


@ray_tpu_torch.remote
def _ok(x):
    return x + 1


@ray_tpu_torch.remote(max_retries=0)
def _boom():
    raise ValueError("boom")


@ray_tpu_torch.remote
class _Keeper:
    def where(self):
        import os

        return ray_tpu_torch.get_runtime_context().node_id, os.environ.get("CUDA_VISIBLE_DEVICES")


def _until(fn, what, timeout=T):
    """Poll ``fn`` until it returns a truthy value (the head records a
    task's end just after its return is sealed)."""
    deadline = time.monotonic() + timeout
    while True:
        out = fn()
        if out:
            return out
        assert time.monotonic() < deadline, f"timed out on {what}"
        time.sleep(0.1)


@pytest.fixture(scope="module")
def scenario():
    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 2, "num_gpus": 0},
                      real_processes=True)
    try:
        agent = cluster.add_node(num_cpus=2, num_gpus=1)
        keepers = [_Keeper.remote(), _Keeper.options(num_gpus=1).remote()]
        places = ray_tpu_torch.get([k.where.remote() for k in keepers], timeout=T)
        assert ray_tpu_torch.get([_ok.remote(i) for i in range(4)], timeout=T) == [1, 2, 3, 4]
        with pytest.raises(Exception, match="boom"):
            ray_tpu_torch.get(_boom.remote(), timeout=T)
        pg = placement_group([{"CPU": 1}])
        assert pg.wait(T)
        ref = ray_tpu_torch.put(np.arange(1 << 16))
        yield {"agent": agent, "keepers": keepers, "places": places, "pg": pg, "ref": ref}
    finally:
        cluster.shutdown()


SCENARIO_TASKS = {"_ok": {"FINISHED": 4}, "_boom": {"FAILED": 1},
                  "_Keeper.where": {"FINISHED": 2}}


def test_summaries_count_the_scenario_exactly(scenario):
    def settled():
        got = state.summarize_tasks()
        return {k: got.get(k) for k in SCENARIO_TASKS} == SCENARIO_TASKS and got

    _until(settled, f"task summary {SCENARIO_TASKS}")
    assert state.summarize_actors() == {"_Keeper": {"ALIVE": 2}}
    events = state.summarize_events()
    assert events["node"]["INFO"] >= 2  # the head and the agent joined


def test_the_actor_with_the_card_sits_on_the_agent(scenario):
    agent = scenario["agent"]
    assert scenario["places"][0][0] in ("node-head", agent)
    assert scenario["places"][1] == (agent, "0")
    rows = {r["actor_id"]: r for r in state.list_actors()}
    card = rows[scenario["keepers"][1]._actor_id.hex()]
    assert card["node_id"] == agent and card["state"] == "ALIVE" and card["class_name"] == "_Keeper"


def test_node_rows_carry_the_card_and_its_availability(scenario):
    nodes = {r["node_id"]: r for r in state.list_nodes()}
    agent = nodes[scenario["agent"]]
    assert agent["alive"] and agent["resources"]["GPU"] == 1.0
    assert agent["available"]["GPU"] == 0.0  # held by the card actor
    assert nodes["node-head"]["resources"]["GPU"] == 0.0
    assert nodes["node-head"]["available"]["CPU"] <= nodes["node-head"]["resources"]["CPU"]
    assert ray_tpu_torch.cluster_resources()["GPU"] == 1.0


def _jax_fields(cls):
    return [f.name for f in dataclasses.fields(cls) if f.name != "creation_spec"]


def _jax_workers_columns():
    """The keys of the JAX head's ``workers`` row literal."""
    tree = ast.parse((ROOT / "ray_tpu" / "_private" / "node.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "_list_state_page")
    branch = next(n for n in ast.walk(fn) if isinstance(n, ast.If)
                  and isinstance(n.test, ast.Compare)
                  and getattr(n.test.comparators[0], "value", None) == "workers")
    row = next(n for n in ast.walk(branch) if isinstance(n, ast.Dict))
    return [k.value for k in row.keys]


def _jax_object_columns():
    from ray_tpu._private.object_store import ObjectRegistry

    with tempfile.TemporaryDirectory() as d:
        reg = ObjectRegistry(capacity_bytes=1 << 20, spill_dir=d)
        try:
            reg.create_pending_batch([b"\x01" * 16])
            return list(reg.list_objects(10)[0])
        finally:
            reg.shutdown()


def test_every_table_has_the_columns_of_the_jax_heads_rows(scenario):
    from ray_tpu._private import gcs as jax_gcs
    from ray_tpu._private import job_manager as jax_jm

    from ray_tpu_torch.job_submission import JobSubmissionClient

    job = JobSubmissionClient()
    job_id = job.submit_job(entrypoint="true")
    assert job.wait_until_finish(job_id, timeout=T) == "SUCCEEDED"
    want = {
        "actors": _jax_fields(jax_gcs.ActorInfo),
        # the port adds each node's available resources beside its totals
        "nodes": _jax_fields(jax_gcs.NodeInfo) + ["available"],
        "tasks": _jax_fields(jax_gcs.TaskInfo),
        "placement_groups": _jax_fields(jax_gcs.PlacementGroupInfo),
        "objects": _jax_object_columns(),
        "workers": _jax_workers_columns(),
        "jobs": _jax_fields(jax_jm.JobInfo),
    }
    for what, cols in want.items():
        rows = state.list_state_page(what, limit=10_000)["rows"]
        assert rows, what
        assert all(list(r) == cols for r in rows), (what, list(rows[0]), cols)


def test_event_and_trace_tables_match_the_jax_ones_on_the_same_rows():
    """The head's event and trace tables (copied modules) give the JAX
    package's rows for the same shipped events."""
    from ray_tpu._private import events as jax_events

    from ray_tpu_torch._private import events

    rng = np.random.default_rng(0)
    rows = []
    for i in range(40):
        r = {"ts": 1000.0 + float(rng.uniform(0, 10)), "source": ["node", "trace", "scheduler"][i % 3],
             "severity": ["INFO", "DEBUG", "WARNING"][int(rng.integers(3))],
             "message": f"m{i}", "entity_id": f"e{i % 5}", "seq": i + 1}
        if r["source"] == "trace":
            r["span_dur"] = float(rng.uniform(0, 1))
            r["data"] = {"trace_id": f"t{i % 4}", "span_id": f"s{i}",
                         "parent_span_id": "" if i < 4 else f"s{i - 3}"}
        rows.append(r)
    for limit, source, severity in ((1000, None, None), (7, None, None), (1000, "trace", None),
                                    (1000, None, "WARNING")):
        got = []
        for mod in (events, jax_events):
            table = mod.EventTable()
            table.add("origin-a", rows[:20])
            table.add("origin-b", rows[20:])
            got.append(table.list_with_total(limit, source=source, severity=severity))
        assert got[0] == got[1]
    traces = []
    for mod in (events, jax_events):
        table = mod.TraceTable()
        table.add("origin-a", rows)
        traces.append((table.list(100), table.get("t1"), table.summarize()))
    assert traces[0] == traces[1]


def test_truncation_is_loud(scenario):
    page = state.list_state_page("tasks", limit=2)
    assert page["truncated"] and len(page["rows"]) == 2 and page["total"] >= 7
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert len(state.list_tasks(limit=2)) == 2
    assert any("list_tasks truncated" in str(w.message) for w in caught)
    assert not state.list_state_page("placement_groups")["truncated"]


@ray_tpu_torch.remote
def _traced(x):
    return x * 2


def test_a_trace_shows_in_list_traces_and_get_trace(scenario):
    with tracing.trace("state-api-request") as ctx:
        assert ray_tpu_torch.get(_traced.remote(3), timeout=T) == 6
    tid = ctx["trace_id"]
    listed = _until(lambda: [r for r in state.list_traces() if r["trace_id"] == tid],
                    "the trace in list_traces")
    assert listed[0]["name"] == "state-api-request" and listed[0]["num_spans"] >= 1
    trace = _until(lambda: (lambda t: t if t and any(s["source"] == "task" and s["name"] == "_traced"
                                                      for s in t["spans"]) else None)(
        state.get_trace(tid)), "the task span in get_trace")
    names = {s["name"] for s in trace["spans"]}
    assert {"state-api-request", "_traced"} <= names
    assert trace["logs"] == [] and trace["dropped_spans"] == 0
    assert state.summarize_traces()["num_traces"] >= 1
    assert state.get_trace("no-such-trace") is None


@pytest.mark.parametrize("what", ["tenants"])
def test_the_tables_that_are_cut_give_a_state_error(scenario, what):
    """``tenants``, the table earlier slices cut, is kept now: its rows
    are the JAX head's columns (the driver directory and its live actor
    counts); a summary of it is refused, as the JAX head refuses one."""
    reply = global_worker.client.request({"type": "list_state", "what": what})
    rows = reply["value"]
    me = [r for r in rows if r["job_id"] == global_worker.job_id]
    assert set(me[0]) == {"job_id", "namespace", "pid", "proxied", "alive", "connected_at",
                          "job_name", "actors"}
    assert me[0]["alive"] and me[0]["actors"] == 2 and not me[0]["proxied"]
    assert state.list_state_page(what)["rows"] == state.list_tenants()
    with pytest.raises(ValueError, match="unknown summary table"):
        state.summarize_state(what)


def _jax_state_over_the_port_head(monkeypatch):
    """The JAX package's state API reading the port head through the
    port's client (the wire messages are the same)."""
    from ray_tpu.experimental.state import api as jax_state
    from ray_tpu_torch.experimental.state import api as state_api

    monkeypatch.setattr(jax_state, "_client", state_api._client)
    return jax_state


@pytest.mark.parametrize("call", [
    ("list_slices",), ("list_logs",), ("list_incidents",), ("list_slos",),
    ("get_log",), ("get_log", {"errors": True}), ("get_log", {"grep": "ZZ-NEEDLE"}),
    ("tail_log", "__a_worker__"), ("list_profiles",), ("get_profile", {"window_s": 600.0}),
    ("profile_diff", {"window_a": 600.0, "window_b": 60.0})],
    ids=lambda c: "-".join([c[0]] + [k for k in (c[1] if len(c) > 1 and isinstance(c[1], dict)
                                                 else {})]))
def test_the_store_reads_answer_as_the_jax_state_api_does(scenario, monkeypatch, call):
    """Each read of the stores the head now keeps (slices, logs,
    incidents, SLOs, profiles) answers rows, and the same rows as the
    JAX package's state API reading the same head."""
    from ray_tpu_torch.experimental.state import api as state

    jax_state = _jax_state_over_the_port_head(monkeypatch)
    name, *rest = call
    args, kwargs = [], {}
    for r in rest:
        if isinstance(r, dict):
            kwargs = r
        elif r == "__a_worker__":
            args = [next(row["stream"] for row in state.list_logs()
                         if row["stream"].startswith("worker-"))]
    if name == "get_log":
        @ray_tpu_torch.remote
        def speak():
            import sys

            print("ZZ-NEEDLE out")
            print("ZZ-NEEDLE err", file=sys.stderr)

        ray_tpu_torch.get(speak.remote(), timeout=T)
        _until(lambda: len(state.get_log(grep="ZZ-NEEDLE")["records"]) >= 2, "the needle")
    for _ in range(3):  # a store may take a record between the two reads
        ours = getattr(state, name)(*args, **kwargs)
        ref = getattr(jax_state, name)(*args, **kwargs)
        if name == "list_profiles":
            ours, ref = ([{k: v for k, v in r.items() if k != "age_s"} for r in x]
                         for x in (ours, ref))
        if ours == ref:
            break
    assert ours == ref
    if name in ("list_logs", "list_slos", "get_log", "tail_log", "list_profiles"):
        assert ours
