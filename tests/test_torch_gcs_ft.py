"""GCS persistence on the port's head against the JAX package's: the
``StoreClient`` layer (``_private/gcs_storage.py``), the tables' flush
and replay (``_private/gcs.py``), and a second head started over the
first one's SQLite file.

The live cases are ``tests/test_gcs_ft.py::test_gcs_persistence_replay``'s
on a port head, with a placement group and a task still RUNNING at the
shutdown beside it.  The store and the tables start nothing, so they are
held to the JAX package's on the same seeded operations: both
``SqliteStoreClient``s leave the same rows, both ``InMemoryStoreClient``s
answer the same reads, and the port's tables flush and replay to the
same records as the JAX tables.

No JAX head starts.  Each live case starts its port heads one after the
other in this process under a private ``TMPDIR``; every test has its own
time limit and every wait is bounded.
"""

import dataclasses
import os
import signal
import sqlite3
import tempfile
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu._private import gcs as jax_gcs
from ray_tpu._private import gcs_storage as jax_gs
from ray_tpu_torch._private import gcs
from ray_tpu_torch._private import gcs_storage as gs
from ray_tpu_torch._private.worker import global_worker

T = 60  # seconds: every get and wait in this file
LIMIT = 120  # seconds: each test's own limit


@pytest.fixture(autouse=True)
def time_limit(request):
    def expired(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past its {LIMIT} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old if old is not None else signal.SIG_DFL)


@pytest.fixture
def private_tmp(tmp_path_factory):
    tmp_path_factory.getbasetemp()  # pytest's temp root stays outside the private TMPDIR
    with tempfile.TemporaryDirectory(prefix="gcsft_") as d, pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMPDIR", d)
        mp.setattr(tempfile, "tempdir", d)
        try:
            yield d
        finally:
            if rt.is_initialized():
                rt.shutdown()


def _wait_for(pred, timeout=T):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(0.05)
    raise AssertionError("condition not met within timeout")


# -- test_gcs_ft.py's case ----------------------------------------------------


def test_gcs_persistence_replay(private_tmp):
    """The KV and the control-plane history survive a head restart;
    prior live entities come back DEAD (their processes died with the
    old head)."""
    db = os.path.join(private_tmp, "gcs.db")
    rt.init(num_cpus=2, _gcs_persistence_path=db)

    @rt.remote
    class Keeper:
        def ping(self):
            return 1

    k = Keeper.remote()
    assert rt.get(k.ping.remote(), timeout=T) == 1

    @rt.remote
    def job(x):
        return x * 2

    assert rt.get(job.remote(21), timeout=T) == 42
    node = global_worker.node
    assert node.gcs_replay_s is None  # a new file: nothing to replay
    node.gcs.kv_put("app", b"config", b"v2-settings")
    node.gcs.flush(node.gcs_store)
    rt.shutdown()

    # a second head over the same store
    rt.init(num_cpus=2, _gcs_persistence_path=db)
    node2 = global_worker.node
    assert node2.gcs_replay_s is not None and node2.gcs_replay_s < 5.0
    assert node2.gcs.kv_get("app", b"config") == b"v2-settings"
    actors = list(node2.gcs.actors.values())
    assert any(a.class_name == "Keeper" and a.state == "DEAD"
               and a.death_cause == "head restarted" for a in actors)
    tasks = list(node2.gcs.tasks.values())
    assert any(t.name == "job" and t.state == "FINISHED" for t in tasks)

    # the new head still works
    @rt.remote
    def f():
        return "alive"

    assert rt.get(f.remote(), timeout=T) == "alive"


def test_a_running_task_and_a_placement_group_replay_as_failed_and_removed(private_tmp):
    """A task still RUNNING when its head shut down replays FAILED, a
    created placement group REMOVED, and a key deleted before the last
    flush stays deleted; the shutdown's own flush is what carries them."""
    db = os.path.join(private_tmp, "gcs.db")
    rt.init(num_cpus=2, _gcs_persistence_path=db)
    pg = rt.placement_group([{"CPU": 1}], strategy="PACK")
    assert rt.get(pg.ready(), timeout=T)

    @rt.remote
    def forever():
        time.sleep(600)

    ref = forever.remote()
    node = global_worker.node
    _wait_for(lambda: any(t.name == "forever" and t.state == "RUNNING"
                          for t in list(node.gcs.tasks.values())))
    node.gcs.kv_put("app", b"gone", b"x")
    node.gcs.flush(node.gcs_store)
    node.gcs.kv_del("app", b"gone")
    node.gcs.kv_put("app", b"kept", b"y")
    del ref
    rt.shutdown()  # flushes once more, then closes the store

    rt.init(num_cpus=2, _gcs_persistence_path=db)
    g = global_worker.node.gcs
    assert [t.state for t in g.tasks.values() if t.name == "forever"] == ["FAILED"]
    assert [p.state for p in g.placement_groups.values()] == ["REMOVED"]
    assert g.kv_get("app", b"gone") is None and g.kv_get("app", b"kept") == b"y"


# -- the store and the tables against the JAX package's ------------------------


def _seeded_ops(seed, n=400):
    rng = np.random.default_rng(seed)
    tables = ["kv", "tables", "jobs"]
    ops = []
    for _ in range(n):
        t = tables[int(rng.integers(len(tables)))]
        key = b"k%d" % int(rng.integers(30))
        r = rng.random()
        if r < 0.6:
            ops.append(("put", t, key, bytes(rng.integers(0, 256, int(rng.integers(1, 64)),
                                                          dtype=np.uint8))))
        elif r < 0.8:
            ops.append(("delete", t, key))
        else:
            ops.append(("replace_table", t, [(b"r%d" % i, b"v%d" % int(rng.integers(1000)))
                                             for i in range(int(rng.integers(0, 8)))]))
    return ops


def _apply(store, ops):
    reads = []
    for op, table, *rest in ops:
        getattr(store, op)(table, *rest)
        key = rest[0] if op != "replace_table" else b"r0"
        reads.append((store.get(table, key), sorted(store.keys(table)),
                      sorted(store.items(table))))
    return reads


@pytest.mark.parametrize("seed", [0, 1])
def test_sqlite_stores_leave_the_same_rows(tmp_path, seed):
    ops = _seeded_ops(seed)
    port = gs.SqliteStoreClient(str(tmp_path / "port.db"))
    ref = jax_gs.SqliteStoreClient(str(tmp_path / "jax.db"))
    assert _apply(port, ops) == _apply(ref, ops)
    port.close()
    ref.close()
    rows = []
    for name in ("port.db", "jax.db"):
        con = sqlite3.connect(str(tmp_path / name))
        rows.append((con.execute("SELECT sql FROM sqlite_master").fetchall(),
                     con.execute("SELECT tbl, key, value FROM kv ORDER BY tbl, key").fetchall()))
        con.close()
    assert rows[0] == rows[1] and rows[0][1]


@pytest.mark.parametrize("seed", [2, 3])
def test_in_memory_stores_answer_the_same_reads(seed):
    ops = _seeded_ops(seed)
    assert _apply(gs.InMemoryStoreClient(), ops) == _apply(jax_gs.InMemoryStoreClient(), ops)


def test_dumps_and_loads_match_jax():
    value = {"a": [1, 2.5, None], "b": (b"x", "y"), "c": {"nested": True}}
    assert gs.dumps(value) == jax_gs.dumps(value)
    assert gs.loads(gs.dumps(value)) == jax_gs.loads(jax_gs.dumps(value)) == value


def _fill(mod, rng):
    """The same seeded records in ``mod``'s tables (the port's or the JAX
    package's dataclasses)."""
    t = mod.GcsTables()
    for i in range(6):
        t.kv_put(f"ns{i % 3}", b"key%d" % i, b"val%d" % int(rng.integers(1000)))
    states = ["PENDING_CREATION", "ALIVE", "RESTARTING", "DEAD"]
    for i in range(8):
        aid = b"actor-%d" % i
        t.actors[aid] = mod.ActorInfo(
            actor_id=aid, name=f"a{i}" if i % 2 else None, class_name=f"C{i % 3}",
            state=states[int(rng.integers(4))], node_id="node-head", worker_id=b"w%d" % i,
            creation_spec={"args": b"blob"}, death_cause=None, namespace="default",
            job_id="job-0001")
    for i, state in enumerate(["PENDING", "RUNNING", "FINISHED", "FAILED"] * 3):
        tid = b"task-%d" % i
        t.tasks[tid] = mod.TaskInfo(task_id=tid, name=f"f{i % 4}", state=state,
                                    node_id="node-head", start_time=1000.0 + i,
                                    end_time=None if state in ("PENDING", "RUNNING")
                                    else 1001.0 + i, worker_pid=100 + i, job_id="job-0001")
    for i, state in enumerate(["PENDING", "CREATED", "REMOVED"]):
        pid_ = b"pg-%d" % i
        t.placement_groups[pid_] = mod.PlacementGroupInfo(
            pg_id=pid_, bundles=[{"CPU": 1.0}], strategy="PACK", state=state,
            bundle_nodes=["node-head"], name=f"pg{i}")
    return t


def _records(tables):
    with tables.lock:
        return ({ns: dict(kv) for ns, kv in tables.kv.items()},
                {k: dataclasses.asdict(v) for k, v in tables.actors.items()},
                {k: dataclasses.asdict(v) for k, v in tables.tasks.items()},
                {k: dataclasses.asdict(v) for k, v in tables.placement_groups.items()})


def test_the_tables_flush_and_replay_as_the_jax_tables_do(tmp_path):
    port_tables = _fill(gcs, np.random.default_rng(7))
    jax_tables = _fill(jax_gcs, np.random.default_rng(7))
    assert _records(port_tables) == _records(jax_tables)
    port_store = gs.SqliteStoreClient(str(tmp_path / "port.db"))
    jax_store = jax_gs.SqliteStoreClient(str(tmp_path / "jax.db"))
    port_tables.flush(port_store)
    jax_tables.flush(jax_store)
    assert sorted(port_store.items("kv")) == sorted(jax_store.items("kv"))
    for key in (b"actors", b"tasks", b"placement_groups"):
        assert ([dataclasses.asdict(r) for r in gs.loads(port_store.get("tables", key))]
                == [dataclasses.asdict(r) for r in jax_gs.loads(jax_store.get("tables", key))])
    port_back, jax_back = gcs.GcsTables(), jax_gcs.GcsTables()
    port_back.replay(port_store)
    jax_back.replay(jax_store)
    got = _records(port_back)
    assert got == _records(jax_back)
    kv, actors, tasks, pgs = got
    assert all(a["state"] == "DEAD" and a["creation_spec"] is None for a in actors.values())
    assert {t["state"] for t in tasks.values()} == {"FINISHED", "FAILED"}
    assert {p["state"] for p in pgs.values()} == {"REMOVED"}
