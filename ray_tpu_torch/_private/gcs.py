"""GCS — the cluster control-plane tables.

In-process analog of the reference's GCS server
(``src/ray/gcs/gcs_server/gcs_server.h:75``): actor directory + restart FSM
state (``gcs_actor_manager.h:270``), node table (``gcs_node_manager.h:39``),
job/worker bookkeeping, the internal KV used for function shipping
(``gcs_kv_manager.h:139`` — the reference's FunctionActorManager stores
pickled functions there, ``python/ray/_private/function_manager.py:56``),
and placement-group records (``gcs_placement_group_manager.h:221``).

Storage is the ``InMemoryStoreClient`` analog
(``src/ray/gcs/store_client/in_memory_store_client.h:31``); with a
persistent ``StoreClient`` (``gcs_storage.SqliteStoreClient``) the head
flushes these tables through it and a later head replays them
(``flush``/``replay`` below).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ActorInfo:
    actor_id: bytes
    name: Optional[str]
    class_name: str
    state: str = "PENDING_CREATION"  # PENDING_CREATION/ALIVE/RESTARTING/DEAD
    node_id: Optional[str] = None
    worker_id: Optional[bytes] = None
    max_restarts: int = 0
    num_restarts: int = 0
    # in-flight method retries across a restart (at-most-once by default)
    max_task_retries: int = 0
    creation_spec: Optional[dict] = None  # kept for restart (lineage)
    death_cause: Optional[str] = None
    # multi-tenancy: names are scoped per namespace; the owning job is the
    # driver connection that created the actor, and non-detached actors are
    # reaped when it disconnects (GcsActorManager OnJobFinished analog)
    namespace: str = "default"
    job_id: Optional[str] = None
    lifetime: Optional[str] = None  # None | "detached"


@dataclass
class NodeInfo:
    node_id: str
    resources: Dict[str, float]
    alive: bool = True
    start_time: float = field(default_factory=time.time)
    # failure-domain id: hosts of one TPU slice share it and are
    # provisioned/terminated/replaced as one unit (`ray_tpu_torch slices`)
    slice_id: Optional[str] = None


@dataclass
class TaskInfo:
    task_id: bytes
    name: str
    state: str = "PENDING"  # PENDING/RUNNING/FINISHED/FAILED
    node_id: Optional[str] = None
    start_time: float = field(default_factory=time.time)  # submission
    end_time: Optional[float] = None
    # worker-reported execution window + pid (profile events)
    exec_start: Optional[float] = None
    exec_end: Optional[float] = None
    worker_pid: Optional[int] = None
    # distributed trace context (util.tracing): set when the submitter was
    # inside a trace() block; the timeline draws flow arrows from it
    trace_ctx: Optional[dict] = None
    # submitting tenant (stamped from the spec): per-job attribution in
    # the state API and `ray_tpu_torch list tasks`
    job_id: Optional[str] = None


@dataclass
class PlacementGroupInfo:
    pg_id: bytes
    bundles: List[Dict[str, float]]
    strategy: str
    state: str = "PENDING"  # PENDING/CREATED/REMOVED
    bundle_nodes: List[Optional[str]] = field(default_factory=list)
    name: Optional[str] = None


class GcsTables:
    """All control-plane tables behind one lock (single head process)."""

    def __init__(self):
        self.lock = threading.RLock()
        self.kv: Dict[str, Dict[bytes, bytes]] = {}  # namespace -> key -> val
        self.actors: Dict[bytes, ActorInfo] = {}
        # (namespace, name) -> actor_id: two tenants can both own "svc"
        # without colliding; lookups are namespace-scoped (reference
        # GcsActorManager named_actors_ keyed the same way)
        self.named_actors: Dict[tuple, bytes] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.tasks: Dict[bytes, TaskInfo] = {}
        self.placement_groups: Dict[bytes, PlacementGroupInfo] = {}

    # ---- internal KV (GcsInternalKVManager analog) ----
    def kv_put(self, ns: str, key: bytes, value: bytes) -> None:
        with self.lock:
            self.kv.setdefault(ns, {})[key] = value

    def kv_get(self, ns: str, key: bytes) -> Optional[bytes]:
        with self.lock:
            return self.kv.get(ns, {}).get(key)

    def kv_keys(self, ns: str) -> List[bytes]:
        with self.lock:
            return list(self.kv.get(ns, {}).keys())

    def kv_del(self, ns: str, key: bytes) -> None:
        with self.lock:
            self.kv.get(ns, {}).pop(key, None)

    # ---- snapshots for the state API (dashboard/state_aggregator analog) ----
    def snapshot(self) -> Dict[str, Any]:
        with self.lock:
            return {
                "actors": list(self.actors.values()),
                "nodes": list(self.nodes.values()),
                "tasks": list(self.tasks.values()),
                "placement_groups": list(self.placement_groups.values()),
            }

    # ---- persistence (GcsTableStorage over a StoreClient) ----
    def flush(self, store) -> None:
        """Write the control-plane tables through to the store.  Called
        periodically + at shutdown; metadata rates are low, so wholesale
        dumps are simpler than per-mutation write-through and equally
        durable at the flush period granularity."""
        from ray_tpu_torch._private import gcs_storage as gs

        with self.lock:
            kv = {ns: dict(t) for ns, t in self.kv.items()}
            actors = [self._actor_record(a) for a in self.actors.values()]
            tasks = list(self.tasks.values())
            pgs = list(self.placement_groups.values())
        # whole-table replacement so kv_del'd entries don't resurrect on
        # replay, in one transaction per table (one fsync, not per key)
        store.replace_table("kv", [
            (ns.encode() + b"\x00" + k, v)
            for ns, t in kv.items() for k, v in t.items()
        ])
        store.replace_table("tables", [
            (b"actors", gs.dumps(actors)),
            (b"tasks", gs.dumps(tasks)),
            (b"placement_groups", gs.dumps(pgs)),
        ])

    @staticmethod
    def _actor_record(a: "ActorInfo") -> "ActorInfo":
        """Copy without the creation spec (arg blobs aren't replayable —
        their object refs died with the session)."""
        import dataclasses

        return dataclasses.replace(a, creation_spec=None)

    def replay(self, store) -> None:
        """GcsInitData analog: restore KV + historical records from a prior
        head's store.  Prior actors/tasks are history, not live entities —
        their processes died with the old head."""
        from ray_tpu_torch._private import gcs_storage as gs

        with self.lock:
            for key, value in store.items("kv"):
                ns, _, k = key.partition(b"\x00")
                self.kv.setdefault(ns.decode(), {})[k] = value
            blob = store.get("tables", b"actors")
            for a in gs.loads(blob) if blob else []:
                if a.state != "DEAD":
                    a.state = "DEAD"
                    a.death_cause = "head restarted"
                self.actors[a.actor_id] = a
            blob = store.get("tables", b"tasks")
            for t in gs.loads(blob) if blob else []:
                if t.state in ("PENDING", "RUNNING"):
                    t.state = "FAILED"
                self.tasks[t.task_id] = t
            blob = store.get("tables", b"placement_groups")
            for pg in gs.loads(blob) if blob else []:
                pg.state = "REMOVED"
                self.placement_groups[pg.pg_id] = pg
