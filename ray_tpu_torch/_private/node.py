"""Head process: raylet + GCS + object directory in one event-driven server.

This fuses the roles the reference splits across processes, keeping the same
seams so they can be split later:

- connection fan-in + message dispatch  <-> raylet ``NodeManager`` gRPC
  service (``src/ray/raylet/node_manager.h:144``)
- ``Scheduler``                          <-> ``ClusterTaskManager`` /
  ``LocalTaskManager`` (``src/ray/raylet/scheduling/cluster_task_manager.h:41``,
  ``local_task_manager.h:58``) with a hybrid pack/spread policy
  (``policy/hybrid_scheduling_policy.h:48``)
- ``NodeState`` resource accounting      <-> ``ClusterResourceManager`` /
  ``LocalResourceManager`` with **GPU as a predefined resource** next to
  CPU: granted card shares leave ``NodeState.gpu_share`` with the worker's
  ``CUDA_VISIBLE_DEVICES`` and return when it ends
- worker pool + dedicated actor workers  <-> ``WorkerPool``
  (``src/ray/raylet/worker_pool.h:156``)
- actor restart FSM                      <-> ``GcsActorManager``
  (``gcs_actor_manager.h:270``)
- placement-group bundle reservation     <-> ``GcsPlacementGroupManager`` +
  bundle policies (``bundle_scheduling_policy.h:82-106``)
- get/wait request parking               <-> raylet ``WaitManager`` +
  plasma ``GetRequestQueue``
- merged worker metrics + ``tsdb``        <-> the metrics agent's export
  path: every worker's and agent's ``metrics_report`` folds into one
  registry and a time-series store, which ``top``, ``memory``, ``perf``
  and ``doctor`` read (``_memory_audit``, ``_top_snapshot``,
  ``_perf_summary``, ``_doctor_report``)
- ``profile_store``, ``log_store``,      <-> the reporter agent's profiling,
  ``watchdog``                           the log monitor's store and an
  alerting loop: every process's continuous profiler ships folded stacks,
  every node's log monitor ships its workers' lines, and the watchdog
  folds doctor findings and SLO burns into incidents with bundles under
  ``<session>/incidents/``

Multiple ``NodeState``s in one head process emulate a multi-node cluster —
the same trick as the reference's in-process multi-raylet test Cluster
(``python/ray/cluster_utils.py:99``).
"""

from __future__ import annotations

import json
import math
import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass, field
from multiprocessing.connection import Connection, Listener
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import events as events_mod
from ray_tpu_torch._private import logging_utils, wire
from ray_tpu_torch._private.config import get_config, session_root
from ray_tpu_torch._private.locks import make_lock
from ray_tpu_torch._private.sharding import ShardSet
from ray_tpu_torch._private.gcs import (
    ActorInfo,
    GcsTables,
    NodeInfo,
    PlacementGroupInfo,
    TaskInfo,
)
from ray_tpu_torch._private.object_store import ObjectLocation, ObjectRegistry

logger = logging_utils.get_logger(__name__)

# Resource names (scheduling_ids.h predefined resources).
CPU = "CPU"
GPU = "GPU"
MEMORY = "memory"

# Lazy scheduler metric singletons (registered on first dispatch so a head
# that never runs a task registers nothing).
_SCHED_METRICS = None
# Dispatch EVENTS are sampled 1:N (Dapper-style bounded overhead: the
# latency histogram records every task; the event trail records the 1st,
# N+1th, ... dispatch plus every GPU dispatch).  The emit rides the head's
# reader thread — the task hot path — so it must stay amortized-cheap.
_DISPATCH_EVENT_SAMPLE = max(1, int(os.environ.get(
    "RAY_TPU_TORCH_EVENTS_DISPATCH_SAMPLE", "8")))


def _sched_metrics():
    global _SCHED_METRICS
    if _SCHED_METRICS is None:
        from ray_tpu_torch.util.metrics import Gauge, Histogram

        _SCHED_METRICS = {
            "dispatch_latency": Histogram(
                "ray_tpu_sched_dispatch_latency_s",
                "task submit -> worker dispatch latency (s)",
                boundaries=[0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5],
            ),
            "queue_depth": Gauge(
                "ray_tpu_sched_queue_depth",
                "tasks pending cluster-wide (not yet staged on a node)",
            ),
        }
    return _SCHED_METRICS


def _worker_pythonpath(existing: str) -> str:
    """Workers see the driver's import universe: the package root plus every
    directory on the driver's sys.path (the reference achieves this through
    runtime-env/working-dir propagation) — functions pickled by reference
    then resolve on the worker side."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parts = [pkg_root]
    for p in sys.path:
        if p == "":  # interactive/-c drivers resolve imports from cwd
            p = os.getcwd()
        if p not in parts and os.path.exists(p):  # dirs and zip/egg entries
            parts.append(p)
    if existing:
        parts.append(existing)
    return os.pathsep.join(parts)


def _runtime_env_key(runtime_env: Optional[dict]) -> Optional[str]:
    """Stable identity of a runtime_env — pooled workers are keyed by it so a
    task only ever reuses a worker spawned with the same environment (the
    reference's dedicated-worker-per-runtime-env rule,
    ``src/ray/raylet/worker_pool.h:156``)."""
    if not runtime_env:
        return None
    import json

    return json.dumps(runtime_env, sort_keys=True)


def _apply_runtime_env(env: Dict[str, str], runtime_env: Optional[dict]) -> Optional[str]:
    """Fold env_vars into a worker's spawn env; returns the cwd override.

    Package URIs (``gcs://pkg-…`` working_dir / py_modules, uploaded by
    the driver) can't chdir at spawn — the worker materializes them
    itself from ``RAY_TPU_TORCH_RUNTIME_ENV`` right before it registers
    (``runtime_env_packaging.apply_packages_in_worker``), which works
    identically for head-local and agent-spawned remote workers."""
    if not runtime_env:
        return None
    from ray_tpu_torch._private.runtime_env_packaging import is_package_uri

    env.update(runtime_env.get("env_vars") or {})
    wd = runtime_env.get("working_dir")
    if is_package_uri(wd) or runtime_env.get("py_modules"):
        env["RAY_TPU_TORCH_RUNTIME_ENV"] = json.dumps({
            "working_dir": wd if is_package_uri(wd) else None,
            "py_modules": runtime_env.get("py_modules"),
        })
    return wd if wd is not None and not is_package_uri(wd) else None


def _worker_argv(runtime_env: Optional[dict]) -> List[str]:
    """A worker's command, the same on the head and on a node agent: a
    pip or conda env boots through ``runtime_env_setup``'s shim, which
    execs that env's interpreter into ``ray_tpu_torch._private.worker``."""
    from ray_tpu_torch._private.runtime_env_setup import worker_argv

    return worker_argv((runtime_env or {}).get("pip"),
                       (runtime_env or {}).get("conda"))


def _set_child_subreaper() -> bool:
    """PR_SET_CHILD_SUBREAPER: forkserver-spawned workers (and any orphan
    a dying worker leaves behind) reparent to THIS process instead of pid
    1, so the reaper loop can waitpid them — the fix for zombie
    accumulation when the head runs as a container's pid 1."""
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        return libc.prctl(36, 1, 0, 0, 0) == 0  # PR_SET_CHILD_SUBREAPER
    except Exception:
        return False


class _ForkedProc:
    """Popen-compatible handle for a forkserver-spawned worker.  The
    worker is not our direct child (double fork) but reparents to us via
    the subreaper, so waitpid works; without subreaper support, liveness
    falls back to signal 0."""

    def __init__(self, pid: int):
        self.pid = pid
        self.returncode: Optional[int] = None

    def poll(self) -> Optional[int]:
        if self.returncode is not None:
            return self.returncode
        try:
            done, status = os.waitpid(self.pid, os.WNOHANG)
            if done == self.pid:
                self.returncode = os.waitstatus_to_exitcode(status)
        except ChildProcessError:
            try:
                os.kill(self.pid, 0)
            except ProcessLookupError:
                self.returncode = -1
        return self.returncode

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() >= deadline:
                raise subprocess.TimeoutExpired("forked-worker", timeout)
            time.sleep(0.02)
        return self.returncode

    def _signal(self, sig: int) -> None:
        if self.returncode is None:
            try:
                os.kill(self.pid, sig)
            except (ProcessLookupError, PermissionError):
                pass

    def terminate(self) -> None:
        self._signal(signal.SIGTERM)

    def kill(self) -> None:
        self._signal(signal.SIGKILL)


class _ForkServerClient:
    """Manages the template process and requests spawns from it."""

    def __init__(self, session_dir: str):
        self._sock_path = os.path.join(session_dir, "forkserver.sock")
        self._proc: Optional[subprocess.Popen] = None
        self._lock = make_lock("node.forkserver")
        self._broken = False

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid if self._proc is not None else None

    def _ensure(self) -> bool:
        if self._broken:
            return False
        if self._proc is not None and self._proc.poll() is None:
            return True
        env = dict(os.environ)
        env["PYTHONPATH"] = _worker_pythonpath(env.get("PYTHONPATH", ""))
        try:
            self._proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch._private.forkserver",
                 self._sock_path],
                env=env,
            )
        except OSError:
            self._broken = True
            return False
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if self._proc.poll() is not None:
                self._broken = True
                return False
            s = socket.socket(socket.AF_UNIX)
            try:
                s.connect(self._sock_path)
                s.close()
                return True
            except OSError:
                s.close()
                time.sleep(0.05)
        self._broken = True
        return False

    def prewarm(self) -> None:
        with self._lock:
            self._ensure()

    def spawn(self, env: Dict[str, str], cwd: Optional[str]) -> Optional[_ForkedProc]:
        """Fork a worker from the warm template; None -> caller should
        fall back to a classic Popen.  Callers may hold head.lock, so the
        per-request timeout stays short — a wedged template degrades to
        Popen spawns instead of freezing the control plane."""
        with self._lock:
            if not self._ensure():
                return None
            try:
                s = socket.socket(socket.AF_UNIX)
                s.settimeout(10)
                # the lock IS the forkserver protocol serializer: one
                # request/response round trip per holder, by design
                s.connect(self._sock_path)  # raylint: disable=R4
                s.sendall((json.dumps({"env": env, "cwd": cwd}) + "\n").encode())  # raylint: disable=R4
                data = b""
                while not data.endswith(b"\n"):
                    chunk = s.recv(1 << 16)  # raylint: disable=R4
                    if not chunk:
                        break
                    data += chunk
                s.close()
                return _ForkedProc(int(json.loads(data)["pid"]))
            except (OSError, ValueError, KeyError):
                # template wedged: drop it; next spawn restarts it
                try:
                    self._proc.kill()
                except Exception:
                    pass
                self._proc = None
                return None

    def close(self) -> None:
        if self._proc is not None:
            try:
                self._proc.kill()
            except Exception:
                pass


class _SessionRing:
    """This process's event ring from a head's start on.  The ring is the
    process's, and outlives ``shutdown``: an earlier session's events in
    it (a driver that ran one cluster, then another) are not this
    cluster's, and its listings and doctor must not report them."""

    def __init__(self, seq0: int):
        self.seq0 = seq0

    def since(self, seq: int) -> List[dict]:
        return events_mod.buffer().since(max(seq, self.seq0))


def _fits(req: Dict[str, float], avail: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) + 1e-9 >= v for k, v in req.items())


def _acquire(req: Dict[str, float], avail: Dict[str, float]) -> None:
    for k, v in req.items():
        avail[k] = avail.get(k, 0.0) - v


def _release(req: Dict[str, float], avail: Dict[str, float]) -> None:
    for k, v in req.items():
        avail[k] = avail.get(k, 0.0) + v


def _gpu_fits(ns: "NodeState", amount: float) -> bool:
    """Whether ``ns`` has cards for a ``"GPU"`` request of ``amount``: a
    fraction needs one card with that share left, a whole count that
    many wholly free cards."""
    if amount <= 0:
        return True
    if amount < 1:
        return any(s + 1e-9 >= amount for s in ns.gpu_share.values())
    return sum(s + 1e-9 >= 1.0 for s in ns.gpu_share.values()) >= amount


def _take_gpus(ns: "NodeState", amount: float) -> List[int]:
    """Grant a ``"GPU"`` request of ``amount`` from ``ns`` (the resource
    was acquired with it): a fraction takes its share of the lowest card
    with enough share left, a whole count the lowest wholly free cards.
    Returns the granted card ids; :func:`_give_gpus` returns them."""
    if amount <= 0:
        return []
    if amount < 1:
        for i in sorted(ns.gpu_share):
            if ns.gpu_share[i] + 1e-9 >= amount:
                ns.gpu_share[i] -= amount
                return [i]
        return []
    ids = [i for i in sorted(ns.gpu_share)
           if ns.gpu_share[i] + 1e-9 >= 1.0][:int(amount)]
    for i in ids:
        ns.gpu_share[i] = 0.0
    return ids


def _give_gpus(ns: "NodeState", ids: List[int], amount: float) -> None:
    """Return the cards :func:`_take_gpus` granted for ``amount``."""
    share = amount if 0 < amount < 1 else 1.0
    for i in ids:
        ns.gpu_share[i] = min(1.0, ns.gpu_share.get(i, 0.0) + share)


@dataclass(eq=False)  # identity semantics: handles live in sets/lists
class WorkerHandle:
    worker_id: bytes
    node_id: str
    proc: Optional[subprocess.Popen] = None
    conn: Optional[Connection] = None
    state: str = "starting"  # starting/idle/busy/dead
    is_actor_worker: bool = False
    actor_id: Optional[bytes] = None
    current_task: Optional[dict] = None
    send_lock: threading.Lock = field(default_factory=threading.Lock)
    # Nested/concurrent ray.get depth: CPUs are released on 0->1 and
    # reacquired on 1->0 (threaded actors can block several methods at once).
    block_depth: int = 0
    runtime_env_key: Optional[str] = None
    # wall time this worker last became idle (idle-pool reaping)
    idle_since: float = 0.0
    # same-shape tasks sent ahead of completion (lease-reuse pipelining);
    # they hold no resources until promoted in _on_task_done
    pipeline: deque = field(default_factory=deque)
    # messages queued under the node lock, written to the pipe outside it
    # by Node._flush_sends — pickling+write syscalls must not extend lock
    # hold times (they were the head's main source of lock contention)
    outbox: deque = field(default_factory=deque)

    def send(self, msg: dict) -> None:
        with self.send_lock:
            self.conn.send(msg)


@dataclass
class NodeState:
    node_id: str
    total: Dict[str, float]
    available: Dict[str, float]
    # card id -> the share of it not granted (1.0 free, 0.0 fully held)
    gpu_share: Dict[int, float]
    env: Dict[str, str] = field(default_factory=dict)
    idle: List[WorkerHandle] = field(default_factory=list)
    starting: int = 0
    # in-flight spawns per runtime_env key (None = plain workers)
    starting_by_key: Dict[Optional[str], int] = field(default_factory=dict)
    # consecutive pre-registration deaths per runtime_env key — a worker
    # that cannot boot (bad env) must surface an error, not hang the task
    spawn_failures: Dict[Optional[str], int] = field(default_factory=dict)
    # tasks whose resources are held, waiting for an idle worker.  Lives
    # in the node's dispatch-shard key space: mutations take shard.lock
    # (nested under the head lock where resource accounting requires it)
    ready_queue: deque = field(default_factory=deque)
    shard: Any = None
    alive: bool = True
    # Real remote node (joined via node_agent): control connection to the
    # agent and the address of its object server.  None/"" = emulated or
    # head-local node.
    agent_conn: Optional[Connection] = None
    agent_send_lock: Optional[threading.Lock] = None
    fetch_addr: Optional[tuple] = None
    # failure domain: hosts of one TPU slice share a slice_id and are
    # provisioned/terminated/replaced as one unit (SURVEY §7 hard-part 3)
    slice_id: Optional[str] = None
    # the node's P2P syncer listener (mesh directory entry); None for
    # emulated/head-local nodes
    syncer_addr: Optional[tuple] = None
    # health checking (GcsHealthCheckManager analog)
    last_heartbeat: float = field(default_factory=time.time)
    last_ping: float = 0.0
    # live host utilization from the agent's last pong (reporter_agent
    # analog); head-local nodes compute theirs at query time
    host_stats: Optional[Dict[str, float]] = None

    def agent_send(self, msg: dict) -> None:
        # read once: the death path nulls agent_conn concurrently, and an
        # AttributeError mid-send would escape callers expecting OSError
        conn = self.agent_conn
        if conn is None:
            raise OSError("node has no agent connection")
        with self.agent_send_lock:
            conn.send(msg)

    def utilization(self) -> float:
        fracs = []
        for k, tot in self.total.items():
            if tot > 0:
                fracs.append(1.0 - self.available.get(k, 0.0) / tot)
        return max(fracs) if fracs else 0.0


@dataclass
class ActorRuntime:
    info: ActorInfo
    # home dispatch shard: queue/inflight/inflight_groups and the
    # dispatch-gating info.state transitions are only touched under
    # shard.lock (hot paths take it alone; head-lock holders nest it)
    shard: Any = None
    worker: Optional[WorkerHandle] = None
    queue: deque = field(default_factory=deque)  # pending method specs
    # in-flight method specs by task id; up to max_concurrency of them
    # (threaded/async actors — OutOfOrderActorSchedulingQueue analog)
    inflight: Dict[bytes, dict] = field(default_factory=dict)
    # in-flight count per concurrency group (ConcurrencyGroupManager
    # analog: each named group has its own dispatch window so a saturated
    # default pool cannot starve e.g. health checks)
    inflight_groups: Dict[str, int] = field(default_factory=dict)
    held: Dict[str, float] = field(default_factory=dict)
    gpu_ids: List[int] = field(default_factory=list)
    node_id: Optional[str] = None
    # concurrency_groups pre-serialized for the spawn env (computed
    # outside the node lock at creation; R4 keeps serialization out of
    # locked regions)
    groups_env: Optional[str] = None

    @property
    def max_concurrency(self) -> int:
        return int(self.info.creation_spec.get("max_concurrency") or 1)

    @property
    def concurrency_groups(self) -> Dict[str, int]:
        return self.info.creation_spec.get("concurrency_groups") or {}


@dataclass
class ClientState:
    """One registered driver connection (in-process driver, external
    driver, or a proxied tenant driver).  The head attributes
    everything the connection creates — actors, sealed objects, handle
    pins — to its ``job_id``/``namespace`` so a disconnect can release
    exactly what it owned (reference ``GcsJobManager`` + the proxier's
    per-connection ``SpecificServer`` ownership)."""

    job_id: str
    namespace: str
    conn: Any
    pid: Optional[int] = None
    proxied: bool = False
    connected_at: float = field(default_factory=time.time)
    # oids whose head-side entry holds an initial count on this client's
    # behalf (puts, task/actor returns) — the client sends ONE remove_ref
    # when its last local handle dies; if it never can (SIGKILL), the
    # disconnect reap sends it instead
    owned: set = field(default_factory=set)
    # oids pinned via announced add_ref (deserialized borrows): oid -> n
    pinned: Dict[bytes, int] = field(default_factory=dict)
    # the driver said it is leaving (``shutdown()``'s ``client_leaving``
    # frame): its disconnect is a clean exit, not a tenant death
    leaving: bool = False


@dataclass
class BundleRuntime:
    node_id: str
    reserved: Dict[str, float]
    available: Dict[str, float]
    # Set when the owning placement group is removed: releases of resources
    # still held by in-flight tasks then go back to the node, not the bundle.
    detached: bool = False


@dataclass
class PGRuntime:
    info: PlacementGroupInfo
    bundles: List[BundleRuntime] = field(default_factory=list)
    ready_oid: Optional[bytes] = None


def _placement_shape(spec: dict):
    """Hashable (resources, strategy) placement identity: two specs with
    the same shape place identically, so one failure covers both within a
    scheduling pass."""
    strat = spec.get("scheduling_strategy")
    skey = None
    if isinstance(strat, dict):
        skey = (
            strat.get("kind"),
            strat.get("node_id"),
            strat.get("pg_id"),
            strat.get("bundle_index"),
            strat.get("soft"),
        )
    return (tuple(sorted(spec.get("resources", {}).items())), skey)


@dataclass
class _PendingGet:
    req_id: int
    conn_send: Any  # callable(msg)
    oids: List[bytes]
    deadline: Optional[float]
    kind: str = "get"  # get | wait
    num_returns: int = 0
    # oids not yet sealed, maintained by _notify_sealed so a seal touches
    # only the gets waiting on that oid (O(1) instead of rescanning every
    # waiter's full oid list — the old path was O(waiters x oids) per seal)
    unsealed: Any = None  # set[bytes]
    done: bool = False
    # consumer's node ("" = head) — location replies pick the copy nearest
    # to it (location-set pull spreading)
    node_id: str = ""


class Node:
    """The head runtime: owns every table and thread of the session."""

    def __init__(
        self,
        num_cpus: Optional[int] = None,
        num_gpus: Optional[int] = None,
        resources: Optional[Dict[str, float]] = None,
        session_dir: Optional[str] = None,
        gcs_persistence_path: Optional[str] = None,
    ):
        from ray_tpu_torch._private.resource_spec import autodetect_resources

        from ray_tpu_torch._private import shm as shm_mod

        self.cfg = get_config()
        # the process's event ring outlives a session: a head started
        # after another in the same process reads only what was emitted
        # since its own start (its event listings, traces, crash trail,
        # doctor)
        self._session_ring = _SessionRing(events_mod.buffer().last_seq())
        self.session_dir = session_dir or (
            os.path.join(session_root(),
                         # raylint: disable=R3 (once per session)
                         f"session_{os.getpid()}_{os.urandom(4).hex()}")
        )
        os.makedirs(self.session_dir, exist_ok=True)
        self.address = os.path.join(self.session_dir, "raylet.sock")
        self.authkey = os.urandom(16)  # raylint: disable=R3 (one-shot, off the per-task path)

        # Session-scoped shm namespace: sweep segments a SIGKILL'd previous
        # head orphaned, then mark this session alive for the next sweeper.
        self.session_id = os.urandom(4).hex()  # raylint: disable=R3 (one-shot, off the per-task path)
        os.environ[shm_mod._SESSION_ENV] = self.session_id  # workers inherit
        swept = shm_mod.sweep_orphaned_segments()
        if swept:
            logger.info("swept %d orphaned shm segments from dead sessions", swept)
        shm_mod.write_session_marker(self.session_id, os.getpid())

        from ray_tpu_torch._private import usage as _usage

        _usage.reset()  # per-session scope for the usage report

        self.lock = make_lock("node.registry", rlock=True)
        self.cond = threading.Condition(self.lock)
        # Dispatch shards (RAY_TPU_TORCH_HEAD_SHARDS): actor tasks shard by
        # actor id, leased plain tasks by target node.  Hot actor paths
        # take ONLY their shard lock; anything also holding self.lock
        # takes it FIRST (the witness-verified fixed order).
        self.shards = ShardSet()
        from ray_tpu_torch._private.config import resolve_object_store_memory

        store_capacity = resolve_object_store_memory(self.cfg)
        self.registry = ObjectRegistry(
            capacity_bytes=store_capacity,
            spill_dir=os.path.join(self.session_dir, "spill"),
        )
        # lineage: return oid -> creating task spec, kept while the object
        # lives so a lost copy can be recomputed (TaskManager lineage,
        # reference task_manager.h:87; bounded like max_lineage_bytes).
        # Lineage PINS the spec's argument objects (incl. the big-args
        # payload) — without the pin, args are refcount-deleted at first
        # completion and reconstruction could never re-run the task.
        self.lineage: Dict[bytes, dict] = {}
        self._lineage_pins: Dict[bytes, List[bytes]] = {}  # task_id -> dep oids
        self._lineage_refcnt: Dict[bytes, int] = {}  # task_id -> live entries
        self.registry.on_delete = self._on_object_deleted
        # Native arena store (plasma analog, src/store_core) for this
        # process's objects; per-object files remain the fallback and the
        # worker-side path.
        self.arena = None
        try:
            from ray_tpu_torch._private import native, object_store as ostore_mod

            if native.available():
                arena_path = os.path.join(
                    shm_mod.shm_dir(),
                    f"{self.cfg.shm_prefix}-{self.session_id}-arena",
                )
                # sized to the resolved capacity: the file is sparse
                # (ftruncate), so a large arena costs nothing until used,
                # and multi-GiB values fit its recycled-page write path
                self.arena = native.NativeArena(arena_path, store_capacity)
                ostore_mod.set_owned_arena(self.arena)
                self.registry.arena_delete = self.arena.delete
                logger.info("native arena store at %s (%d MiB)",
                            arena_path, self.arena.capacity >> 20)
        except Exception:
            logger.warning("native arena unavailable:\n%s", traceback.format_exc())
        self.gcs = GcsTables()

        # GCS fault tolerance: with a persistent store, replay the prior
        # head's metadata (GcsInitData analog) and flush periodically
        self.gcs_store = None
        self.gcs_replay_s: Optional[float] = None
        # the flush loop's pass and shutdown's last flush and close take it
        # in turn: a pass never runs on a closed store
        self._gcs_flush_lock = threading.Lock()
        if gcs_persistence_path:
            from ray_tpu_torch._private.gcs_storage import SqliteStoreClient

            existed = os.path.exists(gcs_persistence_path)
            self.gcs_store = SqliteStoreClient(gcs_persistence_path)
            if existed:
                t0 = time.perf_counter()
                self.gcs.replay(self.gcs_store)
                self.gcs_replay_s = time.perf_counter() - t0
                logger.info("replayed GCS state from %s (%d kv namespaces, "
                            "%d historical actors)", gcs_persistence_path,
                            len(self.gcs.kv), len(self.gcs.actors))

        self.nodes: Dict[str, NodeState] = {}
        # slices being terminated ON PURPOSE (slice-atomic replacement /
        # idle scale-down): their member deaths are not "degraded".
        # Self-cleaning: the last member's removal discards the mark.
        self._draining_slices: set = set()
        # P2P mesh bookkeeping: highest snapshot version folded per node
        # (version-gated merge at the head too), pruned on node removal
        self._syncer_versions: Dict[str, int] = {}
        self.actors: Dict[bytes, ActorRuntime] = {}
        self.pgs: Dict[bytes, PGRuntime] = {}
        self.pending_tasks: deque = deque()
        # Resource-starved backlog, keyed by placement shape (the
        # reference queues per scheduling class for exactly this reason,
        # cluster_task_manager.h): once a shape fails to place, its
        # tasks wait HERE and a scheduler pass costs O(shapes) + O(new
        # arrivals), never O(backlog).  Rescanning a 1M-task deque every
        # 0.2s pass was quadratic — the head spent whole cores walking
        # tasks that could not possibly place.  FIFO holds within a
        # shape (each shape is one deque); cross-shape order is not
        # guaranteed (same as the reference's scheduling classes).
        self._starved: Dict[tuple, deque] = {}
        self.pending_pgs: deque = deque()
        self.running: Dict[bytes, dict] = {}  # task_id -> {spec, worker, node_id, held, gpu_ids}
        self.workers: Dict[bytes, WorkerHandle] = {}
        self.pending_gets: List[_PendingGet] = []
        # oid -> waiters parked on it (seal-driven O(1) get/wait wakeups)
        self._get_waiters: Dict[bytes, List[_PendingGet]] = {}
        # pubsub channels: long-poll publisher/subscriber analog
        # (src/ray/pubsub/ — node_change/error/log + app channels)
        self.subscribers: Dict[str, List[Connection]] = {}
        import queue as _queue

        self._pub_queue: "_queue.Queue" = _queue.Queue()
        self._req_counter = 0
        self._shutdown = False
        self._head_node_id: str
        # Scheduler wakeup coalescing: N notifications during one pass
        # collapse into a single follow-up pass (the flag survives the
        # notify, so a wake that lands mid-pass is never lost).  The loop
        # also self-polls every 0.2s, so a missed wake costs bounded
        # latency, never a hang.
        self._sched_work = False
        # actors whose next queued method is dep-blocked; a seal retries
        # them inline instead of waking the scheduler (direct actor
        # dispatch stays off the scheduler thread)
        self._dep_blocked_actors: set = set()
        # workers with queued outbox messages awaiting a flush.  Guarded
        # by its own lock (NOT self.lock): execute messages are queued
        # from shard-locked actor dispatch as well as head-locked plain
        # dispatch, and the flush snapshot+clear must be atomic against
        # both.
        self._outbox_pending: set = set()
        self._outbox_lock = make_lock("node.outbox")
        # broadcast fan-out acks: token -> {"event", "ok", "error"}
        self._pull_acks: Dict[str, dict] = {}
        # on-demand worker profiles (the dashboard's /api/profile):
        # token -> {"event", "report"}
        self._profile_acks: Dict[str, dict] = {}
        # accepted connections whose reader threads are alive: shutdown
        # force-closes them (close alone never wakes a blocked recv — the
        # leak that accumulated threads across sessions in one process)
        self._live_conns: set = set()
        # dynamic-return yield directory: task_id -> {"attempt": n, "oids":
        # [..]} in yield order (streamed to ObjectRefGenerator consumers;
        # the attempt counter lets a consumer detect a mid-stream retry)
        self._dynamic_yields: Dict[bytes, dict] = {}
        # parked dynamic_yields long-polls: task_id -> [waiter, ...]
        self._dynamic_waiters: Dict[bytes, List[dict]] = {}
        # multi-tenancy: registered driver connections and the job
        # directory.  ``clients`` holds live connections only; ``_jobs``
        # keeps (bounded) per-job metadata — namespace, pid, liveness —
        # for audit rollups and `ray_tpu_torch list tenants` after a driver dies.
        self.clients: Dict[Any, ClientState] = {}
        self._jobs: Dict[str, dict] = {}
        self._job_counter = 0
        # flipped off by ray_tpu_torch.shutdown() so the in-process driver's own
        # disconnect doesn't run a full tenant reap against a dying head
        self._reap_on_disconnect = True

        total, gpus = autodetect_resources(num_cpus, num_gpus, resources)
        self._head_node_id = "node-head"
        self.add_node_state(self._head_node_id, total, gpus)

        self._conn_locks: Dict[int, threading.Lock] = {}
        self._listener = Listener(self.address, family="AF_UNIX", authkey=self.authkey, backlog=64)
        # TCP control plane: real nodes (node_agent) and their workers join
        # here — the gRPC server of the reference's GCS/raylet (SURVEY §5.8).
        host = os.environ.get("RAY_TPU_TORCH_HOST", "127.0.0.1")
        self._tcp_listener = Listener((host, 0), family="AF_INET",
                                      authkey=self.authkey, backlog=64)
        self.tcp_address: tuple = self._tcp_listener.address
        # Object-transfer plane: every node serves pulls of its local shm
        # segments (ObjectManager analog).
        from ray_tpu_torch._private import object_transfer

        object_transfer.configure(self.authkey)
        self.object_server = object_transfer.ObjectServer(host, self.authkey)
        self.nodes[self._head_node_id].fetch_addr = tuple(self.object_server.addr)
        self.registry.broadcast_unlink = self._broadcast_unlink
        # warm-template worker spawns + orphan reaping: forked workers
        # reparent to this process (subreaper), the reaper loop collects
        # them AND any zombie a dying worker leaves when we're pid 1
        self._subreaper = _set_child_subreaper()
        self._forkserver = (
            None if os.environ.get("RAY_TPU_TORCH_DISABLE_FORKSERVER")
            else _ForkServerClient(self.session_dir))
        self._zombie_seen: Dict[int, float] = {}
        # bounded: one entry per service thread, joined at shutdown
        self._threads = []  # raylint: disable=R5
        t = threading.Thread(target=self._reaper_loop, name="reaper", daemon=True)
        t.start()
        self._threads.append(t)
        if self._forkserver is not None:
            # boot the template OFF the scheduler path: the first worker
            # spawn must never pay the ~2s template boot under head.lock
            t = threading.Thread(target=self._forkserver.prewarm,
                                 name="forkserver-warm", daemon=True)
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._accept_loop, name="accept", daemon=True)
        t.start()
        self._threads.append(t)
        t = threading.Thread(
            target=self._accept_loop, args=(self._tcp_listener,),
            name="accept-tcp", daemon=True,
        )
        t.start()
        self._threads.append(t)
        t = threading.Thread(target=self._scheduler_loop, name="scheduler", daemon=True)
        t.start()
        self._threads.append(t)
        t = threading.Thread(target=self._timeout_loop, name="timeouts", daemon=True)
        t.start()
        self._threads.append(t)
        t = threading.Thread(target=self._publisher_loop, name="publisher", daemon=True)
        t.start()
        self._threads.append(t)
        t = threading.Thread(target=self._gcs_flush_loop, name="gcs-flush", daemon=True)
        t.start()
        self._threads.append(t)
        if self.cfg.memory_monitor_refresh_ms > 0:
            t = threading.Thread(
                target=self._memory_monitor_loop, name="memory-monitor", daemon=True
            )
            t.start()
            self._threads.append(t)
        # flight recorder: worker-shipped events fold in here; the head's
        # own emits live in the process-local ring and dump to the session
        self.events = events_mod.EventTable()
        self._events_dumped_seq = self._session_ring.seq0
        # request traces: span-carrying events (trace source + traced
        # compiled-graph spans) assemble into per-trace span trees here;
        # the head process's own ring is folded lazily at query time
        self.traces = events_mod.TraceTable()
        self._traces_local_seq = self._session_ring.seq0
        self._traces_fold_lock = make_lock("node.traces_fold")
        # job submission (JobManager analog): entrypoint drivers run as
        # subprocesses of the head with the cluster address in their env
        from ray_tpu_torch._private.job_manager import JobManager

        self.job_manager = JobManager(self)
        # merged worker metrics: every worker and node agent pushes its
        # registry snapshot here (metrics_report), folded per origin
        from ray_tpu_torch.util import metrics as metrics_mod

        self.worker_metrics_registry = metrics_mod._Registry()
        # Resource accounting over time: every registry snapshot that
        # reaches the head (worker pushes, node-agent resource samples,
        # the head's own self-sample loop) also folds into a bounded
        # in-memory TSDB, so trends — RSS slopes, store growth, queue
        # climbs — are queryable instead of inferable (util/tsdb.py).
        from ray_tpu_torch.util import tsdb as tsdb_mod

        self.tsdb = tsdb_mod.TimeSeriesStore()
        # Two expiry horizons off the push cadence: the LIVE merged
        # registry drops origins after 3 missed pushes (a dead worker
        # must leave the merged view promptly; the next push self-heals a
        # false positive), while the TSDB keeps series 4x longer — history
        # is the thing a transient pusher backoff must not erase, and a
        # dead process's recent trend is exactly what a post-mortem
        # wants to read.  An origin is only ever expired after it pushed
        # once: a worker still importing torch before its first push is
        # not in the registry yet, so no window can read it as dead.
        self._origin_expiry_s = (tsdb_mod.ORIGIN_EXPIRY_INTERVALS
                                 * metrics_mod.push_interval_s())
        self._tsdb_expiry_s = 4 * self._origin_expiry_s
        # latest per-entity /proc stats for the top view:
        # worker_id hex (or "head"/"agent:<node>") -> stats dict.
        # _proc_lock guards it — folded by connection-handler threads,
        # rebuilt by the sampler tick, read by top_snapshot; never under
        # self.lock.
        self._proc_live: Dict[str, dict] = {}
        self._proc_lock = make_lock("node.proc_live")
        # worker_id hex -> when its /proc rows start to enter the TSDB's
        # history (_history_rows): WORKER_WARMUP_S after its first plain
        # task or its actor's constructor finished, or WORKER_START_BOUND_S
        # after it registered, whichever comes first
        self._history_from: Dict[str, float] = {}
        self._tsdb_stop = threading.Event()
        t = threading.Thread(target=self._tsdb_loop, name="tsdb-sampler",
                             daemon=True)
        t.start()
        self._threads.append(t)
        self._dispatch_n = 0  # dispatch-event sampling counter
        # continuous profiling plane: every process's ContinuousProfiler
        # batch-ships folded stacks over its existing control connection
        # (profile_report frames); they land here.  The head samples
        # itself straight into the store — no loopback connection.
        from ray_tpu_torch.util.profile_store import ProfileStore

        self.profile_store = ProfileStore()
        self._head_profiler = None
        from ray_tpu_torch._private import sampling_profiler as _sp

        self._profile_retire_s = self._tsdb_expiry_s
        if _sp.continuous_enabled():
            self._head_profiler = _sp.ContinuousProfiler(
                "head", ingest_fn=self.profile_store.ingest,
                closed_fn=lambda: self._shutdown).start()
            # every process's profiler runs with the head's settings (the
            # env is inherited)
            self._profile_retire_s = max(self._tsdb_expiry_s,
                                         2 * self._head_profiler.max_interval_s)
        # cluster log plane: local capture files (head, local workers,
        # job drivers) tail into the head's bounded store; node agents
        # ship their workers' files as log_report frames into the same
        # ingest.  Driver streaming rides pubsub on "logs:<job>" channels.
        from ray_tpu_torch._private import log_plane as log_plane_mod
        from ray_tpu_torch.util.log_store import LogStore

        self.log_store = LogStore(emit_fn=events_mod.emit)
        self._log_monitor = None
        self._head_log_handler = None
        if log_plane_mod.enabled():
            self._log_monitor = log_plane_mod.LogMonitor(
                self._head_node_id, ingest_fn=self._ingest_log_report,
                closed_fn=lambda: self._shutdown)
            # the head shares the driver's process and cannot dup2 the
            # user's tty away; its ray_tpu_torch.* logger records mirror
            # into logs/head.log instead
            head_log = os.path.join(self.session_dir, "logs", "head.log")
            self._head_log_handler = log_plane_mod.attach_logger_capture(
                head_log)
            self._log_monitor.register(
                "head", head_log, node=self._head_node_id,
                pid=os.getpid(), src="I")
            self._log_monitor.start()
        # watchdog plane: continuous incremental-doctor + SLO burn-rate
        # evaluation folding into the incident lifecycle; post-mortem
        # bundles land under <session>/incidents/<id>/
        from ray_tpu_torch.util import watchdog as watchdog_mod

        self.watchdog = None
        try:
            self.watchdog = watchdog_mod.Watchdog(self)
            self.watchdog.start()
        except Exception:
            logger.warning("watchdog failed to start:\n%s",
                           traceback.format_exc())
        # the dashboard: on the control plane's host, on a port the kernel
        # picks (heads of several sessions share a host)
        self.dashboard = None
        try:
            from ray_tpu_torch.dashboard import Dashboard

            self.dashboard = Dashboard(self, host=host, port=0)
            logger.info("dashboard at http://%s:%d", *self.dashboard.address)
        except Exception:
            logger.warning("dashboard failed to start:\n%s", traceback.format_exc())
        # session discovery for `ray_tpu_torch.init(address="auto")` / the CLI
        self._write_session_file()
        # Prestart the plain worker pool up to the CPU count (WorkerPool
        # prestart, reference worker_pool.h:156 num_prestart_python_workers).
        # Boots overlap with early driver work; spawning lazily instead
        # means later parallel load starves the forked interpreters of CPU
        # and the pool never ramps while the cluster is busy.
        with self.lock:
            head_ns = self.nodes[self._head_node_id]
            n_prestart = self.cfg.num_prestart_workers
            if n_prestart < 0:
                n_prestart = max(1, min(int(head_ns.total.get(CPU, 1)), 4))
            for _ in range(n_prestart):
                self._spawn_worker(head_ns)

    def _write_session_file(self) -> None:
        """Discovery record for address="auto" drivers (the reference's
        /tmp/ray/ray_current_cluster analog), under ``session_root()``."""
        import json

        path = os.path.join(session_root(), "last_session.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        host, port = self.tcp_address
        payload = {
            "address": f"tcp://{host}:{port}",
            "authkey": self.authkey.hex(),
            "session_dir": self.session_dir,
            "session_id": self.session_id,
            "pid": os.getpid(),
            "dashboard": list(self.dashboard.address) if self.dashboard else None,
        }
        fd = os.open(path + ".tmp", os.O_CREAT | os.O_TRUNC | os.O_WRONLY, 0o600)
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
        os.replace(path + ".tmp", path)

    # ------------------------------------------------------------------
    # topology
    # ------------------------------------------------------------------
    def add_node_state(
        self,
        node_id: str,
        total: Dict[str, float],
        gpu_ids: Optional[List[int]] = None,
        env: Optional[Dict[str, str]] = None,
        slice_id: Optional[str] = None,
    ) -> None:
        with self.lock:
            ns = NodeState(
                node_id=node_id,
                total=dict(total),
                available=dict(total),
                gpu_share={i: 1.0 for i in gpu_ids or []},
                env=dict(env or {}),
                slice_id=slice_id,
                shard=self.shards.for_node(node_id),
            )
            self.nodes[node_id] = ns
            self.gcs.nodes[node_id] = NodeInfo(node_id=node_id, resources=dict(total),
                                               slice_id=slice_id)
            self._wake_scheduler()
        events_mod.emit("node", "node joined", entity_id=node_id,
                        resources=dict(total), slice_id=slice_id)

    def remove_node_state(self, node_id: str) -> None:
        """Simulate node death (Cluster.remove_node / chaos NodeKiller analog)."""
        slice_state = None  # (slice_id, alive_siblings, gang_size) | None
        with self.lock:
            ns = self.nodes.get(node_id)
            if ns is None or not ns.alive:
                # already removed — this path now has concurrent callers
                # (missed-pong monitor, conn EOF, syncer death rumor /
                # suspect quorum); re-running the body would double-emit
                # 'node removed'/'slice degraded' and re-reconstruct
                return
            ns.alive = False
            ns.agent_conn = None
            self._syncer_versions.pop(node_id, None)
            if node_id in self.gcs.nodes:
                self.gcs.nodes[node_id].alive = False
            if ns.slice_id is not None:
                siblings = [n for n in self.nodes.values()
                            if n.slice_id == ns.slice_id
                            and n.node_id != node_id]
                alive_sib = sum(1 for n in siblings if n.alive)
                if alive_sib == 0:
                    # last member gone: the slice is fully drained/dead;
                    # the draining mark has done its job
                    self._draining_slices.discard(ns.slice_id)
                elif ns.slice_id not in self._draining_slices:
                    # an UNEXPECTED member death leaves the slice degraded
                    # (a deliberate slice-atomic termination marks the
                    # slice draining first and stays silent here)
                    slice_state = (ns.slice_id, alive_sib, len(siblings) + 1)
            # tasks staged on the dead node (resources held, waiting for a
            # worker) go back to the cluster-wide pending queue — their
            # held resources died with the node
            with ns.shard.lock:
                staged = list(ns.ready_queue)
                ns.ready_queue.clear()
            for spec, _gpu_ids, _bundle in staged:
                self.pending_tasks.append(spec)
            victims = [w for w in self.workers.values() if w.node_id == node_id and w.state != "dead"]
        for w in victims:
            try:
                if w.proc:
                    w.proc.kill()
                elif w.conn is not None:
                    # remote worker orphaned by its agent's death: tell it
                    # to exit (we cannot signal a process on another host)
                    w.send({"type": "exit"})
            except Exception:
                pass
            self._on_worker_death(w, reason=f"node {node_id} removed")
        self.publish("node_change", {"node_id": node_id, "alive": False})
        events_mod.emit("node", "node removed", severity="WARNING",
                        entity_id=node_id, staged_tasks=len(staged))
        if slice_state is not None:
            # a slice is ONE failure domain: a dead member wedges any
            # STRICT gang on it — doctor's slice_degraded rule watches
            # for this event without a replacement in flight
            sid, alive_sib, gang = slice_state
            events_mod.emit(
                "node", "slice degraded", severity="ERROR", entity_id=sid,
                dead_node=node_id, alive_members=alive_sib, gang_size=gang)
        self._broadcast_syncer_peers()
        self._reconstruct_lost_objects(node_id)
        with self.lock:
            self._wake_scheduler()

    def _reconstruct_lost_objects(self, node_id: str) -> None:
        """Lineage reconstruction (ObjectRecoveryManager +
        TaskManager-resubmission analog, reference
        ``object_recovery_manager.h:41``): finished objects whose only copy
        lived on the dead node are recomputed by resubmitting their
        creating task; objects with no lineage (ray.put data, actor
        returns, evicted lineage) seal an ObjectLostError instead."""
        from ray_tpu_torch.exceptions import ObjectLostError
        from ray_tpu_torch._private.object_ref import ObjectRef
        from ray_tpu_torch._private.object_store import store_value

        lost = self.registry.mark_node_lost(node_id)
        if not lost:
            return
        resubmitted = set()
        n_rebuilt = 0
        for oid in lost:
            spec = self.lineage.get(oid)
            if spec is None or spec.get("actor_id"):
                err = ObjectLostError(
                    f"object {oid.hex()} lost with node {node_id} and has no "
                    "lineage (ray.put data and actor returns are not "
                    "reconstructable)"
                )
                loc, _ = store_value(ObjectRef(oid), err, is_error=True)
                self.registry.seal(oid, loc, only_if_live=True)
                self._notify_sealed(oid)
                continue
            tid = spec["task_id"]
            if tid in resubmitted:
                continue
            resubmitted.add(tid)
            # a dep whose registry entry is gone (refcount-deleted) can
            # never seal again — the resubmission would wait forever.
            # Seal errors directly: the spec's pins were already released
            # at its first completion, so _seal_error_returns (which
            # releases them again) must not run here.
            if any(not self.registry.contains(d) for d in spec.get("dep_ids", [])):
                err = ObjectLostError(
                    f"cannot reconstruct {oid.hex()}: an argument object "
                    "was already released"
                )
                for rid in spec["return_ids"]:
                    # only live entries, checked atomically inside seal:
                    # resurrecting a refcount-deleted return would leak
                    loc, _ = store_value(ObjectRef(rid), err, is_error=True)
                    self.registry.seal(rid, loc, only_if_live=True)
                    self._notify_sealed(rid)
                continue
            n_rebuilt += 1
            # deps that died in the same event are themselves in `lost` and
            # get resubmitted by this same loop; _deps_ready blocks until
            # they re-seal, so the reconstruction recursion falls out of
            # ordinary scheduling
            copy = dict(spec)
            # the original pins were popped at first completion; re-pin the
            # args for the re-execution (released again when it finishes)
            repin = [d for d in copy.get("dep_ids", []) if self.registry.contains(d)]
            for d in repin:
                self.registry.add_ref(d, reason="task_arg")
            copy["pinned_refs"] = repin
            # an affinity to the dead node would leave the resubmission
            # unschedulable forever; reconstruction may run anywhere
            strat = copy.get("scheduling_strategy")
            if isinstance(strat, dict) and strat.get("node_id") == node_id:
                copy["scheduling_strategy"] = None
            self.submit_task(copy, _resubmit=True)
        if n_rebuilt or len(lost):
            logger.warning(
                "node %s: %d objects lost; resubmitted %d creating tasks",
                node_id, len(lost), n_rebuilt,
            )

    # ------------------------------------------------------------------
    # connection handling
    # ------------------------------------------------------------------
    def _accept_loop(self, listener: Optional[Listener] = None) -> None:
        from multiprocessing import AuthenticationError

        listener = listener or self._listener
        failures = 0
        while not self._shutdown:
            try:
                conn = wire.wrap(listener.accept())
                failures = 0
            except (AuthenticationError, OSError, EOFError):
                # one peer dying mid-handshake (EOF/reset) or failing auth
                # must not kill the listener; only stop when we're shutting
                # down or the listener socket itself is persistently broken
                if self._shutdown:
                    break
                failures += 1
                if failures > 100:
                    logger.error("accept loop: listener persistently failing; exiting")
                    break
                continue
            t = threading.Thread(target=self._reader_loop, args=(conn,), daemon=True)
            t.start()

    def _reader_loop(self, conn: Connection) -> None:
        handle: Optional[WorkerHandle] = None
        agent_node_id: Optional[str] = None
        is_client = False
        with self.lock:
            self._conn_locks[id(conn)] = make_lock("node.conn")
            self._live_conns.add(conn)
        try:
            while not self._shutdown:
                try:
                    msg = conn.recv()
                except (EOFError, OSError, pickle.UnpicklingError):
                    break
                mtype = msg["type"]
                if mtype == "register_worker":
                    handle = self._on_register_worker(conn, msg)
                elif mtype == "register_client":
                    is_client = True  # driver or external client connection
                    self._on_register_client(conn, msg)
                elif mtype == "register_node":
                    agent_node_id = self._on_register_node(conn, msg)
                elif mtype == "worker_exited":
                    self._on_remote_worker_exited(msg)
                elif mtype == "pong":
                    if agent_node_id is not None:
                        with self.lock:
                            ns = self.nodes.get(agent_node_id)
                            if ns is not None:
                                ns.last_heartbeat = time.time()
                                if msg.get("stats"):
                                    ns.host_stats = msg["stats"]
                elif mtype == "object_pulled":
                    holder = self._pull_acks.pop(msg.get("token"), None)
                    if holder is not None:
                        holder["ok"] = bool(msg.get("ok"))
                        holder["error"] = msg.get("error")
                        holder["event"].set()
                elif mtype == "syncer_report":
                    self._on_syncer_report(msg)
                else:
                    self._handle_message(conn, handle, msg)
        finally:
            # release the fd NOW: WorkerHandle/agent references keep the
            # Connection object alive long after EOF, and unclosed accepted
            # conns were the per-session fd leak
            try:
                conn.close()
            except Exception:
                pass
            with self.lock:
                self._live_conns.discard(conn)
                # a disconnected peer's pubsub subscriptions die with it
                for subs in self.subscribers.values():
                    if conn in subs:
                        subs.remove(conn)
            if handle is not None:
                self._on_worker_death(handle, reason="connection closed")
            elif agent_node_id is not None:
                with self.lock:
                    ns = self.nodes.get(agent_node_id)
                    stale = ns is None or ns.agent_conn is not conn
                if stale:
                    # a newer incarnation of this node re-registered while
                    # this connection lingered; don't kill the replacement
                    pass
                else:
                    logger.warning("node %s lost (agent connection closed)", agent_node_id)
                    self.remove_node_state(agent_node_id)
            elif is_client:
                self._on_client_disconnect(conn)

    # ------------------------------------------------------------------
    # driver/tenant connections (multi-tenancy half of GcsJobManager)
    # ------------------------------------------------------------------
    _MAX_JOB_RECORDS = 1024

    def _on_register_client(self, conn: Connection, msg: dict) -> None:
        """A driver registered: assign it a job id, record its namespace,
        and reply with the identity (``get_runtime_context().job_id``).
        Proxied tenant drivers arrive with ``proxied=True`` and the driver
        subprocess's pid — the pid chaos kills and doctor explains."""
        with self.lock:
            self._job_counter += 1
            job_id = f"job-{self._job_counter:04d}"
            namespace = msg.get("namespace") or "default"
            st = ClientState(
                job_id=job_id, namespace=namespace, conn=conn,
                pid=msg.get("pid"), proxied=bool(msg.get("proxied")))
            self.clients[conn] = st
            self._jobs[job_id] = {
                "job_id": job_id, "namespace": namespace, "pid": st.pid,
                "proxied": st.proxied, "alive": True,
                "connected_at": st.connected_at, "job_name": msg.get("job_name"),
            }
            if len(self._jobs) > self._MAX_JOB_RECORDS:
                # bounded directory: retire the oldest DEAD records first
                for jid in [j for j, r in self._jobs.items()
                            if not r["alive"]][:len(self._jobs) // 4]:
                    del self._jobs[jid]
        events_mod.emit(
            "client_proxy",
            f"tenant registered ({'proxied' if st.proxied else 'direct'})",
            severity="DEBUG", entity_id=job_id, namespace=namespace,
            pid=st.pid)
        if msg.get("req_id") is not None:
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": {"job_id": job_id,
                                         "namespace": namespace}})

    def _on_client_disconnect(self, conn: Connection) -> None:
        """A driver connection closed: release everything the job owned.
        Non-detached actors it created are killed, its named entries leave
        the namespace directory, and every object pin it held (initial
        put/return counts + announced borrows) is dropped.  Detached
        actors survive by design (reference Ray Client proxier semantics:
        driver death reaps the SpecificServer and its job's state)."""
        with self.lock:
            st = self.clients.pop(conn, None)
            if st is not None:
                rec = self._jobs.get(st.job_id)
                if rec is not None:
                    rec["alive"] = False
                    rec["disconnected_at"] = time.time()
        if st is None or self._shutdown or not self._reap_on_disconnect:
            return
        with self.gcs.lock:
            owned_actors = [a for a in self.gcs.actors.values()
                            if a.job_id == st.job_id]
        to_kill = [a for a in owned_actors
                   if a.lifetime != "detached" and a.state != "DEAD"]
        detached = sum(1 for a in owned_actors if a.lifetime == "detached")
        if not to_kill and not st.owned and not st.pinned:
            # nothing owned: a clean exit, not an incident (keeps doctor
            # quiet for every CLI session and tidy driver shutdown)
            events_mod.emit(
                "client_proxy", "tenant disconnected", severity="DEBUG",
                entity_id=st.job_id, namespace=st.namespace)
            return
        if not st.leaving:
            # the died/reaped event PAIR is the doctor's tenant_killed
            # food: died opens the incident, reaped closes it (a crash
            # between the two leaves an open ERROR — the reap really is
            # wedged then).  A driver that said it was leaving is reaped
            # the same way but records one clean "tenant disconnected".
            events_mod.emit(
                "client_proxy", "tenant driver died", severity="WARNING",
                entity_id=st.job_id, namespace=st.namespace, pid=st.pid,
                live_actors=len(to_kill))
        for info in to_kill:
            self.kill_actor(info.actor_id)
        released = len(st.owned)
        self.registry.remove_refs(list(st.owned), reason="handle")
        for oid, n in list(st.pinned.items()):
            self.registry.remove_ref(oid, n=n, reason="handle")
            released += 1
        st.owned.clear()
        st.pinned.clear()
        events_mod.emit(
            "client_proxy",
            "tenant disconnected" if st.leaving else "tenant reaped",
            severity="INFO", entity_id=st.job_id, namespace=st.namespace,
            killed_actors=len(to_kill), detached_survivors=detached,
            released_refs=released)
        logger.info(
            "tenant %s (namespace %s) disconnected: reaped %d actors, "
            "released %d pins, %d detached survivors",
            st.job_id, st.namespace, len(to_kill), released, detached)

    def _on_register_node(self, conn: Connection, msg: dict) -> str:
        """A node_agent joined over TCP (the raylet-registers-with-GCS path,
        ``GcsNodeManager`` analog)."""
        node_id = msg["node_id"]
        self.add_node_state(node_id, msg["resources"], msg.get("gpu_ids"),
                            slice_id=msg.get("slice_id"))
        with self.lock:
            ns = self.nodes[node_id]
            ns.agent_conn = conn
            ns.agent_send_lock = self._conn_lock(conn)
            ns.fetch_addr = tuple(msg["fetch_addr"]) if msg.get("fetch_addr") else None
            ns.syncer_addr = tuple(msg["syncer_addr"]) if msg.get("syncer_addr") else None
            self._wake_scheduler()
        logger.info("node %s joined with %s", node_id, msg["resources"])
        self.publish("node_change", {"node_id": node_id, "alive": True,
                                     "resources": msg["resources"]})
        self._broadcast_syncer_peers()
        return node_id

    # ------------------------------------------------------------------
    # P2P resource/health mesh (head side of _private/syncer.py)
    # ------------------------------------------------------------------
    def _broadcast_syncer_peers(self) -> None:
        """Ship the mesh directory to every agent (on membership change).
        The directory is the union of alive syncer-capable nodes; agents
        prune their stores to it."""
        with self.lock:
            peers = {nid: list(ns.syncer_addr)
                     for nid, ns in self.nodes.items()
                     if ns.alive and ns.syncer_addr}
            agents = [ns for ns in self.nodes.values()
                      if ns.alive and ns.agent_conn is not None]
        if not peers:
            return
        for ns in agents:
            try:
                ns.agent_send({"type": "syncer_peers", "peers": peers})
            except (OSError, ValueError):
                pass  # its conn-close path will reap it

    def mark_slice_draining(self, slice_id: str, draining: bool = True) -> None:
        """Deliberate slice-atomic termination in progress: member deaths
        of a draining slice are expected, not 'degraded'.  The mark
        self-clears when the last member is removed."""
        with self.lock:
            if draining:
                self._draining_slices.add(slice_id)
            else:
                self._draining_slices.discard(slice_id)

    def _on_syncer_report(self, msg: dict) -> None:
        """Fold one agent's converged mesh view.

        Version-gated exactly like the agents' own merges: any snapshot
        strictly newer than what the head has folded counts as a
        heartbeat for THAT node (its author was alive at snap ts) — so a
        node whose direct link to the head is broken stays alive and
        fresh through its peers' reports, and the head is no longer the
        sole fan-in for liveness.  Death rumors (connection refused — the
        peer's listener is gone) and suspect quorums (>= SUSPECT_QUORUM
        distinct observers of an unresponsive peer) remove nodes ahead of
        the missed-pong timeout; both are double-checked against the
        head's own recent direct contact so a one-sided partition can't
        kill a node the head still hears from."""
        from ray_tpu_torch._private.syncer import SUSPECT_QUORUM

        now = time.time()
        period = self.cfg.health_check_period_s
        to_remove: Dict[str, Tuple[str, dict]] = {}  # nid -> (why, data);
        # dict, not list: a paused-then-killed node sits in BOTH the
        # deaths and suspects tables — remove it once
        with self.lock:
            for nid, snap in (msg.get("snaps") or {}).items():
                ns = self.nodes.get(nid)
                if ns is None or not ns.alive:
                    continue
                version = int(snap.get("version", 0))
                if version <= self._syncer_versions.get(nid, 0):
                    continue
                self._syncer_versions[nid] = version
                ts = min(float(snap.get("ts", now)), now)
                if ts > ns.last_heartbeat:
                    ns.last_heartbeat = ts
                if snap.get("stats") and ns.agent_conn is not None:
                    ns.host_stats = snap["stats"]
            for nid, death in (msg.get("deaths") or {}).items():
                ns = self.nodes.get(nid)
                if (ns is not None and ns.alive
                        and now - ns.last_heartbeat > period):
                    to_remove[nid] = ("peer-detected node death", {
                        "observer": death.get("by"),
                        "detect_latency_s": round(now - death.get("ts", now), 3),
                    })
            for nid, observers in (msg.get("suspects") or {}).items():
                ns = self.nodes.get(nid)
                if (nid not in to_remove and ns is not None and ns.alive
                        and len(observers) >= SUSPECT_QUORUM
                        and now - ns.last_heartbeat > 2 * period):
                    to_remove[nid] = ("peer-quorum node unresponsive", {
                        "observers": sorted(observers)[:8],
                        "quorum": len(observers),
                    })
        for nid, (why, data) in to_remove.items():
            logger.warning("syncer: removing node %s (%s)", nid, why)
            events_mod.emit("syncer", why, severity="ERROR", entity_id=nid,
                            **data)
            self.remove_node_state(nid)

    def _on_remote_worker_exited(self, msg: dict) -> None:
        # the agent drained the worker's capture file before it sent this
        # message, so the stream's tail is whole now; the death itself may
        # have been handled first, on the worker's own connection closing,
        # when the final lines had not yet arrived to retire
        self.log_store.retire(f"worker-{msg['worker_id']}")
        wid = bytes.fromhex(msg["worker_id"])
        with self.lock:
            h = self.workers.get(wid)
        if h is not None and h.state != "dead":
            rc = msg.get("returncode")
            extra = f" ({msg['error']})" if msg.get("error") else ""
            self._on_worker_death(
                h, reason=f"exited with code {rc}{extra}"
                          + ("" if h.conn else " before registering")
            )

    def _conn_lock(self, conn: Connection) -> threading.Lock:
        with self.lock:
            return self._conn_locks.setdefault(id(conn), make_lock("node.conn"))

    # execute-message spec subset: everything the worker's executor reads
    # (ray_tpu_torch/_private/worker.py _execute_task/_seal_and_report); head-only
    # bookkeeping fields (pins, retries, placement) stay off the wire
    _EXEC_KEYS = (
        "task_id", "name", "fn_id", "args_blob", "args_oid",
        "is_actor_creation", "actor_id", "method_name",
        "num_returns", "return_ids", "trace_ctx", "dynamic_returns",
        "compiled_graph",
        # tenant identity (runtime context + namespace-scoped lookups in
        # the task) and concurrency-group routing at the worker's pools
        "job_id", "namespace", "concurrency_group",
    )

    def _agent_node_or_head(self, node_id: str) -> str:
        """Normalize a consumer's node for location selection: emulated /
        head-local nodes share the head's shm namespace, so they read as
        the head ("")."""
        ns = self.nodes.get(node_id)
        return node_id if ns is not None and ns.agent_conn is not None else ""

    def _queue_execute(self, w: WorkerHandle, spec: dict,
                       gpu_ids: List[int]) -> None:
        """Queue an execute message for ``w`` (caller holds the lock that
        serializes this worker's dispatch: the node lock for plain tasks,
        the actor's shard lock for actor methods).  The actual pipe write
        happens in _flush_sends, outside every dispatch lock; per-worker
        FIFO order is the outbox append order, which that lock serializes."""
        spec_wire = {k: spec[k] for k in self._EXEC_KEYS
                     if spec.get(k) is not None}
        msg = {"type": "execute", "spec": spec_wire}
        dep_locs = self._dep_locations(spec, self._agent_node_or_head(w.node_id))
        if dep_locs:
            msg["dep_locs"] = dep_locs
        if gpu_ids:
            msg["gpu_ids"] = gpu_ids
        w.outbox.append(msg)
        with self._outbox_lock:
            self._outbox_pending.add(w)

    def _flush_sends(self) -> None:
        """Drain queued worker messages outside the dispatch locks.  Safe
        to call from any thread; concurrent flushers serialize per worker
        on its send_lock, and deque append/popleft are GIL-atomic, so
        per-worker order is preserved.  Send failures surface as worker
        death."""
        with self._outbox_lock:
            if not self._outbox_pending:
                return
            pending = list(self._outbox_pending)
            self._outbox_pending.clear()
        dead: List[WorkerHandle] = []
        for w in pending:
            with w.send_lock:
                while w.outbox:
                    try:
                        msg = w.outbox.popleft()
                    except IndexError:
                        break
                    try:
                        w.conn.send(msg)
                    except (OSError, ValueError, AttributeError):
                        w.outbox.clear()
                        dead.append(w)
                        break
        for w in dead:
            self._on_worker_death(w, reason="send failed")

    def _reply(self, conn: Connection, msg: dict) -> None:
        try:
            with self._conn_lock(conn):
                conn.send(msg)
        except (OSError, ValueError):
            pass

    def _on_put_blob(self, conn: Connection, msg: dict) -> None:
        """Store a thin client's shipped payload head-side and seal it
        (Ray Client put).  Failures reply as errors — they must not tear
        down the connection's serve loop."""
        from ray_tpu_torch._private.object_store import store_blob
        from ray_tpu_torch._private.object_ref import ObjectRef as _Ref

        try:
            loc = store_blob(_Ref(msg["oid"]), msg["blob"],
                             is_error=msg.get("is_error", False))
            client = self.clients.get(conn)
            if client is not None:
                client.owned.add(msg["oid"])
            self.seal_object(msg["oid"], loc, msg.get("contained", []),
                             client=client)
            value = True
        except Exception as e:  # noqa: BLE001 — ANY failure must reply,
            # or the client blocks on its 300 s request timeout
            value = {"error": f"put failed: {type(e).__name__}: {e}"}
        self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                           "value": value})
        self._flush_sends()  # the seal may have unblocked actor dispatches

    def _on_get_blob(self, conn: Connection, msg: dict) -> None:
        """Ship an object's serialized payload to a thin client."""
        from ray_tpu_torch._private.object_store import payload_bytes

        loc = self.registry.wait_sealed_existing(msg["oid"], msg.get("timeout"))
        if loc == "missing":
            reply = {"error": f"unknown or released object {msg['oid'].hex()}"}
        elif loc is None:
            reply = {"timeout": True}
        else:
            try:
                reply = {"blob": payload_bytes(loc), "is_error": loc.is_error}
            except FileNotFoundError:
                # segment spilled/moved between the location read and the
                # attach — one refetch gets the fresh location (same race
                # the fat-client get handles)
                loc = self.registry.wait_sealed_existing(msg["oid"], 5.0)
                try:
                    if loc in (None, "missing"):
                        # the broad arm below turning this into an
                        # error reply IS the handling
                        # raylint: disable=R2
                        raise FileNotFoundError(msg["oid"].hex())
                    reply = {"blob": payload_bytes(loc), "is_error": loc.is_error}
                except (OSError, ValueError) as e:
                    reply = {"error": f"payload read failed: {e}"}
            except (OSError, ValueError) as e:
                reply = {"error": f"payload read failed: {e}"}
        self._reply(conn, {"type": "reply", "req_id": msg["req_id"], "value": reply})

    def _handle_message(self, conn: Connection, worker: Optional[WorkerHandle], msg: dict) -> None:
        mtype = msg["type"]
        # driver connections own what they create: returns/puts/borrows are
        # recorded on the ClientState so a disconnect releases exactly them
        client = self.clients.get(conn) if worker is None else None
        if mtype == "submit_batch":
            # coalesced submissions from one client, in submission order
            for kind, spec in msg["batch"]:
                if client is not None:
                    client.owned.update(spec.get("return_ids", ()))
                if kind == "task":
                    self.submit_task(spec)
                else:
                    self.submit_actor_task(spec)
        elif mtype == "seal":
            if client is not None:
                client.owned.add(msg["oid"])
            self.seal_object(msg["oid"], msg["loc"], msg.get("contained", []),
                             sealer=worker, client=client)
        elif mtype == "get_locations":
            self._on_get_request(conn, msg, worker)
        elif mtype == "wait":
            self._on_wait_request(conn, msg, worker)
        elif mtype == "task_done":
            # returns travel inside the done message (one send per task);
            # seal them first so dependents and parked gets wake in order
            for oid, loc, contained in msg.get("seals", ()):
                self.seal_object(oid, loc, contained, sealer=worker)
            self._on_task_done(worker, msg)
        elif mtype == "create_actor":
            if client is not None:
                client.owned.update(msg["spec"].get("return_ids", ()))
            self.create_actor(msg["spec"])
        elif mtype == "kill_actor":
            self.kill_actor(msg["actor_id"], no_restart=msg.get("no_restart", True))
        elif mtype == "cancel_task":
            try:
                self.cancel_task(msg["oid"], force=msg.get("force", False),
                                 recursive=msg.get("recursive", True))
                err = None
            except ValueError as e:
                err = str(e)
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": err})
        elif mtype == "kv_put":
            self.gcs.kv_put(msg["ns"], msg["key"], msg["value"])
        elif mtype == "kv_get":
            val = self.gcs.kv_get(msg["ns"], msg["key"])
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"], "value": val})
        elif mtype == "blocked":
            self._on_blocked(worker, True)
        elif mtype == "unblocked":
            self._on_blocked(worker, False)
        elif mtype == "pipeline_returned":
            self._on_pipeline_returned(worker, msg)
        elif mtype == "add_ref":
            reason = msg.get("reason", "handle")
            if client is not None and reason == "handle":
                for oid in msg["oids"]:
                    client.pinned[oid] = client.pinned.get(oid, 0) + 1
            # one batch call into the ref index (GIL-released in the
            # native build) instead of a per-oid registry-lock hop
            self.registry.add_refs(msg["oids"], reason=reason)
        elif mtype == "remove_ref":
            reason = msg.get("reason", "handle")
            if client is not None and reason == "handle":
                for oid in msg["oids"]:
                    # one remove covers the client's whole local count:
                    # either the initial owned pin or its announced borrow
                    if oid in client.owned:
                        client.owned.discard(oid)
                    else:
                        n = client.pinned.pop(oid, 1) - 1
                        if n > 0:
                            client.pinned[oid] = n
            self.registry.remove_refs(msg["oids"], reason=reason)
        elif mtype == "create_pg":
            self.create_placement_group(msg["spec"])
        elif mtype == "remove_pg":
            self.remove_placement_group(msg["pg_id"])
        elif mtype == "get_actor_by_name":
            # namespace-scoped: the caller names its namespace explicitly
            # (client resolves from its runtime context); a tenant cannot
            # see another namespace's entries without asking for them
            ns_name = msg.get("namespace") or (
                client.namespace if client is not None else "default")
            with self.lock:
                aid = self.gcs.named_actors.get((ns_name, msg["name"]))
                info = self.actors[aid].info if aid in self.actors else None
                if info is not None and info.state == "DEAD":
                    aid = info = None  # dead actors are not lookup targets
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": (aid, info.creation_spec.get("class_blob_id") if info else None)})
        elif mtype == "state_snapshot":
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"], "value": self._state_snapshot()})
        elif mtype == "actor_states":
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": self._actor_states(msg["actor_ids"])})
        elif mtype == "subscribe":
            with self.lock:
                subs = self.subscribers.setdefault(msg["channel"], [])
                if conn not in subs:
                    subs.append(conn)
        elif mtype == "unsubscribe":
            with self.lock:
                subs = self.subscribers.get(msg["channel"], [])
                if conn in subs:
                    subs.remove(conn)
        elif mtype == "publish":
            self.publish(msg["channel"], msg["data"])
        elif mtype == "whoami":
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": {"session_id": self.session_id,
                                         "head_node_id": self._head_node_id}})
        elif mtype == "client_leaving":
            # the driver's shutdown(): its disconnect that follows on this
            # connection is a clean exit (the reap still runs)
            if client is not None:
                client.leaving = True
        elif mtype == "put_blob":
            # off-thread like get_blob: a multi-GB shm write must not stall
            # this connection's reader loop (the client multiplexes
            # concurrent requests over it)
            threading.Thread(
                target=self._on_put_blob, args=(conn, msg), daemon=True
            ).start()
        elif mtype == "get_blob":
            # served off-thread: wait_sealed may block for minutes and this
            # reader loop must keep handling the connection's other traffic
            threading.Thread(
                target=self._on_get_blob, args=(conn, msg), daemon=True
            ).start()
        elif mtype == "profile_result":
            holder = self._profile_acks.pop(msg.get("token"), None)
            if holder is not None:
                holder["report"] = msg.get("report")
                holder["event"].set()
        elif mtype == "replica_added":
            self._on_replica_added(worker, msg)
        elif mtype == "dynamic_yield":
            # a dynamic task produced one more return (already sealed — the
            # seal precedes this message on the same connection)
            with self.lock:
                d = self._dynamic_yields.setdefault(
                    msg["task_id"], {"attempt": 0, "oids": []})
                d["oids"].append(msg["oid"])
            self._wake_dynamic_waiters(msg["task_id"])
        elif mtype == "dynamic_yields":
            self._on_dynamic_yields_request(conn, msg)
        elif mtype == "broadcast":
            # fan-out takes seconds for big objects — never on a reader thread
            threading.Thread(
                target=self._on_broadcast, args=(conn, msg), daemon=True
            ).start()
        elif mtype == "submit_job":
            try:
                value = self.job_manager.submit(
                    msg["entrypoint"], msg.get("runtime_env"), msg.get("job_id"),
                    msg.get("metadata"))
            except ValueError as e:  # a duplicate job id
                value = {"__state_error__": str(e)}
            else:
                if self._log_monitor is not None:
                    # the job driver's log file joins the tail set, so its
                    # lines reach the store/CLI like any worker's
                    self._log_monitor.register(
                        f"job-{value}",
                        os.path.join(self.session_dir, "jobs", f"{value}.log"),
                        node=self._head_node_id, job=value)
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"], "value": value})
        elif mtype == "job_info":
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": self.job_manager.info(msg["job_id"])})
        elif mtype == "job_logs":
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": self.job_manager.logs(msg["job_id"])})
        elif mtype == "stop_job":
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": self.job_manager.stop(msg["job_id"])})
        elif mtype == "list_state":
            try:
                rows, total = self._list_state_page(
                    msg["what"], msg.get("limit", 1000), msg.get("filters"))
            except ValueError as e:
                # in-band error marker: a table the port does not keep
                rows, total = {"__state_error__": str(e)}, 0
            # total rides next to the rows so clients can surface
            # truncation instead of passing a partial view off as complete
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": rows, "total": total})
        elif mtype == "summarize_state":
            try:
                value = self._summarize_state(msg["what"])
            except ValueError as e:
                # in-band error marker: a top-level "error" key means a
                # transport failure to the client, not a bad argument
                value = {"__state_error__": str(e)}
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": value})
        elif mtype == "metrics_report":
            # connection-handler thread: the registry and the TSDB take
            # their own locks, the top cache _proc_lock; never self.lock
            self.worker_metrics_registry.merge(msg["origin"], msg["metrics"])
            self.tsdb.ingest(msg["origin"], self._history_rows(msg["metrics"]))
            self._fold_resource_report(msg["origin"], msg["metrics"])
        elif mtype == "profile_report":
            self.profile_store.ingest(msg["origin"], msg.get("buckets", []),
                                      msg.get("meta"))
        elif mtype == "list_profiles":
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": self.profile_store.stats()})
        elif mtype == "get_profile":
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": self.profile_store.query(
                                   msg.get("window_s", 300.0),
                                   origin=msg.get("origin"))})
        elif mtype == "profile_diff":
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": self.profile_store.diff(
                                   msg.get("window_a", 600.0),
                                   msg.get("window_b", 60.0),
                                   origin=msg.get("origin"))})
        elif mtype == "profile_ledger":
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": self._profile_ledger(
                                   msg.get("window_s", 300.0),
                                   tasks=msg.get("tasks"))})
        elif mtype == "list_metrics":
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": self.tsdb.list_metrics()})
        elif mtype == "query_metric":
            try:
                value = self.tsdb.query(
                    msg["name"], window_s=msg.get("window_s", 3600.0),
                    step_s=msg.get("step_s", 0.0), tags=msg.get("tags"),
                    agg=msg.get("agg"))
            except ValueError as e:
                value = {"__state_error__": str(e)}
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": value})
        elif mtype == "memory_audit":
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": self._memory_audit(
                                   limit=msg.get("limit", 200))})
        elif mtype == "top_snapshot":
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": self._top_snapshot()})
        elif mtype == "perf_summary":
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": self._perf_summary(
                                   window_s=msg.get("window_s", 1800.0))})
        elif mtype == "get_incident":
            wd = self.watchdog
            if wd is None:
                value = {"__state_error__": "watchdog disabled"}
            else:
                value = wd.incidents.get(msg["incident_id"]) or {
                    "__state_error__":
                        f"no incident {msg['incident_id']!r}"}
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": value})
        elif mtype == "ack_incident":
            wd = self.watchdog
            if wd is None:
                value = {"__state_error__": "watchdog disabled"}
            else:
                value = wd.ack(msg["incident_id"]) or {
                    "__state_error__":
                        f"no open incident {msg['incident_id']!r}"}
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": value})
        elif mtype == "debug_dump":
            wd = self.watchdog
            if wd is None:
                value = {"__state_error__": "watchdog disabled"}
            else:
                try:
                    value = {"path": wd.debug_dump(msg.get("label"))}
                except Exception as e:
                    value = {"__state_error__": str(e)}
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": value})
        elif mtype == "doctor_report":
            # head-side diagnosis: the same incremental path the watchdog
            # tick runs, against head-local tables — the client never
            # pulls the event/task rows over the wire
            try:
                value = self._doctor_report(
                    msg.get("trend_window_s", 1800.0))
            except Exception as e:
                value = {"__state_error__": str(e)}
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": value})
        elif mtype == "events_report":
            self.events.add(msg["origin"], msg["events"])
            self.traces.add(msg["origin"], msg["events"])
        elif mtype == "get_trace":
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": self._get_trace(msg["trace_id"])})
        elif mtype == "log_report":
            self._ingest_log_report(msg["origin"], msg.get("records") or [],
                                    msg.get("streams"))
        elif mtype == "get_log":
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": self._get_log(msg)})
        elif mtype == "tail_log":
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": self.log_store.tail_text(
                                   msg["stream"], msg.get("n", 100),
                                   bool(msg.get("errors")))})
        else:
            logger.warning("unknown message type %s", mtype)
        # write out any execute messages this message's handling queued
        # (dispatches happen under the node lock; pipe writes here, outside)
        self._flush_sends()

    # ------------------------------------------------------------------
    # workers
    # ------------------------------------------------------------------
    def _spawn_worker_process(
        self,
        ns: NodeState,
        worker_id: bytes,
        runtime_env: Optional[dict],
        extra_env: Optional[Dict[str, str]] = None,
    ) -> subprocess.Popen:
        """Env assembly + Popen shared by pooled and dedicated actor workers.

        User env_vars apply first so harness-critical vars always win (a
        runtime_env can never clobber the worker's ability to boot and
        register); a user PYTHONPATH is merged, not replaced.  Raises
        OSError when the process cannot spawn (e.g. working_dir vanished)."""
        env = dict(os.environ)
        env.update(ns.env)
        cwd = _apply_runtime_env(env, runtime_env)
        env["RAY_TPU_TORCH_ADDRESS"] = self.address
        env["RAY_TPU_TORCH_AUTHKEY"] = self.authkey.hex()
        env["RAY_TPU_TORCH_NODE_ID"] = ns.node_id
        env["RAY_TPU_TORCH_WORKER_ID"] = worker_id.hex()
        env["RAY_TPU_TORCH_SESSION_DIR"] = self.session_dir
        env["RAY_TPU_TORCH_WORKER_LOG"] = os.path.join(
            self.session_dir, "logs", f"worker-{worker_id.hex()}.log")
        if extra_env:
            env.update(extra_env)
        env["PYTHONPATH"] = _worker_pythonpath(env.get("PYTHONPATH", ""))
        # plain workers fork from the warm template (~20ms vs a ~2s cold
        # CPython boot); pip/conda runtime_envs need their env's
        # interpreter, so they (and any forkserver failure) take the
        # classic Popen path
        if self._forkserver is not None and not (
                (runtime_env or {}).get("pip")
                or (runtime_env or {}).get("conda")):
            proc = self._forkserver.spawn(env, cwd)
            if proc is not None:
                self._register_worker_log(worker_id, ns.node_id, proc)
                return proc
        proc = subprocess.Popen(_worker_argv(runtime_env), env=env, cwd=cwd)
        self._register_worker_log(worker_id, ns.node_id, proc)
        return proc

    def _register_worker_log(self, worker_id: bytes, node_id: str,
                             proc) -> None:
        """A locally spawned worker's capture file joins the head's tail
        set.  Remote workers are the agents' to tail — registration-based
        ownership is what keeps each line shipped exactly once when an
        emulated multi-node run shares one session dir."""
        if self._log_monitor is None:
            return
        self._log_monitor.register(
            f"worker-{worker_id.hex()}",
            os.path.join(self.session_dir, "logs",
                         f"worker-{worker_id.hex()}.log"),
            node=node_id, pid=getattr(proc, "pid", None))

    def _spawn_on_node(
        self,
        ns: NodeState,
        worker_id: bytes,
        runtime_env: Optional[dict],
        extra_env: Optional[Dict[str, str]] = None,
    ) -> Optional[subprocess.Popen]:
        """Spawn a worker locally or delegate to the node's agent.  Returns
        the Popen for local spawns, None for remote ones.  Raises OSError
        when the spawn cannot happen on either path."""
        if ns.agent_conn is not None:
            env, cwd = self._remote_env_overrides(worker_id, runtime_env, extra_env)
            ns.agent_send({"type": "spawn_worker", "worker_id": worker_id.hex(),
                           "env_overrides": env, "cwd": cwd,
                           "pip": (runtime_env or {}).get("pip"),
                           "conda": (runtime_env or {}).get("conda")})
            return None
        return self._spawn_worker_process(ns, worker_id, runtime_env, extra_env)

    def _remote_env_overrides(
        self, worker_id: bytes, runtime_env: Optional[dict],
        extra_env: Optional[Dict[str, str]] = None,
    ) -> Tuple[Dict[str, str], Optional[str]]:
        """Env overrides shipped to a node agent for a remote worker spawn.
        User env_vars first; harness vars after so they always win (the
        agent merges over its own os.environ and fixes node identity)."""
        env: Dict[str, str] = {}
        cwd = _apply_runtime_env(env, runtime_env)
        env["RAY_TPU_TORCH_ADDRESS"] = f"tcp://{self.tcp_address[0]}:{self.tcp_address[1]}"
        env["RAY_TPU_TORCH_AUTHKEY"] = self.authkey.hex()
        env["RAY_TPU_TORCH_WORKER_ID"] = worker_id.hex()
        env["RAY_TPU_TORCH_SESSION_DIR"] = self.session_dir
        # remote workers log under the AGENT host's session dir; the
        # head's viewer shows local streams (per-node log agents are the
        # reference's split too)
        env["RAY_TPU_TORCH_WORKER_LOG"] = os.path.join(
            self.session_dir, "logs", f"worker-{worker_id.hex()}.log")
        if extra_env:
            env.update(extra_env)
        return env, cwd

    def _spawn_worker(self, ns: NodeState, runtime_env: Optional[dict] = None) -> None:
        """Fork/exec a language worker (WorkerPool::StartWorkerProcess analog).

        With a runtime_env, the worker is spawned inside that environment
        (env_vars + working_dir) and only ever serves tasks declaring the
        identical env.  On a remote node the spawn is delegated to its
        agent (the worker still connects straight back to the head)."""
        worker_id = os.urandom(8)  # raylint: disable=R3 (per spawn, not per task)
        key = _runtime_env_key(runtime_env)
        try:
            proc = self._spawn_on_node(ns, worker_id, runtime_env)
        except (OSError, ValueError) as e:
            logger.warning("worker spawn failed for env %r: %s", key, e)
            if ns.agent_conn is None and key is not None:
                # trip the env's circuit breaker; plain (key=None) workers
                # keep retrying — a transient fork failure must not
                # permanently poison the default pool (agent-side spawn
                # failures come back as worker_exited messages instead)
                with self.lock:
                    ns.spawn_failures[key] = ns.spawn_failures.get(key, 0) + 3
            return
        h = WorkerHandle(worker_id=worker_id, node_id=ns.node_id, proc=proc,
                         runtime_env_key=key)
        self.workers[worker_id] = h
        ns.starting += 1
        ns.starting_by_key[key] = ns.starting_by_key.get(key, 0) + 1
        events_mod.emit("worker_pool", "worker spawning", severity="DEBUG",
                        entity_id=worker_id.hex(), node=ns.node_id,
                        runtime_env=bool(key))

    def _on_register_worker(self, conn: Connection, msg: dict) -> WorkerHandle:
        worker_id = bytes.fromhex(msg["worker_id"])
        with self.lock:
            h = self.workers.get(worker_id)
            if h is None:  # externally started worker (not via pool)
                h = WorkerHandle(worker_id=worker_id, node_id=msg["node_id"])
                self.workers[worker_id] = h
            h.conn = conn
            h.send_lock = self._conn_lock(conn)
            h.state = "idle"
            self._history_from[worker_id.hex()] = time.time() + self.WORKER_START_BOUND_S
            ns = self.nodes.get(h.node_id)
            if ns is not None:
                # Dedicated actor workers never join the general idle pool
                # and are not counted in the pool's spawn accounting.
                if not h.is_actor_worker:
                    ns.starting = max(0, ns.starting - 1)
                    k = h.runtime_env_key
                    ns.starting_by_key[k] = max(0, ns.starting_by_key.get(k, 0) - 1)
                    ns.spawn_failures.pop(k, None)  # a successful boot resets
                    h.idle_since = time.time()
                    ns.idle.append(h)
            self._wake_scheduler()
        events_mod.emit("worker_pool", "worker registered", severity="DEBUG",
                        entity_id=worker_id.hex(), node=h.node_id,
                        actor=h.is_actor_worker)
        return h

    def _on_worker_death(self, h: WorkerHandle, reason: str) -> None:
        from ray_tpu_torch.exceptions import RayActorError, WorkerCrashedError

        self._history_from.pop(h.worker_id.hex(), None)

        with self.lock:
            if h.state == "dead":
                return
            was_starting = h.state == "starting"
            h.state = "dead"
            ns = self.nodes.get(h.node_id)
            if ns and h in ns.idle:
                ns.idle.remove(h)
            if ns and was_starting and not h.is_actor_worker:
                # died before registering: release the in-flight spawn slot
                # and count the failure so a boot-looping runtime_env
                # surfaces an error instead of deferring forever (plain
                # workers retry indefinitely — see _spawn_worker)
                ns.starting = max(0, ns.starting - 1)
                k = h.runtime_env_key
                ns.starting_by_key[k] = max(0, ns.starting_by_key.get(k, 0) - 1)
                if k is not None:
                    ns.spawn_failures[k] = ns.spawn_failures.get(k, 0) + 1
            spec = h.current_task
            h.current_task = None
            pipelined = list(h.pipeline)
            h.pipeline.clear()
        if self._shutdown:
            return
        events_mod.emit(
            "worker_pool", f"worker died: {reason}",
            severity="WARNING" if (spec is not None or h.actor_id) else "INFO",
            entity_id=h.worker_id.hex(), node=h.node_id,
            running_task=(spec or {}).get("name"))
        self._retire_worker_log(h, reason, busy=spec is not None
                                or h.actor_id is not None)
        if h.actor_id is not None:
            self._on_actor_worker_death(h, reason)
        elif spec is not None or pipelined:
            if spec is not None:
                tid = spec["task_id"]
                with self.lock:
                    rt = self.running.pop(tid, None)
                if rt is not None:
                    self._release_task_resources(rt)
            if spec is not None:
                if spec.get("retries_left", 0) > 0:
                    spec["retries_left"] -= 1
                    logger.warning("task %s failed (%s); retrying", spec.get("name"), reason)
                    self.submit_task(spec, _resubmit=True)
                else:
                    err = WorkerCrashedError(
                        f"Worker died while running task {spec.get('name')}: {reason}"
                    )
                    self._seal_error_returns(spec, err)
            # pipelined specs never started executing (only the promoted
            # task runs): resubmit them WITHOUT spending a retry, the way
            # the reference requeues leased-but-unpushed tasks — otherwise
            # one worker kill burns up to pipeline_depth+1 retry budgets
            for s in pipelined:
                self.submit_task(s, _resubmit=True)
        with self.lock:
            self._wake_scheduler()
        self._flush_sends()  # resubmits may have queued execute messages

    def _on_blocked(self, h: Optional[WorkerHandle], blocked: bool) -> None:
        """Release a blocked worker's CPUs so dependents can run — the
        reference's NotifyDirectCallTaskBlocked/Unblocked path that prevents
        nested ray.get deadlock."""
        if h is None:
            return
        with self.lock:
            held = None
            node_id = None
            if h.is_actor_worker and h.actor_id in self.actors:
                held = self.actors[h.actor_id].held
                node_id = self.actors[h.actor_id].node_id
            elif h.current_task is not None:
                tid = h.current_task["task_id"]
                if tid in self.running:
                    held = self.running[tid]["held"]
                    node_id = self.running[tid]["node_id"]
            if held is None:
                return
            # depth-counted: only the 0->1 and 1->0 transitions move CPUs
            # (threaded actors may have several methods blocked at once)
            if blocked:
                h.block_depth += 1
                if h.block_depth != 1:
                    return
                if not h.is_actor_worker and h.pipeline:
                    # this task's get may be waiting on the OUTPUT of a
                    # task pipelined behind it in this worker's FIFO queue
                    # — a scheduling deadlock.  Ask the worker to hand its
                    # unstarted pipelined tasks back; _on_pipeline_returned
                    # requeues whatever it actually returns.
                    h.outbox.append({"type": "reclaim_pipeline"})
                    with self._outbox_lock:
                        self._outbox_pending.add(h)
                    events_mod.emit(
                        "scheduler", "pipeline reclaim requested",
                        severity="DEBUG", entity_id=h.worker_id.hex(),
                        queued=len(h.pipeline))
            else:
                if h.block_depth == 0:
                    return
                h.block_depth -= 1
                if h.block_depth != 0:
                    return
            cpus = {CPU: held.get(CPU, 0.0)}
            ns = self.nodes.get(node_id)
            if ns is None or cpus[CPU] == 0.0:
                return
            if blocked:
                _release(cpus, ns.available)
            else:
                _acquire(cpus, ns.available)
            self._wake_scheduler()

    # ------------------------------------------------------------------
    # objects
    # ------------------------------------------------------------------
    def seal_object(
        self, oid: bytes, loc: ObjectLocation, contained: List[bytes],
        sealer: Optional[WorkerHandle] = None,
        client: Optional[ClientState] = None,
    ) -> None:
        # annotate the location with its node + object-server address so
        # any consumer anywhere can attach-or-pull ("" = head node).
        # Workers on emulated (fake-cluster) nodes share the head's shm
        # namespace, so only real agent nodes count as remote — otherwise
        # their segments would silently escape capacity/spill accounting.
        if loc.shm_name:
            node_id = sealer.node_id if sealer else self._head_node_id
            with self.lock:
                ns = self.nodes.get(node_id)
            is_remote = ns is not None and ns.agent_conn is not None
            loc.node_id = node_id if is_remote else ""
            if is_remote:
                loc.fetch_addr = tuple(ns.fetch_addr) if ns.fetch_addr else None
            else:
                head = self.nodes.get(self._head_node_id)
                loc.fetch_addr = tuple(head.fetch_addr) if head and head.fetch_addr else None
        # ownership audit: attribute the payload to its producer — the
        # sealing actor/worker, or the driver for puts over a client
        # connection (`ray memory`'s owner column)
        if sealer is not None:
            if sealer.actor_id is not None:
                owner, owner_kind = sealer.actor_id.hex(), "actor"
            else:
                owner, owner_kind = sealer.worker_id.hex(), "worker"
        elif client is not None:
            # per-tenant attribution: the job id, not an anonymous
            # "driver" — `ray_tpu_torch memory` then rolls bytes up per tenant
            owner, owner_kind = client.job_id, "driver"
        else:
            owner, owner_kind = "driver", "driver"
        # contained refs are counted (and remembered for cascade-decrement
        # when this object dies) inside the registry
        self.registry.seal(oid, loc, contained, owner=owner,
                           owner_kind=owner_kind)
        self._notify_sealed(oid)
        with self.lock:
            # retry dep-blocked actor queues inline (the seal may be the
            # missing dependency); wake the scheduler only when something
            # it owns can actually make progress — a blanket notify here
            # was one scheduler pass per sealed object under load
            if self._dep_blocked_actors:
                for aid in list(self._dep_blocked_actors):
                    self._dep_blocked_actors.discard(aid)
                    art = self.actors.get(aid)
                    if art is not None:
                        with art.shard.lock:  # head lock -> shard lock
                            self._dispatch_actor_next_locked(art)
            if self.pending_tasks or self.pending_pgs:
                self._wake_scheduler()

    def _dynamic_state(self, tid: bytes):
        """(attempt, oids, done) snapshot for a dynamic task."""
        with self.lock:
            d = self._dynamic_yields.get(tid)
            attempt = d["attempt"] if d else 0
            oids = list(d["oids"]) if d else []
        with self.gcs.lock:
            ti = self.gcs.tasks.get(tid)
            done = ti is None or ti.state in ("FINISHED", "FAILED")
        return attempt, oids, done

    def _on_dynamic_yields_request(self, conn: Connection, msg: dict) -> None:
        """Long-poll for new dynamic yields: reply immediately when there
        is news (new oids past ``after``, a retry bumped the attempt, or
        the task ended); otherwise park until a yield/done wakes us (or the
        timeout sweep replies empty)."""
        tid = msg["task_id"]
        after = int(msg.get("after", 0))
        attempt, oids, done = self._dynamic_state(tid)
        if oids[after:] or done or attempt != int(msg.get("attempt", 0)):
            self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                               "value": {"oids": oids[after:], "done": done,
                                         "attempt": attempt}})
            return
        with self.lock:
            self._dynamic_waiters.setdefault(tid, []).append({
                "conn": conn, "req_id": msg["req_id"], "after": after,
                "attempt": int(msg.get("attempt", 0)),
                "deadline": time.monotonic() + 20.0,
            })

    def _wake_dynamic_waiters(self, tid: bytes, expire: bool = False) -> None:
        attempt, oids, done = self._dynamic_state(tid)
        with self.lock:
            waiters = self._dynamic_waiters.pop(tid, None)
            if not waiters:
                return
            keep = []
            fire = []
            now = time.monotonic()
            for wtr in waiters:
                if (oids[wtr["after"]:] or done or attempt != wtr["attempt"]
                        or (expire and now >= wtr["deadline"])):
                    fire.append(wtr)
                else:
                    keep.append(wtr)
            if keep:
                self._dynamic_waiters[tid] = keep
        for wtr in fire:
            self._reply(wtr["conn"], {
                "type": "reply", "req_id": wtr["req_id"],
                "value": {"oids": oids[wtr["after"]:], "done": done,
                          "attempt": attempt}})

    def _sweep_dynamic_waiters(self) -> None:
        """Expire parked long-polls (called from the timeout loop)."""
        with self.lock:
            tids = list(self._dynamic_waiters)
        for tid in tids:
            self._wake_dynamic_waiters(tid, expire=True)

    def _on_replica_added(self, worker: Optional[WorkerHandle], msg: dict) -> None:
        """A consumer finished pulling a copy onto its node — extend the
        object's location set (only real agent nodes count; emulated nodes
        share the head's shm namespace)."""
        if worker is None:
            return
        with self.lock:
            ns = self.nodes.get(worker.node_id)
            if ns is None or ns.agent_conn is None or ns.fetch_addr is None:
                return
            addr = tuple(ns.fetch_addr)
        self.registry.add_replica(msg["oid"], worker.node_id, addr)

    def _on_broadcast(self, conn: Connection, msg: dict) -> None:
        n_ok, err = self._broadcast_object(
            msg["oid"], timeout=msg.get("timeout", 120.0))
        self._reply(conn, {"type": "reply", "req_id": msg["req_id"],
                           "value": {"replicas": n_ok, "error": err}})

    def _broadcast_object(self, oid: bytes, timeout: float = 120.0):
        """Proactively replicate ``oid``'s payload to every alive agent node
        (PushManager analog, ``src/ray/object_manager/push_manager.h:29``)
        with doubling fan-out: each completed copy becomes a source for the
        next wave, so N nodes take O(log N) waves of the origin's bandwidth
        instead of N pulls from one server."""
        loc = self.registry.wait_sealed_existing(oid, min(30.0, timeout))
        if loc in (None, "missing"):
            return 0, f"object not available ({'unknown' if loc == 'missing' else 'timeout'})"
        if loc.inline is not None or not loc.shm_name or not loc.fetch_addr:
            return 0, None  # inline/spilled payloads ride messages instead
        existing = set(self.registry.replica_nodes(oid))
        with self.lock:
            targets = [
                ns for ns in self.nodes.values()
                if ns.alive and ns.agent_conn is not None and ns.fetch_addr
                and ns.node_id != loc.node_id and ns.node_id not in existing
            ]
        origin_arena = (loc.arena_path, loc.arena_off) if loc.arena_path else None
        sources = [(tuple(loc.fetch_addr), origin_arena)]
        n_ok, err = 0, None
        pending = list(targets)
        deadline = time.monotonic() + timeout  # ONE budget across all waves
        while pending:
            wave, pending = pending[:len(sources)], pending[len(sources):]
            acks = []
            for i, ns in enumerate(wave):
                addr, arena = sources[i % len(sources)]
                token = os.urandom(8).hex()  # raylint: disable=R3 (per pull)
                holder = {"event": threading.Event(), "ok": False, "error": None}
                self._pull_acks[token] = holder
                try:
                    ns.agent_send({
                        "type": "pull_object", "name": loc.shm_name,
                        "size": loc.size, "addr": addr, "arena": arena,
                        "token": token,
                    })
                except (OSError, ValueError):
                    self._pull_acks.pop(token, None)
                    err = f"send to {ns.node_id} failed"
                    continue
                acks.append((ns, token, holder))
            for ns, token, holder in acks:
                remaining = deadline - time.monotonic()
                if remaining > 0 and holder["event"].wait(remaining) and holder["ok"]:
                    self.registry.add_replica(oid, ns.node_id, ns.fetch_addr)
                    sources.append((tuple(ns.fetch_addr), None))
                    n_ok += 1
                else:
                    self._pull_acks.pop(token, None)
                    err = holder["error"] or "broadcast timed out"
            if time.monotonic() >= deadline:
                if pending:
                    err = err or "broadcast timed out"
                break
        return n_ok, err

    def _release_spec_pins(self, spec: dict) -> None:
        """Release a task spec's argument pins (idempotent — pops the
        lists).  The pins were counted by the submitting client at
        spec-build time (while its arg handles were provably alive, so the
        increment can't race a finalizer's decrement); ``owned_oids`` are
        spec-private objects (the big-args payload) whose initial refcount
        belongs to the spec itself."""
        pinned = spec.pop("pinned_refs", None)
        if pinned:
            self.registry.remove_refs(pinned, reason="task_arg")
        owned = spec.pop("owned_oids", None)
        if owned:
            self.registry.remove_refs(owned, reason="handle")

    def _register_pending_get(self, pg: _PendingGet) -> None:
        replies = []
        with self.lock:
            pg.unsealed = {
                oid for oid in pg.oids if not self.registry.is_sealed(oid)
            }
            reply = self._try_complete(pg, time.monotonic())
            if reply is not None:
                pg.done = True
                replies.append((pg, reply))
            else:
                self.pending_gets.append(pg)
                for oid in pg.unsealed:
                    lst = self._get_waiters.get(oid)
                    if lst is None:
                        self._get_waiters[oid] = [pg]
                    else:
                        # compact completed waiters on touch — without this
                        # a poll loop on a never-sealing oid grows the list
                        # one dead entry per poll, forever
                        lst[:] = [p for p in lst if not p.done]
                        lst.append(pg)
        for pg, reply in replies:
            pg.conn_send(reply)

    def _on_get_request(self, conn: Connection, msg: dict, worker: Optional[WorkerHandle]) -> None:
        oids = msg["oids"]
        timeout = msg.get("timeout")
        deadline = time.monotonic() + timeout if timeout is not None else None
        self._register_pending_get(_PendingGet(
            req_id=msg["req_id"],
            conn_send=lambda m: self._reply(conn, m),
            oids=oids,
            deadline=deadline,
            node_id=self._agent_node_or_head(worker.node_id) if worker else "",
        ))

    def _on_wait_request(self, conn: Connection, msg: dict, worker: Optional[WorkerHandle]) -> None:
        timeout = msg.get("timeout")
        deadline = time.monotonic() + timeout if timeout is not None else None
        self._register_pending_get(_PendingGet(
            req_id=msg["req_id"],
            conn_send=lambda m: self._reply(conn, m),
            oids=msg["oids"],
            deadline=deadline,
            kind="wait",
            num_returns=msg["num_returns"],
            node_id=self._agent_node_or_head(worker.node_id) if worker else "",
        ))

    def _try_complete(self, pg: _PendingGet, now: float) -> Optional[dict]:
        """Completion/expiry check for one waiter using its cached unsealed
        set (lock held).  Returns the reply, or None to keep waiting."""
        expired = pg.deadline is not None and now >= pg.deadline
        if pg.kind == "get":
            if not pg.unsealed:
                locs = {oid: self.registry.get_location(oid, prefer_node=pg.node_id)
                        for oid in pg.oids}
                if any(v is None for v in locs.values()):
                    # an oid un-sealed again (node loss between seal and
                    # completion): recompute and keep waiting
                    pg.unsealed = {
                        oid for oid in pg.oids if not self.registry.is_sealed(oid)
                    }
                    for oid in pg.unsealed:
                        self._get_waiters.setdefault(oid, []).append(pg)
                    if pg.unsealed:
                        if expired:
                            return {"type": "reply", "req_id": pg.req_id,
                                    "timeout": True}
                        return None
                    locs = {oid: self.registry.get_location(oid, prefer_node=pg.node_id)
                            for oid in pg.oids}
                return {"type": "reply", "req_id": pg.req_id, "locations": locs}
            if expired:
                return {"type": "reply", "req_id": pg.req_id, "timeout": True}
            return None
        # wait — the cached set can overstate sealing (node loss un-seals),
        # so completion is always confirmed against the registry
        n_sealed = len(pg.oids) - len(pg.unsealed)
        if n_sealed >= pg.num_returns or expired:
            sealed = [oid for oid in pg.oids if self.registry.is_sealed(oid)]
            if len(sealed) < pg.num_returns and not expired:
                pg.unsealed = {
                    oid for oid in pg.oids if not self.registry.is_sealed(oid)
                }
                for oid in pg.unsealed:
                    self._get_waiters.setdefault(oid, []).append(pg)
                return None
            locs = {oid: self.registry.get_location(oid, prefer_node=pg.node_id)
                    for oid in sealed}
            return {"type": "reply", "req_id": pg.req_id,
                    "ready": sealed, "locations": locs}
        return None

    def _notify_sealed(self, oid: bytes) -> None:
        """A seal wakes only the waiters parked on that oid."""
        now = time.monotonic()
        replies: List[Tuple[_PendingGet, dict]] = []
        with self.lock:
            waiters = self._get_waiters.pop(oid, None)
            if not waiters:
                return
            for pg in waiters:
                if pg.done:
                    continue
                pg.unsealed.discard(oid)
                reply = self._try_complete(pg, now)
                if reply is not None:
                    pg.done = True
                    replies.append((pg, reply))
        for pg, reply in replies:
            pg.conn_send(reply)

    def _service_pending_gets(self, now: Optional[float] = None) -> None:
        """Periodic sweep: deadline expiry + pruning of completed waiters
        (seal-driven wakeups go through _notify_sealed)."""
        now = now or time.monotonic()
        done: List[Tuple[_PendingGet, dict]] = []
        with self.lock:
            remaining = []
            for pg in self.pending_gets:
                if pg.done:
                    continue  # prune: replied via _notify_sealed
                reply = self._try_complete(pg, now)
                if reply is not None:
                    pg.done = True
                    done.append((pg, reply))
                else:
                    remaining.append(pg)
            self.pending_gets = remaining
        for pg, reply in done:
            pg.conn_send(reply)

    def _timeout_loop(self) -> None:
        while not self._shutdown:
            time.sleep(0.05)
            self._service_pending_gets()
            self._sweep_dynamic_waiters()

    def _reaper_loop(self) -> None:
        """Collect exited forkserver workers and any zombie reparented to
        us (subreaper / pid-1 container): a Z-state child that no live
        Popen object owns gets waitpid'ed here, nowhere else."""
        while not self._shutdown:
            time.sleep(2.0)
            try:
                with self.lock:
                    forked = [w.proc for w in self.workers.values()
                              if isinstance(w.proc, _ForkedProc)]
                    popen_pids = {w.proc.pid for w in self.workers.values()
                                  if isinstance(w.proc, subprocess.Popen)}
                if self._forkserver is not None and self._forkserver.pid:
                    popen_pids.add(self._forkserver.pid)
                for p in forked:
                    p.poll()  # reaps on exit; handle keeps the status
                    popen_pids.add(p.pid)  # sweep must not steal statuses
                self._reap_unknown_zombies(popen_pids)
            except Exception:
                pass

    def _reap_unknown_zombies(self, popen_pids: set) -> None:
        """Reap ORPHANED zombies only: a zombie owned by a live Popen
        (job drivers, node agents, user subprocesses) is collected by its
        owner within moments of exit — so anything still Z-state across
        two sweeps ~30s apart has no owner (a worker's abandoned child
        reparented to us), and waitpid'ing it cannot steal an exit status
        another subsystem is waiting on."""
        try:
            tids = os.listdir("/proc/self/task")
        except OSError:
            return
        children: set = set()
        for tid in tids:
            try:
                with open(f"/proc/self/task/{tid}/children") as f:
                    children.update(int(p) for p in f.read().split())
            except (OSError, ValueError):
                continue
        now = time.monotonic()
        seen = self._zombie_seen
        zombies: set = set()
        for pid in children - popen_pids:
            try:
                with open(f"/proc/{pid}/stat") as f:
                    if f.read().split(")")[-1].split()[0] != "Z":
                        continue  # alive (a _ForkedProc worker, fine)
            except (OSError, IndexError):
                continue
            zombies.add(pid)
            first = seen.setdefault(pid, now)
            if now - first < 30.0:
                continue  # young zombie: its owner may still collect it
            try:
                os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                pass
            seen.pop(pid, None)
        # forget pids that got collected (or whose pid was recycled)
        for pid in list(seen):
            if pid not in zombies:
                seen.pop(pid, None)

    def _gcs_flush_loop(self) -> None:
        """Periodic persistence on its own thread (never in the path of
        pending-get servicing); prunes old terminal task records so the
        flush (and the table) stays bounded on long-lived heads."""
        while not self._shutdown:
            time.sleep(2.0)
            self._prune_task_history()
            self._dump_head_events()
            if self.gcs_store is None:
                continue
            with self._gcs_flush_lock:
                if self._shutdown:
                    break  # shutdown flushes last, then closes the store
                try:
                    self.gcs.flush(self.gcs_store)
                except Exception:
                    logger.warning("gcs flush failed:\n%s", traceback.format_exc())

    def _dump_head_events(self) -> None:
        """Append the head's new events to its crash-dump trail — a
        SIGKILL'd head still leaves its last-flushed events on disk.
        Incremental (O(new events) per cycle): rewriting the whole ring
        held the GIL long enough to cost ~4% of task throughput."""
        if not events_mod.ENABLED:
            return
        rows = events_mod.buffer().since(self._events_dumped_seq)
        if not rows:
            return
        path = os.path.join(self.session_dir, "logs", "events-head.jsonl")
        if events_mod.append_dump(path, rows):
            self._events_dumped_seq = rows[-1]["seq"]

    _MAX_TASK_HISTORY = 10_000

    def _prune_task_history(self) -> None:
        with self.gcs.lock:
            if len(self.gcs.tasks) <= self._MAX_TASK_HISTORY:
                return
            terminal = [
                (ti.end_time or 0.0, tid)
                for tid, ti in self.gcs.tasks.items()
                if ti.state in ("FINISHED", "FAILED")
            ]
            excess = len(self.gcs.tasks) - self._MAX_TASK_HISTORY
            terminal.sort()
            pruned = [tid for _, tid in terminal[:excess]]
            for tid in pruned:
                del self.gcs.tasks[tid]
        with self.lock:
            for tid in pruned:
                self._dynamic_yields.pop(tid, None)

    # ------------------------------------------------------------------
    # tasks
    # ------------------------------------------------------------------
    def submit_task(self, spec: dict, _resubmit: bool = False) -> None:
        with self.lock:
            if _resubmit and spec.get("dynamic_returns"):
                # a retried generator re-yields from the start: new attempt,
                # fresh yield list (consumers detect the bump and error out
                # mid-stream rather than receive duplicates)
                d = self._dynamic_yields.setdefault(
                    spec["task_id"], {"attempt": 0, "oids": []})
                d["attempt"] += 1
                d["oids"] = []
            if not _resubmit:
                # under gcs.lock too: flush/snapshot/prune iterate this
                # dict under gcs.lock alone, and an insert racing those
                # iterations is a "dictionary changed size" crash in the
                # gcs-flush thread (seen under a 1k-client serve soak)
                with self.gcs.lock:
                    self.gcs.tasks[spec["task_id"]] = TaskInfo(
                        task_id=spec["task_id"], name=spec.get("name", "task"),
                        trace_ctx=spec.get("trace_ctx"),
                        job_id=spec.get("job_id"),
                    )
                track = (
                    not spec.get("actor_id")
                    and len(self.lineage) < self.cfg.max_lineage_entries
                )
                if track:
                    tid = spec["task_id"]
                    deps = list(dict.fromkeys(spec.get("dep_ids", [])))
                    if deps:
                        self.registry.add_refs(deps, reason="lineage")
                    self._lineage_pins[tid] = deps
                    self._lineage_refcnt[tid] = len(spec["return_ids"])
                self.registry.create_pending_batch(spec["return_ids"])
                # idempotent tasks are the reconstructable kind (actor
                # methods mutate state and are excluded, as in the
                # reference's lineage rules)
                if track:
                    for oid in spec["return_ids"]:
                        self.lineage[oid] = spec
            self.pending_tasks.append(spec)
            # inline dispatch on the submitting thread (idle worker or a
            # same-shape lease) skips the scheduler hop for the hot path;
            # anything it can't place falls back to a scheduler pass
            if not self._try_inline_dispatch():
                self._wake_scheduler()

    def _try_inline_dispatch(self) -> bool:
        """Dispatch the pending-queue head inline if a worker can take it
        now (lock held).  Returns True when the head moved — plain
        strategy-free CPU specs only, FIFO order preserved because only
        the head is ever considered."""
        spec = self.pending_tasks[0] if self.pending_tasks else None
        if spec is None:
            return True
        req = spec.get("resources", {})
        if (
            spec.get("scheduling_strategy") is not None
            or req.get(GPU, 0)
            or not self._deps_ready(spec)
        ):
            return False
        key = _runtime_env_key(spec.get("runtime_env"))
        for ns in self.nodes.values():
            if not ns.alive:
                continue
            w = next((c for c in ns.idle if c.runtime_env_key == key), None)
            if w is not None and _fits(req, ns.available):
                self.pending_tasks.popleft()
                _acquire(req, ns.available)
                ns.idle.remove(w)
                self._dispatch(ns, w, spec, [], None)
                self._pipeline_topup(ns, w)
                return True
        # no idle worker: try riding an existing same-shape lease
        for w2 in self.workers.values():
            if (
                w2.state == "busy"
                and not w2.is_actor_worker
                and w2.current_task is not None
                and len(w2.pipeline) < self.cfg.task_pipeline_depth
            ):
                ns2 = self.nodes.get(w2.node_id)
                if ns2 is None or not ns2.alive:
                    continue
                before = len(self.pending_tasks)
                self._pipeline_topup(ns2, w2)
                if len(self.pending_tasks) < before:
                    return True
        return False

    def _on_pipeline_returned(self, w: Optional[WorkerHandle],
                              msg: dict) -> None:
        """A blocked worker handed back its unstarted pipelined tasks (see
        the reclaim in _on_blocked).  Requeue exactly the specs the worker
        reports — anything its main loop had already claimed runs there and
        is absent from the report, so nothing double-executes.  Pipelined
        specs never acquired resources (they swap at promotion), so the
        requeue is accounting-neutral."""
        if w is None:
            return
        ids = set(msg.get("task_ids", []))
        if not ids:
            return
        with self.lock:
            reclaimed = [s for s in w.pipeline if s["task_id"] in ids]
            w.pipeline = deque(
                s for s in w.pipeline if s["task_id"] not in ids)
            # a spec PROMOTED to current_task between the reclaim send and
            # this reply was already drained from the worker's local queue
            # and will never run there: undo the promotion bookkeeping and
            # requeue it ahead of the rest (it was FIFO-earlier)
            cur = w.current_task
            if (cur is not None and not w.is_actor_worker
                    and cur["task_id"] in ids
                    and cur["task_id"] in self.running):
                rt = self.running.pop(cur["task_id"])
                self._release_task_resources_locked(rt)
                reclaimed.insert(0, cur)
                w.current_task = None
                w.state = "idle"
                ns = self.nodes.get(w.node_id)
                if ns is not None and ns.alive:
                    w.idle_since = time.time()
                    ns.idle.append(w)
            if not reclaimed:
                return
            events_mod.emit(
                "scheduler", "pipeline reclaimed", severity="DEBUG",
                entity_id=w.worker_id.hex(), n_tasks=len(reclaimed))
            # front of the queue, original order: these were FIFO-earlier
            # than anything still pending
            for s in reversed(reclaimed):
                self.pending_tasks.appendleft(s)
                ti = self.gcs.tasks.get(s["task_id"])
                if ti:
                    ti.state = "PENDING"
                    ti.node_id = None
            self._wake_scheduler()  # cond wraps self.lock: notify under it

    def _on_object_deleted(self, oid: bytes) -> None:
        """Registry delete hook: drop the object's lineage entry and, when
        the creating task has no live lineage entries left, release the
        argument pins lineage was holding (cascades dep cleanup)."""
        with self.lock:  # hook runs on whichever thread dropped the last ref
            spec = self.lineage.pop(oid, None)
            if spec is None:
                return
            tid = spec["task_id"]
            left = self._lineage_refcnt.get(tid, 1) - 1
            if left > 0:
                self._lineage_refcnt[tid] = left
                return
            self._lineage_refcnt.pop(tid, None)
            pins = self._lineage_pins.pop(tid, [])
        for d in pins:  # registry calls outside the node lock
            self.registry.remove_ref(d, reason="lineage")

    def _seal_error_returns(self, spec: dict, err: Exception) -> None:
        from ray_tpu_torch._private.object_store import store_value
        from ray_tpu_torch._private.object_ref import ObjectRef

        self._release_spec_pins(spec)
        for oid in spec["return_ids"]:
            loc, _ = store_value(ObjectRef(oid), err, is_error=True)
            self.registry.seal(oid, loc)
            self._notify_sealed(oid)
        self.publish("error", {"task": spec.get("name"),
                               "task_id": spec["task_id"].hex(),
                               "error": str(err)})
        with self.lock:
            ti = self.gcs.tasks.get(spec["task_id"])
            if ti:
                ti.state = "FAILED"
                ti.end_time = time.time()
            wake_dynamic = (spec["task_id"] in self._dynamic_yields
                            or spec["task_id"] in self._dynamic_waiters)
        if wake_dynamic:
            self._wake_dynamic_waiters(spec["task_id"])

    def _deps_ready(self, spec: dict) -> bool:
        return all(self.registry.is_sealed(d) for d in spec.get("dep_ids", []))

    def _dep_locations(self, spec: dict, node_id: str = "") -> Dict[bytes, ObjectLocation]:
        deps = spec.get("dep_ids", [])
        if not deps:
            return {}
        return self.registry.get_locations_batch(deps, prefer_node=node_id)

    def _select_node(self, spec: dict) -> Optional[Tuple[NodeState, Optional[BundleRuntime]]]:
        """Hybrid pack/spread node selection (HybridSchedulingPolicy analog)."""
        req = spec.get("resources", {})
        strategy = spec.get("scheduling_strategy")
        if isinstance(strategy, dict) and strategy.get("kind") == "placement_group":
            pgrt = self.pgs.get(strategy["pg_id"])
            if pgrt is None or pgrt.info.state != "CREATED":
                return None
            idx = strategy.get("bundle_index", -1)
            if idx >= len(pgrt.bundles):
                raise ValueError(
                    f"placement group bundle index {idx} out of range "
                    f"({len(pgrt.bundles)} bundles)"
                )
            candidates = pgrt.bundles if idx < 0 else [pgrt.bundles[idx]]
            for b in candidates:
                ns = self.nodes.get(b.node_id)
                if (ns and ns.alive and _fits(req, b.available)
                        and _gpu_fits(ns, req.get(GPU, 0))):
                    return ns, b
            return None
        if isinstance(strategy, dict) and strategy.get("kind") == "node_affinity":
            ns = self.nodes.get(strategy["node_id"])
            if (ns and ns.alive and _fits(req, ns.available)
                    and _gpu_fits(ns, req.get(GPU, 0))):
                return ns, None
            if strategy.get("soft"):
                pass  # fall through to default policy
            else:
                return None
        alive = [n for n in self.nodes.values() if n.alive and _fits(req, n.total)]
        avail = [n for n in alive if _fits(req, n.available)
                 and _gpu_fits(n, req.get(GPU, 0))]
        if not avail:
            return None
        thr = self.cfg.scheduler_spread_threshold
        below = [n for n in avail if n.utilization() < thr]
        if below:
            # pack: most utilized node under the threshold
            best = max(below, key=lambda n: (n.utilization(), n.node_id == self._head_node_id))
        else:
            best = min(avail, key=lambda n: n.utilization())
        return best, None

    def _wake_scheduler(self) -> None:
        """Mark scheduler work and wake the loop (lock must be held).  The
        loop clears the flag before each pass, so skipping the notify while
        it is still set can never lose a wake — it just coalesces them."""
        if not self._sched_work:
            self._sched_work = True
            self.cond.notify_all()

    def _scheduler_loop(self) -> None:
        last_sweep = 0.0
        while not self._shutdown:
            with self.lock:
                if not self._sched_work:
                    self.cond.wait(timeout=0.2)
                self._sched_work = False
            try:
                now = time.time()
                # sweeping polls every worker proc (a syscall each) — rate
                # limit it so a wake storm doesn't turn into a poll storm
                if now - last_sweep >= 0.2:
                    last_sweep = now
                    self._sweep_workers()
                self._schedule_once()
                # also the safety net for any queue site missing a flush:
                # the loop runs at least every 0.2s
                self._flush_sends()
            except Exception:
                logger.error("scheduler error:\n%s", traceback.format_exc())

    def _sweep_workers(self) -> None:
        """Detect pre-registration deaths and reap stale env-keyed idle
        workers.

        A worker that crashes before connecting has no connection whose
        close would report it (the reference's WorkerPool learns this from
        the process monitor); poll those procs here.  Env-keyed idle
        workers only serve their exact runtime_env, so past the idle
        threshold they are killed to return their pool slot."""
        dead, reap = [], []
        now = time.time()
        with self.lock:
            for w in self.workers.values():
                if w.state == "starting" and w.proc is not None and w.proc.poll() is not None:
                    dead.append(w)
            thr = self.cfg.idle_worker_killing_time_threshold_s
            for ns in self.nodes.values():
                for w in list(ns.idle):
                    if w.runtime_env_key is not None and now - w.idle_since > thr:
                        reap.append(w)
        for w in dead:
            self._on_worker_death(
                w, reason=f"exited with code {w.proc.returncode} before registering"
            )
        for w in reap:
            self._kill_worker(w, reason="idle runtime_env worker reaped")
        self._health_check(now)

    def _health_check(self, now: float) -> None:
        """Active agent liveness probing (GcsHealthCheckManager analog,
        ``gcs_health_check_manager.h:39``): a hung agent whose TCP
        connection stays open is detected by missed pongs, not only by a
        connection close."""
        period = self.cfg.health_check_period_s
        timeout = self.cfg.health_check_timeout_s
        ping_nodes, dead_nodes = [], []
        with self.lock:
            for ns in self.nodes.values():
                if not ns.alive or ns.agent_conn is None:
                    continue
                if now - ns.last_heartbeat > timeout:
                    dead_nodes.append(ns.node_id)
                elif now - ns.last_ping >= period:
                    ns.last_ping = now
                    ping_nodes.append(ns)
        for ns in ping_nodes:
            try:
                ns.agent_send({"type": "ping", "ts": now})
            except (OSError, ValueError):
                pass  # conn-close path will reap it
        for node_id in dead_nodes:
            logger.warning("node %s failed health check (%.0fs without a pong)",
                           node_id, timeout)
            self.remove_node_state(node_id)

    # ------------------------------------------------------------------
    # memory monitor + worker killing policy (MemoryMonitor
    # memory_monitor.h:52 -> WorkerKillingPolicy worker_killing_policy.h:30)
    # ------------------------------------------------------------------
    @staticmethod
    def _memory_fraction() -> float:
        """Host memory in use as a fraction (MemAvailable-based, the same
        signal the reference's MemoryMonitor reads from /proc)."""
        try:
            total = avail = None
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemTotal:"):
                        total = float(line.split()[1])
                    elif line.startswith("MemAvailable:"):
                        avail = float(line.split()[1])
                    if total is not None and avail is not None:
                        break
            if not total or avail is None:
                # no MemAvailable (old kernels/containers): report no
                # pressure rather than fabricating 100% and killing workers
                return 0.0
            return 1.0 - avail / total
        except OSError:
            return 0.0

    def _pick_oom_victim(self) -> Optional[WorkerHandle]:
        """Newest retriable task first, then newest non-retriable — killing
        young retriable work preserves the most progress (the reference's
        group-by-retriable LIFO policy)."""
        with self.lock:
            cands = []
            for tid, rt in self.running.items():
                w = rt.get("worker")
                if w is None or w.state == "dead" or w.is_actor_worker:
                    continue
                ti = self.gcs.tasks.get(tid)
                started = ti.start_time if ti else 0.0
                retriable = rt["spec"].get("retries_left", 0) > 0
                cands.append((retriable, started, w))
            if not cands:
                return None
            # sort: retriable group first, newest (max start) first in group
            cands.sort(key=lambda c: (not c[0], -c[1]))
            return cands[0][2]

    def _check_memory_pressure(self) -> bool:
        frac = self._memory_fraction()
        if frac < self.cfg.memory_usage_threshold:
            return False
        victim = self._pick_oom_victim()
        if victim is None:
            return False
        logger.warning(
            "memory pressure %.1f%% >= %.1f%%: killing worker %s (task %s) "
            "to free memory",
            frac * 100, self.cfg.memory_usage_threshold * 100,
            victim.worker_id.hex(),
            victim.current_task.get("name") if victim.current_task else "?",
        )
        self.publish("error", {
            "type": "oom_kill",
            "worker_id": victim.worker_id.hex(),
            "memory_fraction": frac,
        })
        events_mod.emit(
            "scheduler", "OOM kill", severity="WARNING",
            entity_id=victim.worker_id.hex(),
            memory_fraction=round(frac, 3),
            task=(victim.current_task or {}).get("name"))
        self._kill_worker(victim, reason=f"OOM killer (host memory {frac:.0%})")
        return True

    def _memory_monitor_loop(self) -> None:
        interval = self.cfg.memory_monitor_refresh_ms / 1000.0
        while not self._shutdown:
            time.sleep(interval)
            try:
                self._check_memory_pressure()
            except Exception:  # noqa: BLE001 — monitor must never die
                logger.exception("memory monitor check failed")

    def _kill_worker(self, w: WorkerHandle, reason: str) -> None:
        self._on_worker_death(w, reason=reason)
        try:
            if w.proc is not None:
                w.proc.kill()
            else:
                with self.lock:
                    ns = self.nodes.get(w.node_id)
                if ns is not None and ns.agent_conn is not None:
                    ns.agent_send({"type": "kill_worker",
                                   "worker_id": w.worker_id.hex()})
        except Exception:
            pass

    def publish(self, channel: str, data) -> None:
        """Queue a message for fan-out to ``channel`` subscribers (the
        Publisher half of src/ray/pubsub/).  Enqueue-only: core threads
        (scheduler, client-serving) must never block on a slow
        subscriber's pipe.  Messages drop when the publisher falls 1000
        behind (pubsub is best-effort, like the reference's long-poll)."""
        if self._pub_queue.qsize() > 1000:
            return
        self._pub_queue.put((channel, data))

    def _publisher_loop(self) -> None:
        while not self._shutdown:
            item = self._pub_queue.get()
            if item is None:
                return
            channel, data = item
            with self.lock:
                subs = list(self.subscribers.get(channel, []))
            dead = []
            for conn in subs:
                lock = self._conn_lock(conn)
                try:
                    with lock:
                        conn.send({"type": "pubsub", "channel": channel, "data": data})
                except (OSError, ValueError):
                    dead.append(conn)
            if dead:
                with self.lock:
                    cur = self.subscribers.get(channel, [])
                    for conn in dead:
                        if conn in cur:
                            cur.remove(conn)

    def _broadcast_unlink(self, shm_name: str) -> None:
        """Registry callback: a deleted object's segment (origin or pulled
        replica) may live on any node — tell every agent to unlink."""
        with self.lock:
            agents = [ns for ns in self.nodes.values()
                      if ns.alive and ns.agent_conn is not None]
        for ns in agents:
            try:
                ns.agent_send({"type": "unlink", "name": shm_name})
            except (OSError, ValueError):
                pass

    def _schedule_once(self) -> None:
        if events_mod.ENABLED:
            with self.lock:  # _starved is mutated under it; bare
                # iteration races a concurrent del (dict-changed-size)
                depth = (len(self.pending_tasks)
                         + sum(len(q) for q in self._starved.values()))
            _sched_metrics()["queue_depth"].set(depth)
        self._schedule_pgs()
        self._schedule_actor_creations_and_tasks()
        # phase 1: move pending tasks to a node's ready queue (resources held)
        with self.lock:
            still_pending = deque()
            failed_specs = []

            def stage(spec, sel) -> None:
                ns, bundle = sel
                req = spec.get("resources", {})
                pool = bundle.available if bundle is not None else ns.available
                _acquire(req, pool)
                gpu_ids: List[int] = []
                if req.get(GPU, 0) > 0:
                    gpu_ids = _take_gpus(ns, req[GPU])
                with ns.shard.lock:  # runnable queues live in shard space
                    ns.ready_queue.append((spec, gpu_ids, bundle))

            # starved shapes first (FIFO-older than any new arrival):
            # each shape costs ONE placement probe when still starved —
            # a 1M-task backlog is never walked, only its shape heads
            for shape in list(self._starved):
                q = self._starved[shape]
                while q:
                    spec = q[0]
                    if not self._deps_ready(spec):
                        # deps un-sealed after entry (node loss): send it
                        # back through the arrival queue's dep re-checks
                        q.popleft()
                        still_pending.append(spec)
                        continue
                    try:
                        sel = self._select_node(spec)
                    except Exception as e:
                        q.popleft()
                        failed_specs.append((spec, e))
                        continue
                    if sel is None:
                        break  # shape still starved; q keeps FIFO order
                    q.popleft()
                    stage(spec, sel)
                if not q:
                    del self._starved[shape]
            # then new arrivals; a shape that fails to place (or already
            # has a starved queue — FIFO within the shape) parks there
            stuck_shapes = set()
            while self.pending_tasks:
                spec = self.pending_tasks.popleft()
                if not self._deps_ready(spec):
                    still_pending.append(spec)
                    continue
                shape = _placement_shape(spec)
                if shape in stuck_shapes or shape in self._starved:
                    self._starved.setdefault(shape, deque()).append(spec)
                    continue
                try:
                    sel = self._select_node(spec)
                except Exception as e:
                    # A bad scheduling strategy (e.g. bundle index out of
                    # range) fails only this task — the error is sealed into
                    # its returns so the caller sees it on get().
                    failed_specs.append((spec, e))
                    continue
                if sel is None:
                    stuck_shapes.add(shape)
                    self._starved.setdefault(shape, deque()).append(spec)
                    continue
                stage(spec, sel)
            self.pending_tasks = still_pending
        for spec, e in failed_specs:
            self._seal_error_returns(spec, e)
        env_failed: List[Tuple[dict, Optional[str]]] = []
        with self.lock:
            # phase 2: dispatch ready tasks to idle workers whose runtime_env
            # matches; spawn env-keyed workers for the rest
            for ns in self.nodes.values():
                if not ns.alive:
                    continue
                deferred = []
                with ns.shard.lock:  # node's runnable queue: shard-owned
                    staged = list(ns.ready_queue)
                    ns.ready_queue.clear()
                for spec, gpu_ids, bundle in staged:
                    key = _runtime_env_key(spec.get("runtime_env"))
                    w = next((c for c in ns.idle if c.runtime_env_key == key), None)
                    if w is None:
                        deferred.append((spec, gpu_ids, bundle, key))
                        continue
                    ns.idle.remove(w)
                    self._dispatch(ns, w, spec, gpu_ids, bundle)
                    if bundle is None and not gpu_ids:
                        self._pipeline_topup(ns, w)
                if deferred:
                    # Pool size is resource-feasible, not a fixed headroom:
                    # workers beyond the CPU count can never dispatch (the
                    # resource gate holds them) but their spawns starve a
                    # small host.  Blocked workers released their CPUs, so
                    # each one justifies a replacement (nested-get progress).
                    # count REGISTERED workers only — in-flight boots are
                    # already in ns.starting, and counting them twice makes
                    # each one eat two cap slots (stalling env spawns for
                    # the whole prestart boot window)
                    n_workers = 0
                    blocked = 0
                    for w in self.workers.values():
                        if (w.node_id == ns.node_id
                                and w.state not in ("dead", "starting")
                                and not w.is_actor_worker):
                            n_workers += 1
                            if w.block_depth > 0:
                                blocked += 1
                    cap = int(ns.total.get(CPU, 1)) + blocked
                    # Spawn only what the queues need; python startup is
                    # expensive, so never boot more than 2 at a time per env.
                    need_by_key: Dict[Optional[str], int] = {}
                    env_by_key: Dict[Optional[str], Optional[dict]] = {}
                    for spec, _, _, key in deferred:
                        need_by_key[key] = need_by_key.get(key, 0) + 1
                        env_by_key.setdefault(key, spec.get("runtime_env"))
                    for key, need in need_by_key.items():
                        if ns.spawn_failures.get(key, 0) >= 3:
                            continue  # boot-looping env; failed below
                        starting = ns.starting_by_key.get(key, 0)
                        while (
                            need > starting
                            and starting < self.cfg.maximum_startup_concurrency
                            and n_workers + ns.starting < max(1, cap)
                        ):
                            self._spawn_worker(ns, runtime_env=env_by_key[key])
                            starting += 1
                            n_workers += 1
                        if need > starting and n_workers + ns.starting >= max(1, cap):
                            # at the worker cap: evict an idle worker whose
                            # env can't serve any queued task so this env
                            # gets a slot (env-keyed pooling stays live)
                            victim = next(
                                (w for w in ns.idle if w.runtime_env_key not in need_by_key),
                                None,
                            )
                            if victim is not None:
                                self._kill_worker(victim, reason="evicted for new runtime_env")
                                n_workers -= 1
                                self._spawn_worker(ns, runtime_env=env_by_key[key])
                                n_workers += 1
                    for spec, gpu_ids, bundle, key in deferred:
                        if ns.spawn_failures.get(key, 0) >= 3:
                            # release the resources phase 1 acquired; the
                            # error is sealed below, outside the lock
                            pool = bundle.available if bundle is not None else ns.available
                            _release(spec.get("resources", {}), pool)
                            _give_gpus(ns, gpu_ids, spec.get("resources", {}).get(GPU, 0))
                            env_failed.append((spec, key))
                        else:
                            with ns.shard.lock:
                                ns.ready_queue.append((spec, gpu_ids, bundle))
        for spec, key in env_failed:
            self._seal_error_returns(
                spec,
                RuntimeError(
                    f"runtime_env setup failed: workers for env {key!r} died "
                    f"3 times before registering (bad env_vars/working_dir?)"
                ),
            )

    def _dispatch(self, ns: NodeState, w: WorkerHandle, spec: dict, gpu_ids: List[int], bundle) -> None:
        w.state = "busy"
        w.current_task = spec
        self.running[spec["task_id"]] = {
            "spec": spec,
            "worker": w,
            "node_id": ns.node_id,
            "held": dict(spec.get("resources", {})),
            "gpu_ids": gpu_ids,
            "bundle": bundle,
        }
        ti = self.gcs.tasks.get(spec["task_id"])
        if ti:
            ti.state = "RUNNING"
            ti.node_id = ns.node_id
        if events_mod.ENABLED:
            if ti:
                _sched_metrics()["dispatch_latency"].observe(
                    max(0.0, time.time() - ti.start_time))
            self._dispatch_n += 1
            if self._dispatch_n % _DISPATCH_EVENT_SAMPLE == 1 \
                    or _DISPATCH_EVENT_SAMPLE == 1 or gpu_ids:
                events_mod.emit(
                    "scheduler", f"dispatch {spec.get('name', 'task')}",
                    severity="DEBUG", entity_id=spec["task_id"].hex(),
                    node=ns.node_id, worker=w.worker_id.hex(),
                    gpus=len(gpu_ids), sample=_DISPATCH_EVENT_SAMPLE)
        self._queue_execute(w, spec, gpu_ids)

    def _release_task_resources(self, rt: dict) -> None:
        with self.lock:
            self._release_task_resources_locked(rt)

    def _release_task_resources_locked(self, rt: dict) -> None:
        ns = self.nodes.get(rt["node_id"])
        if ns is None:
            return
        held = dict(rt["held"])
        if rt["worker"].block_depth > 0:
            held[CPU] = 0.0  # CPUs already released by the blocked path
            rt["worker"].block_depth = 0
        bundle = rt.get("bundle")
        pool = bundle.available if bundle is not None and not bundle.detached else ns.available
        _release(held, pool)
        _give_gpus(ns, rt.get("gpu_ids", []), held.get(GPU, 0))
        self._wake_scheduler()

    def _on_task_done(self, w: WorkerHandle, msg: dict) -> None:
        spec = msg["spec_ref"]
        tid = spec["task_id"]
        if w.is_actor_worker and not spec.get("is_actor_creation"):
            # HOT PATH: actor-method completion runs entirely inside the
            # actor's shard — methods hold no node resources (the actor's
            # dedicated worker does), so completion only advances the
            # actor's dispatch window.  No head lock.
            self._on_actor_task_done(w, msg, tid)
            return
        # its first task or constructor is over: the worker's start-up
        # (torch's import, a CUDA context, a model's build) is behind it.
        # A later task's end keeps the earlier time (min).
        wid = w.worker_id.hex()
        self._history_from[wid] = min(self._history_from.get(wid, math.inf),
                                      time.time() + self.WORKER_WARMUP_S)
        with self.lock:
            rt = self.running.pop(tid, None)
            full_spec = w.current_task  # has pinned_refs (spec_ref doesn't)
            w.current_task = None
        # The task is over: its argument pins drop.  Borrowing workers have
        # already registered their own handle refs (their add_ref messages
        # precede this task_done on the same connection).  Actor creation
        # specs keep their pins — they are re-dispatched on restart.
        if full_spec is not None and not spec.get("is_actor_creation"):
            self._release_spec_pins(full_spec)
        if msg.get("failed"):
            self.publish("error", {"task": spec.get("name"), "task_id": tid.hex(),
                                   "error": msg.get("error_str")})
        self._finish_task_record(tid, msg)
        # return objects were sealed by the worker via "seal" messages already
        is_creation = spec.get("is_actor_creation")
        if is_creation:
            if rt is not None:
                self._release_task_resources(rt)
            self._on_actor_started(spec, w, failed=msg.get("failed"), error=msg.get("error_str"))
        with self.lock:
            # release + pipeline promotion under ONE lock hold: releasing
            # first and re-acquiring in a separate critical section lets a
            # concurrent dispatch take the freed CPUs and the promotion's
            # "identical shape always fits" invariant would oversubscribe
            if rt is not None and not is_creation:
                self._release_task_resources_locked(rt)
            if w.state == "busy" and not w.is_actor_worker:
                ns = self.nodes.get(w.node_id)
                nxt = None
                if ns and ns.alive and w.pipeline:
                    nxt = w.pipeline.popleft()
                if nxt is not None:
                    # promote the pipelined successor: the completed task's
                    # identical resource shape was released above, so this
                    # acquire always fits; the worker is already executing it
                    _acquire(nxt.get("resources", {}), ns.available)
                    w.current_task = nxt
                    self.running[nxt["task_id"]] = {
                        "spec": nxt,
                        "worker": w,
                        "node_id": ns.node_id,
                        "held": dict(nxt.get("resources", {})),
                        "gpu_ids": [],
                        "bundle": None,
                    }
                    self._pipeline_topup(ns, w)
                else:
                    w.state = "idle"
                    if ns and ns.alive:
                        w.idle_since = time.time()
                        ns.idle.append(w)
                        # OnWorkerIdle fast path (direct_task_transport.cc:174):
                        # hand this worker the next compatible pending task
                        # right here, skipping a scheduler-thread round trip
                        # per completion (the hot-loop latency of a task wave)
                        self._fast_redispatch(ns, w)
    def _finish_task_record(self, tid: bytes, msg: dict,
                            node_id: Optional[str] = None) -> None:
        """Terminal task-table bookkeeping shared by the plain and actor
        task_done paths.  gcs.lock guards the row (NOT the head lock —
        the actor path completes on its shard without ever taking it, so
        gcs.lock is the one lock every writer of this table holds); the
        per-tid writer is unique, so field writes never race each other.
        Dynamic-waiter membership probes are GIL-atomic; a stale read
        costs one redundant wake."""
        with self.gcs.lock:
            ti = self.gcs.tasks.get(tid)
            if ti:
                ti.state = "FAILED" if msg.get("failed") else "FINISHED"
                ti.exec_start = msg.get("exec_start")
                ti.exec_end = msg.get("exec_end")
                ti.worker_pid = msg.get("worker_pid")
                ti.end_time = time.time()
                if ti.node_id is None:
                    # an actor method ran on its actor's node (the
                    # timeline's and list_tasks' row for it)
                    ti.node_id = node_id
        if tid in self._dynamic_yields or tid in self._dynamic_waiters:
            self._wake_dynamic_waiters(tid)

    def _on_actor_task_done(self, w: WorkerHandle, msg: dict,
                            tid: bytes) -> None:
        """Actor-method completion on the actor's home shard (no head
        lock): pop the in-flight entry, drop its pins, update the task
        table, and dispatch the next queued method in the freed window."""
        spec = msg["spec_ref"]
        art = self.actors.get(w.actor_id)  # dict read: GIL-safe
        full_spec = None
        if art is not None:
            with art.shard.lock:
                # concurrent actors complete out of order — find by task id
                full_spec = art.inflight.pop(tid, None)
                if full_spec is not None and art.inflight_groups:
                    g = full_spec.get("concurrency_group") or "_default"
                    n = art.inflight_groups.get(g, 1) - 1
                    if n > 0:
                        art.inflight_groups[g] = n
                    else:
                        art.inflight_groups.pop(g, None)
        # The task is over: its argument pins drop (borrowing workers
        # already registered their own handle refs — their add_ref frames
        # precede this task_done on the same connection).
        if full_spec is not None:
            self._release_spec_pins(full_spec)
        if msg.get("failed"):
            self.publish("error", {"task": spec.get("name"),
                                   "task_id": tid.hex(),
                                   "error": msg.get("error_str")})
        self._finish_task_record(tid, msg, w.node_id)
        if art is not None:
            with art.shard.lock:
                # a concurrency slot opened: dispatch the next queued
                # method right here (no scheduler wake — resources didn't
                # change, only this actor's pipeline advanced)
                self._dispatch_actor_next_locked(art)

    def _fast_redispatch(self, ns: NodeState, w: WorkerHandle) -> None:
        """Dispatch the next plain task this idle worker can run (lock
        held).  Only strategy-free CPU-only specs qualify — anything with
        affinity/PG/GPU placement goes through the full scheduler.
        Sources, in order: the resource-starved backlog (FIFO-older than
        any arrival; O(shapes) to probe, never O(backlog)), then the
        arrival queue's head (only the head: skipping past it would
        reorder submissions)."""
        if w.state != "idle" or not ns.alive:
            return

        def eligible(spec) -> bool:
            req = spec.get("resources", {})
            return not (
                spec.get("scheduling_strategy") is not None
                or req.get(GPU, 0)
                or _runtime_env_key(spec.get("runtime_env")) != w.runtime_env_key
                or not self._deps_ready(spec)
                or not _fits(req, ns.available)
            )

        spec = None
        src_shape = None
        for shape, q in list(self._starved.items()):
            resources, strat_key = shape
            if strat_key is not None or dict(resources).get(GPU, 0):
                continue
            head = q[0]
            if eligible(head):
                q.popleft()
                if not q:
                    del self._starved[shape]
                spec = head
                src_shape = shape
                break
        if spec is None:
            if not self.pending_tasks:
                return
            head = self.pending_tasks[0]
            if not eligible(head):
                return  # needs the real scheduler pass
            self.pending_tasks.popleft()
            spec = head
        req = spec.get("resources", {})
        _acquire(req, ns.available)
        try:
            ns.idle.remove(w)
        except ValueError:
            _release(req, ns.available)
            if src_shape is not None:
                # back to its shape queue's HEAD — pending_tasks would
                # re-park it at the tail, behind later same-shape arrivals
                self._starved.setdefault(src_shape, deque()).appendleft(spec)
            else:
                self.pending_tasks.appendleft(spec)
            return
        self._dispatch(ns, w, spec, [], None)
        self._pipeline_topup(ns, w)

    def _pipeline_topup(self, ns: NodeState, w: WorkerHandle) -> None:
        """Send up to task_pipeline_depth follow-on pending tasks to a busy
        plain worker's local queue (lock held).  Only strategy-free,
        GPU-free specs with the SAME resource shape as the running task
        qualify — promotion at completion then swaps the released resources
        for the promoted task's identical request, so accounting never goes
        negative.  The worker executes its queue FIFO, so ordering holds."""
        cur = w.current_task
        if cur is None or w.is_actor_worker:
            return
        if w.block_depth:
            # a blocked worker just had its pipeline reclaimed; queueing
            # more behind the blocked task would recreate the deadlock
            return
        req = cur.get("resources", {})
        if req.get(GPU, 0):
            return
        if cur.get("scheduling_strategy") is not None:
            # promotion acquires against ns.available with no bundle; a
            # PG/affinity successor must go through the scheduler so its
            # bundle (not the node pool) is debited
            return
        # pipeline only when the cluster is saturated for this shape — if
        # any node could run the task NOW, committing it to this busy
        # worker would defeat spreading (a remote node would sit idle
        # while tasks queue behind a local lease)
        if any(n.alive and _fits(req, n.available) for n in self.nodes.values()):
            self._wake_scheduler()
            return
        depth = self.cfg.task_pipeline_depth

        def source():
            """Next same-shape spec: the starved backlog first (the
            saturated case is exactly when the backlog lives there),
            then the arrival-queue head."""
            shape = _placement_shape(cur)
            q = self._starved.get(shape)
            if q:
                spec = q[0]
                if (_runtime_env_key(spec.get("runtime_env"))
                        == w.runtime_env_key
                        and spec.get("resources", {}) == req
                        and self._deps_ready(spec)):
                    q.popleft()
                    if not q:
                        del self._starved[shape]
                    return spec
                return None
            if not self.pending_tasks:
                return None
            spec = self.pending_tasks[0]
            if (
                spec.get("scheduling_strategy") is not None
                or spec.get("resources", {}) != req
                or _runtime_env_key(spec.get("runtime_env")) != w.runtime_env_key
                or not self._deps_ready(spec)
            ):
                return None
            self.pending_tasks.popleft()
            return spec

        while len(w.pipeline) < depth:
            spec = source()
            if spec is None:
                return
            w.pipeline.append(spec)
            ti = self.gcs.tasks.get(spec["task_id"])
            if ti:
                ti.state = "RUNNING"
                ti.node_id = ns.node_id
            self._queue_execute(w, spec, [])

    # ------------------------------------------------------------------
    # actors (GcsActorManager FSM analog)
    # ------------------------------------------------------------------
    def create_actor(self, spec: dict) -> None:
        dup_of: Optional[bytes] = None
        groups_env = (json.dumps(spec["concurrency_groups"])
                      if spec.get("concurrency_groups") else None)
        with self.lock:
            info = ActorInfo(
                actor_id=spec["actor_id"],
                name=spec.get("actor_name"),
                class_name=spec.get("name", "Actor").removesuffix(".__init__"),
                max_restarts=spec.get("max_restarts", 0),
                max_task_retries=spec.get("max_task_retries", 0),
                creation_spec=spec,
                namespace=spec.get("namespace") or "default",
                job_id=spec.get("job_id"),
                lifetime=spec.get("lifetime"),
            )
            with self.gcs.lock:  # see submit_task: the tenant reap and
                # flush/snapshot iterate this dict under gcs.lock alone,
                # so inserts must hold it too (node->gcs nesting, same as
                # the gcs.tasks fix)
                self.gcs.actors[spec["actor_id"]] = info
            self.registry.create_pending_batch(spec["return_ids"])
            if info.name:
                key = (info.namespace, info.name)
                existing = self.gcs.named_actors.get(key)
                prior = self.actors.get(existing) if existing else None
                if prior is not None and prior.info.state != "DEAD":
                    # name collision INSIDE one namespace: fail this
                    # creation (two tenants using the same name in their
                    # own namespaces never reach here — distinct keys)
                    dup_of = existing
                    info.state = "DEAD"
                    info.death_cause = (
                        f"actor name {info.name!r} is already taken in "
                        f"namespace {info.namespace!r}")
                else:
                    self.gcs.named_actors[key] = spec["actor_id"]
            if dup_of is None:
                self.actors[spec["actor_id"]] = ActorRuntime(
                    info=info, groups_env=groups_env,
                    shard=self.shards.for_actor(spec["actor_id"]))
                self._wake_scheduler()
        if dup_of is not None:
            from ray_tpu_torch.exceptions import RayActorError

            self._seal_error_returns(
                spec, RayActorError(info.death_cause))
            events_mod.emit(
                "actor", f"{info.class_name} name collision in namespace",
                severity="ERROR", entity_id=spec["actor_id"].hex(),
                namespace=info.namespace)
            return
        events_mod.emit("actor", f"{info.class_name} -> PENDING_CREATION",
                        severity="DEBUG", entity_id=spec["actor_id"].hex())

    def _unregister_named_actor(self, info: ActorInfo) -> None:
        """Drop a permanently-DEAD actor's namespace directory entry (the
        name becomes reusable; lookups of dead actors already miss)."""
        if not info.name:
            return
        with self.lock:
            key = (info.namespace, info.name)
            if self.gcs.named_actors.get(key) == info.actor_id:
                del self.gcs.named_actors[key]

    def _schedule_actor_creations_and_tasks(self) -> None:
        spawn_failed: List[Tuple[ActorRuntime, List[dict], Exception]] = []
        with self.lock:
            for art in list(self.actors.values()):
                info = art.info
                if info.state in ("PENDING_CREATION", "RESTARTING") and art.worker is None:
                    spec = info.creation_spec
                    if not self._deps_ready(spec):
                        continue
                    sel = self._select_node(spec)
                    if sel is None:
                        continue
                    ns, bundle = sel
                    req = spec.get("resources", {})
                    pool = bundle.available if bundle is not None else ns.available
                    _acquire(req, pool)
                    art.held = dict(req)
                    art.node_id = ns.node_id
                    art.bundle = bundle
                    art.gpu_ids = _take_gpus(ns, req.get(GPU, 0))
                    # dedicated worker for the actor
                    worker_id = os.urandom(8)  # raylint: disable=R3 (per actor)
                    extra_env: Dict[str, str] = {}
                    # the actor's process sees exactly its cards (none when
                    # it holds none), so CUDA numbers them from 0 there
                    extra_env["CUDA_VISIBLE_DEVICES"] = ",".join(
                        str(i) for i in art.gpu_ids)
                    extra_env["RAY_TPU_TORCH_ASSIGNED_GPUS"] = extra_env["CUDA_VISIBLE_DEVICES"]
                    if art.max_concurrency > 1:
                        extra_env["RAY_TPU_TORCH_MAX_CONCURRENCY"] = str(art.max_concurrency)
                    if art.groups_env:
                        # the worker builds one bounded pool per group from
                        # this (plus the default max_concurrency pool)
                        extra_env["RAY_TPU_TORCH_CONCURRENCY_GROUPS"] = art.groups_env
                    try:
                        proc = self._spawn_on_node(
                            ns, worker_id, spec.get("runtime_env"), extra_env
                        )
                    except (OSError, ValueError) as e:
                        # cannot even fork (bad working_dir, fd/memory
                        # pressure): give the resources back and fail the
                        # actor — re-acquiring every pass would drain the
                        # node's availability with nothing to show for it
                        _release(art.held, pool)
                        _give_gpus(ns, art.gpu_ids, art.held.get(GPU, 0))
                        art.held = {}
                        art.gpu_ids = []
                        with art.shard.lock:
                            info.state = "DEAD"
                            info.death_cause = f"worker spawn failed: {e}"
                            failed = list(art.queue)
                            art.queue.clear()
                        spawn_failed.append((art, failed, e))
                        continue
                    h = WorkerHandle(
                        worker_id=worker_id,
                        node_id=ns.node_id,
                        proc=proc,
                        is_actor_worker=True,
                        actor_id=info.actor_id,
                        runtime_env_key=_runtime_env_key(spec.get("runtime_env")),
                    )
                    self.workers[worker_id] = h
                    art.worker = h
                    info.node_id = ns.node_id
                    info.worker_id = worker_id
                    info.state = "CREATING"
        if spawn_failed:
            from ray_tpu_torch.exceptions import RayActorError

            for art, failed, e in spawn_failed:
                err = RayActorError(
                    f"Actor {art.info.class_name} worker failed to spawn: {e}"
                )
                self._unregister_named_actor(art.info)
                self._seal_error_returns(art.info.creation_spec, err)
                for s in failed:
                    self._seal_error_returns(s, err)
        with self.lock:
            # dispatch actor creation + method calls to registered actor
            # workers (head lock -> per-actor shard lock, one at a time)
            for art in list(self.actors.values()):
                w = art.worker
                if w is None or w.conn is None or w.state == "dead":
                    continue
                with art.shard.lock:
                    if art.info.state == "CREATING":
                        if w.state == "idle":
                            w.state = "busy"
                            spec = art.info.creation_spec
                            w.current_task = spec
                            self._queue_execute(w, spec, art.gpu_ids)
                            art.info.state = "STARTING"
                    elif art.info.state == "ALIVE":
                        self._dispatch_actor_next_locked(art)

    def _dispatch_actor_next_locked(self, art: ActorRuntime) -> None:
        """Pipeline queued methods straight to the actor's worker, up to
        max_concurrency in-flight (the direct actor task submitter fast
        path, reference ``direct_actor_task_submitter.h:67``).  Runs on
        whichever thread made the actor dispatchable — submit, task_done,
        dep seal — so a method call never waits on a scheduler-thread
        round trip.  Caller holds ``art.shard.lock`` (NOT the head lock:
        actors on different shards dispatch concurrently); per-actor FIFO
        order is preserved because every dispatch site pops under that
        one shard lock."""
        w = art.worker
        if (w is None or w.conn is None or w.state == "dead"
                or art.info.state != "ALIVE"):
            return
        # dispatch window = concurrency + pipeline headroom: the worker
        # bounds actual execution concurrency itself (inline loop or its
        # BoundedExecutor pool), so the extra calls just wait in its local
        # queue instead of across a head round trip
        groups = art.concurrency_groups
        if not groups:
            window = art.max_concurrency + self.cfg.actor_pipeline_depth
            while art.queue and len(art.inflight) < window:
                spec = art.queue[0]
                if not self._deps_ready(spec):
                    self._dep_blocked_actors.add(art.info.actor_id)
                    break
                art.queue.popleft()
                art.inflight[spec["task_id"]] = spec
                self._queue_execute(w, spec, art.gpu_ids)
            return
        # concurrency groups: one dispatch window PER group, FIFO within a
        # group, groups independent — a group whose window is full (or
        # whose next method is dep-blocked) is skipped, never the others
        # (the starvation fix: health-group calls dispatch past a
        # saturated default group).  ``_default`` keeps max_concurrency
        # semantics for method calls with no group.  Single left-to-right
        # pass rebuilding the queue: popleft + append keeps this O(n)
        # under the node lock (deque.remove mid-scan was O(n) per
        # dispatch — quadratic exactly when a group is saturated).
        depth = self.cfg.actor_pipeline_depth
        blocked: set = set()
        kept: List[dict] = []
        for _ in range(len(art.queue)):
            spec = art.queue.popleft()
            g = spec.get("concurrency_group") or "_default"
            if g in blocked:
                kept.append(spec)  # per-group FIFO: nothing in g may pass
                continue
            cap = groups.get(g, art.max_concurrency)
            if art.inflight_groups.get(g, 0) >= cap + depth:
                blocked.add(g)
                kept.append(spec)
                continue
            if not self._deps_ready(spec):
                self._dep_blocked_actors.add(art.info.actor_id)
                blocked.add(g)
                kept.append(spec)
                continue
            art.inflight[spec["task_id"]] = spec
            art.inflight_groups[g] = art.inflight_groups.get(g, 0) + 1
            self._queue_execute(w, spec, art.gpu_ids)
        art.queue.extend(kept)

    def _on_actor_started(self, spec: dict, w: WorkerHandle, failed: bool, error: Optional[str]) -> None:
        from ray_tpu_torch.exceptions import RayActorError

        failed_specs = []
        with self.lock:
            art = self.actors.get(spec["actor_id"])
            if art is None:
                return
            with art.shard.lock:  # head lock -> shard lock (fixed order)
                if failed:
                    # the constructor raised: the actor is dead for good, so
                    # the methods queued behind its creation fail now (not
                    # hang), and its worker ends below, giving back its grant
                    art.info.state = "DEAD"
                    art.info.death_cause = f"creation failed: {error}"
                    art.info.max_restarts = art.info.num_restarts
                    failed_specs = list(art.queue)
                    art.queue.clear()
                else:
                    art.info.state = "ALIVE"
                    # A defaulted num_cpus=1 was placement-only: reference actors
                    # occupy 0 CPU once created, so long-lived idle actors don't
                    # starve tasks out of the node (actor.py release_cpu_after_start).
                    if art.info.creation_spec.get("release_cpu_after_start") and art.held.get(CPU):
                        ns = self.nodes.get(art.node_id)
                        bundle = getattr(art, "bundle", None)
                        pool = (
                            bundle.available
                            if bundle is not None and not bundle.detached
                            else (ns.available if ns is not None else None)
                        )
                        if pool is not None and w.block_depth == 0:
                            _release({CPU: art.held[CPU]}, pool)
                        art.held[CPU] = 0.0
                    # methods queued while the actor was starting dispatch now
                    self._dispatch_actor_next_locked(art)
            self._wake_scheduler()
        events_mod.emit(
            "actor",
            f"{art.info.class_name} -> {'DEAD (creation failed)' if failed else 'ALIVE'}",
            severity="ERROR" if failed else "INFO",
            entity_id=spec["actor_id"].hex(), node=art.node_id)
        if failed:
            self._release_spec_pins(art.info.creation_spec)
            self._unregister_named_actor(art.info)
            err = RayActorError(f"Actor {art.info.class_name} died: {art.info.death_cause}")
            for queued in failed_specs:
                self._seal_error_returns(queued, err)
            self._kill_worker(w, reason=f"actor {art.info.class_name} creation failed")

    def submit_actor_task(self, spec: dict) -> None:
        from ray_tpu_torch.exceptions import RayActorError

        # HOT PATH: no head lock.  The actor's home shard alone guards its
        # queue and dispatch window, so submissions to different actors
        # (different tenants, different reader threads) run in parallel;
        # the registry and GCS tables have their own locks.
        art = self.actors.get(spec["actor_id"])  # dict read: GIL-safe
        self.registry.create_pending_batch(spec["return_ids"])
        dead_cause = None
        need_wake = False
        if art is None:
            dead_cause = "unknown actor"
        else:
            with self.gcs.lock:  # see submit_task: iterators hold only
                # gcs.lock, so inserts must too
                self.gcs.tasks[spec["task_id"]] = TaskInfo(
                    task_id=spec["task_id"],
                    name=spec.get("name", "actor_task"),
                    trace_ctx=spec.get("trace_ctx"),
                    job_id=spec.get("job_id"),
                )
            with art.shard.lock:
                # state re-checked UNDER the shard lock: the death path
                # drains the queue while holding it, so this append either
                # precedes the drain (which fails the spec) or observes
                # DEAD here — a spec can never strand on a dead queue
                if art.info.state == "DEAD":
                    dead_cause = art.info.death_cause
                else:
                    art.queue.append(spec)
                    # direct dispatch on the submitting connection's reader
                    # thread; the scheduler is only needed while the actor
                    # isn't placed yet
                    self._dispatch_actor_next_locked(art)
                    need_wake = bool(art.queue) and (
                        art.worker is None or art.info.state != "ALIVE")
        if dead_cause is not None:
            err = RayActorError(f"Actor is dead: {dead_cause}")
            threading.Thread(target=self._seal_error_returns, args=(spec, err), daemon=True).start()
            return
        if need_wake:
            with self.lock:
                self._wake_scheduler()

    def _on_actor_worker_death(self, w: WorkerHandle, reason: str) -> None:
        from ray_tpu_torch.exceptions import RayActorError

        with self.lock:
            art = self.actors.get(w.actor_id)
            if art is None:
                return
            info = art.info
            # head lock first, then the actor's shard lock (fixed order):
            # the queue drain and the DEAD transition happen under the
            # shard lock so a concurrent shard-only submit either lands
            # before the drain (and is failed by it) or observes DEAD
            with art.shard.lock:
                will_restart = (info.state != "DEAD"
                                and (info.num_restarts < info.max_restarts
                                     or info.max_restarts == -1))
                # At-most-once by default: methods that were EXECUTING fail
                # with RayActorError.  With max_task_retries they requeue and
                # re-run on the restarted instance (never-started queued
                # methods always survive a restart — they haven't run yet).
                failed_specs = []
                retried = []
                for spec in art.inflight.values():  # dict order = dispatch order
                    attempts = spec.get("_actor_task_attempts", 0)
                    if will_restart and (
                        info.max_task_retries == -1
                        or attempts < info.max_task_retries
                    ):
                        spec["_actor_task_attempts"] = attempts + 1
                        retried.append(spec)
                    else:
                        failed_specs.append(spec)
                # extendleft reverses, so feed it the reversed list to put the
                # retried methods back at the front IN their dispatch order
                art.queue.extendleft(reversed(retried))
                art.inflight.clear()
                art.inflight_groups.clear()
                art.worker = None
                # release resources (skip CPUs a blocked method already gave
                # back through _on_blocked, or the pool double-counts them)
                ns = self.nodes.get(art.node_id) if art.node_id else None
                if ns is not None and art.held:
                    bundle = getattr(art, "bundle", None)
                    pool = bundle.available if bundle is not None and not bundle.detached else ns.available
                    held = dict(art.held)
                    if w.block_depth > 0:
                        held[CPU] = 0.0
                        w.block_depth = 0
                    _release(held, pool)
                    _give_gpus(ns, art.gpu_ids, art.held.get(GPU, 0))
                    art.held = {}
                    art.gpu_ids = []
                if info.state == "DEAD":
                    return
                if info.num_restarts < info.max_restarts or info.max_restarts == -1:
                    info.num_restarts += 1
                    info.state = "RESTARTING"
                    logger.warning(
                        "actor %s died (%s); restarting (%d/%s)",
                        info.class_name, reason, info.num_restarts,
                        "inf" if info.max_restarts == -1 else info.max_restarts,
                    )
                else:
                    info.state = "DEAD"
                    info.death_cause = reason
                    failed_specs.extend(art.queue)
                    art.queue.clear()
            self._wake_scheduler()
        events_mod.emit(
            "actor", f"{info.class_name} -> {info.state} ({reason})",
            severity="WARNING", entity_id=w.actor_id.hex(),
            restarts=info.num_restarts)
        if info.state == "DEAD":
            # permanently gone: creation-spec arg pins drop now, and the
            # name becomes reusable in its namespace
            self._release_spec_pins(info.creation_spec)
            self._unregister_named_actor(info)
        err = RayActorError(f"Actor {info.class_name} died: {reason}")
        for spec in failed_specs:
            self._seal_error_returns(spec, err)

    # ------------------------------------------------------------------
    # task cancellation (reference ``python/ray/_private/worker.py:2573``
    # ``cancel`` + the core worker's CancelTask RPC)
    # ------------------------------------------------------------------
    def cancel_task(self, oid: bytes, force: bool = False,
                    recursive: bool = True) -> None:
        """Cancel the task that produces ``oid``.

        - queued anywhere head-side (pending/ready/actor queue): dequeued,
          returns sealed with TaskCancelledError, resources released;
        - dispatched to a worker (running or pipelined): returns pre-sealed
          with TaskCancelledError, then the worker is told to skip/interrupt
          it (``force=True`` SIGKILLs the worker instead — plain tasks only;
          the reference likewise refuses force-cancel of actor tasks);
        - finished/unknown: no-op.

        ``recursive`` also cancels tasks submitted BY the cancelled task
        (tracked via the spec's ``parent_task_id``).
        """
        from ray_tpu_torch.exceptions import TaskCancelledError

        queue = deque([oid])
        seen = set()
        while queue:
            o = queue.popleft()
            if o in seen:
                continue
            seen.add(o)
            with self.lock:
                found = self._cancel_locked(o, force)
            if found is None:
                continue
            action, spec, w = found
            tid = spec["task_id"]
            if action == "dequeued":
                self._seal_error_returns(
                    spec, TaskCancelledError(
                        f"task {spec.get('name')} was cancelled before it started"))
            elif action == "at_worker":
                # pre-seal so callers unblock now; the worker's own late
                # seal (if it finishes anyway) loses first-seal-wins
                self._seal_error_returns(
                    spec, TaskCancelledError(
                        f"task {spec.get('name')} was cancelled"))
                if force:
                    self._kill_worker(w, reason="task force-cancelled")
                else:
                    try:
                        w.send({"type": "cancel", "task_id": tid})
                    except (OSError, ValueError):
                        pass
            if recursive:
                with self.lock:
                    queue.extend(self._children_return_oids_locked(tid))

    def _cancel_locked(self, oid: bytes, force: bool):
        """Locate the task producing ``oid`` and dequeue it if still
        head-side.  Returns (action, spec, worker|None) or None.  Lock held."""

        def produces(spec):
            return oid in spec.get("return_ids", ())

        # 1. cluster-pending (arrival queue + resource-starved backlog)
        for spec in self.pending_tasks:
            if produces(spec):
                self.pending_tasks.remove(spec)
                return ("dequeued", spec, None)
        for shape, q in list(self._starved.items()):
            for spec in q:
                if produces(spec):
                    q.remove(spec)
                    if not q:
                        del self._starved[shape]
                    return ("dequeued", spec, None)
        # 2. staged on a node (resources held)
        for ns in self.nodes.values():
            with ns.shard.lock:
                for entry in ns.ready_queue:
                    spec, gpu_ids, bundle = entry
                    if produces(spec):
                        ns.ready_queue.remove(entry)
                        pool = bundle.available if bundle is not None else ns.available
                        _release(spec.get("resources", {}), pool)
                        _give_gpus(ns, gpu_ids, spec.get("resources", {}).get(GPU, 0))
                        return ("dequeued", spec, None)
        # 3. actor method queues (shard-guarded: submits append to these
        # queues under the shard lock only, so the scan must hold it too)
        for art in self.actors.values():
            with art.shard.lock:
                for spec in art.queue:
                    if produces(spec):
                        art.queue.remove(spec)
                        return ("dequeued", spec, None)
                for spec in art.inflight.values():
                    if produces(spec):
                        if force:
                            raise ValueError(
                                "force=True is not supported for actor tasks")
                        return ("at_worker", spec, art.worker)
        # 4. at a worker: running or pipelined behind the running task
        for tid, rt in self.running.items():
            if produces(rt["spec"]):
                rt["spec"]["retries_left"] = 0  # a cancel never retries
                return ("at_worker", rt["spec"], rt["worker"])
        for w in self.workers.values():
            for spec in w.pipeline:
                if produces(spec):
                    spec["retries_left"] = 0
                    return ("at_worker", spec, w)
        return None

    def _children_return_oids_locked(self, tid: bytes) -> List[bytes]:
        """First return oid of every task submitted by task ``tid``."""
        out = []

        def scan(spec):
            if spec.get("parent_task_id") == tid and spec.get("return_ids"):
                out.append(spec["return_ids"][0])

        for spec in self.pending_tasks:
            scan(spec)
        for q in self._starved.values():
            for spec in q:
                scan(spec)
        for ns in self.nodes.values():
            with ns.shard.lock:
                for spec, _, _ in ns.ready_queue:
                    scan(spec)
        for rt in self.running.values():
            scan(rt["spec"])
        for w in self.workers.values():
            for spec in w.pipeline:
                scan(spec)
        for art in self.actors.values():
            with art.shard.lock:
                for spec in art.queue:
                    scan(spec)
                for spec in art.inflight.values():
                    scan(spec)
        return out

    def kill_actor(self, actor_id: bytes, no_restart: bool = True) -> None:
        from ray_tpu_torch.exceptions import RayActorError

        with self.lock:
            art = self.actors.get(actor_id)
            if art is None:
                return
            with art.shard.lock:  # head lock -> shard lock (fixed order)
                if no_restart:
                    art.info.max_restarts = art.info.num_restarts  # disable restart
                w = art.worker
                failed_specs = []
                if w is None and no_restart and art.info.state != "DEAD":
                    # Killed before its worker ever spawned: fail it in place so
                    # it doesn't get scheduled later and run forever.
                    art.info.state = "DEAD"
                    art.info.death_cause = "killed before creation"
                    failed_specs = list(art.queue)
                    art.queue.clear()
                    ns = self.nodes.get(art.node_id) if art.node_id else None
                    if ns is not None and art.held:
                        bundle = getattr(art, "bundle", None)
                        pool = (
                            bundle.available
                            if bundle is not None and not bundle.detached
                            else ns.available
                        )
                        _release(art.held, pool)
                        _give_gpus(ns, art.gpu_ids, art.held.get(GPU, 0))
                        art.held = {}
                        art.gpu_ids = []
                    self._wake_scheduler()
        if art.info.state == "DEAD":
            self._release_spec_pins(art.info.creation_spec)
            self._unregister_named_actor(art.info)
        err = RayActorError(f"Actor {art.info.class_name} was killed before creation")
        for spec in failed_specs:
            self._seal_error_returns(spec, err)
        if w is not None:
            # _kill_worker, not w.proc.kill(): a REMOTE actor's worker has
            # no head-side proc — the raw kill silently no-op'd, leaving a
            # zombie worker running on its agent AND its bundle capacity
            # held forever (a gang restart on live nodes then wedges: the
            # old gang's CPUs never return to the node pool)
            self._kill_worker(w, reason=f"actor {art.info.class_name} killed")

    # ------------------------------------------------------------------
    # placement groups (GcsPlacementGroupManager + bundle policies analog)
    # ------------------------------------------------------------------
    def create_placement_group(self, spec: dict) -> None:
        with self.lock:
            info = PlacementGroupInfo(
                pg_id=spec["pg_id"],
                bundles=spec["bundles"],
                strategy=spec["strategy"],
                name=spec.get("name"),
            )
            self.gcs.placement_groups[info.pg_id] = info
            rt = PGRuntime(info=info, ready_oid=spec.get("ready_oid"))
            self.pgs[info.pg_id] = rt
            if rt.ready_oid:
                self.registry.create_pending(rt.ready_oid)
            self.pending_pgs.append(rt.info.pg_id)
            self._wake_scheduler()

    def _schedule_pgs(self) -> None:
        """Bundle placement: STRICT_PACK / PACK / SPREAD / STRICT_SPREAD
        (bundle_scheduling_policy.h:82-106)."""
        sealed = []
        with self.lock:
            still = deque()
            while self.pending_pgs:
                pg_id = self.pending_pgs.popleft()
                rt = self.pgs.get(pg_id)
                if rt is None or rt.info.state != "PENDING":
                    continue
                placement = self._try_place_bundles(rt.info)
                if placement is None:
                    still.append(pg_id)
                    continue
                for bundle_req, ns in placement:
                    _acquire(bundle_req, ns.available)
                    rt.bundles.append(
                        BundleRuntime(node_id=ns.node_id, reserved=dict(bundle_req), available=dict(bundle_req))
                    )
                    rt.info.bundle_nodes.append(ns.node_id)
                rt.info.state = "CREATED"
                if rt.ready_oid:
                    sealed.append(rt.ready_oid)
            self.pending_pgs = still
        for oid in sealed:
            from ray_tpu_torch._private.object_store import store_value
            from ray_tpu_torch._private.object_ref import ObjectRef

            loc, _ = store_value(ObjectRef(oid), True)
            self.seal_object(oid, loc, [])

    def _try_place_bundles(self, info: PlacementGroupInfo):
        alive = [n for n in self.nodes.values() if n.alive]
        scratch = {n.node_id: dict(n.available) for n in alive}
        placement = []
        strategy = info.strategy
        if strategy in ("STRICT_PACK", "PACK"):
            # STRICT_PACK: all bundles on one node. PACK: best effort pack.
            for n in alive:
                avail = dict(scratch[n.node_id])
                ok = True
                for b in info.bundles:
                    if _fits(b, avail):
                        _acquire(b, avail)
                    else:
                        ok = False
                        break
                if ok:
                    return [(b, n) for b in info.bundles]
            if strategy == "STRICT_PACK":
                # Gang lease at slice granularity: when no single node
                # holds the gang, the pack unit widens to one FAILURE
                # DOMAIN — all bundles land within one slice (hosts
                # sharing a slice_id), leased atomically or not at all
                # (the TPU pod-slice semantics; a bundle-per-host gang
                # across a 16-host slice is exactly this shape).
                return self._try_pack_in_slice(info, alive, scratch)
        used_nodes = set()
        for b in info.bundles:
            cands = [n for n in alive if _fits(b, scratch[n.node_id])]
            if strategy == "STRICT_SPREAD":
                cands = [n for n in cands if n.node_id not in used_nodes]
            if not cands:
                return None
            if strategy in ("SPREAD", "STRICT_SPREAD"):
                cands.sort(key=lambda n: (n.node_id in used_nodes, len([1 for _, m in placement if m.node_id == n.node_id])))
            n = cands[0]
            _acquire(b, scratch[n.node_id])
            used_nodes.add(n.node_id)
            placement.append((b, n))
        return placement

    def _try_pack_in_slice(self, info: PlacementGroupInfo, alive, scratch):
        """STRICT_PACK fallback: fit ALL bundles within one slice.

        Slices are tried smallest-member-count first (tightest failure
        domain that can hold the gang); within a slice, bundles first-fit
        across members sorted by id (rank i of an N-bundle/N-host gang
        lands on host i — the deterministic rank→host mapping a
        collective mesh wants).  All-or-nothing per slice: a slice with a
        dead member that can't absorb the gang is skipped whole."""
        by_slice: Dict[str, list] = {}
        for n in alive:
            if n.slice_id is not None:
                by_slice.setdefault(n.slice_id, []).append(n)
        for _, members in sorted(by_slice.items(),
                                 key=lambda kv: (len(kv[1]), kv[0])):
            members = sorted(members, key=lambda n: n.node_id)
            avail = {n.node_id: dict(scratch[n.node_id]) for n in members}
            placement = []
            ok = True
            for b in info.bundles:
                for n in members:
                    if _fits(b, avail[n.node_id]):
                        _acquire(b, avail[n.node_id])
                        placement.append((b, n))
                        break
                else:
                    ok = False
                    break
            if ok:
                return placement
        return None

    def remove_placement_group(self, pg_id: bytes) -> None:
        with self.lock:
            rt = self.pgs.pop(pg_id, None)
            if rt is None:
                return
            rt.info.state = "REMOVED"
            for b in rt.bundles:
                b.detached = True
                ns = self.nodes.get(b.node_id)
                if ns is not None:
                    # return unconsumed capacity now; capacity consumed by
                    # still-running tasks flows back to the node when they
                    # finish (the detached flag reroutes their release).
                    _release(b.available, ns.available)
                    b.available = {}
            self._wake_scheduler()

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    # ------------------------------------------------------------------
    # log plane (head side)
    # ------------------------------------------------------------------
    def _ingest_log_report(self, origin: str, records, metas=None) -> None:
        """One shipped batch lands in the store; each job's slice then
        fans out to that job's subscribed drivers over pubsub.  Dict
        materialization (and actor-name resolution) happens only for
        channels someone is actually listening on."""
        by_job = self.log_store.ingest(origin, records, metas)
        for job, recs in by_job.items():
            channel = f"logs:{job}"
            with self.lock:
                if not self.subscribers.get(channel):
                    continue
            out = []
            meta_cache: Dict[str, dict] = {}
            for seq, ts, stream, src, task, actor, trace, line in recs:
                meta = meta_cache.get(stream)
                if meta is None:
                    meta = self.log_store.stream_meta(stream)
                    meta_cache[stream] = meta
                name = None
                if actor:
                    try:
                        with self.gcs.lock:
                            a = self.gcs.actors.get(bytes.fromhex(actor))
                        if a is not None:
                            name = a.name or a.class_name
                    except ValueError:
                        pass
                out.append({"seq": seq, "ts": ts, "stream": stream,
                            "src": src, "task": task, "actor": actor,
                            "trace": trace, "line": line, "name": name,
                            "pid": meta.get("pid"),
                            "node": meta.get("node")})
            self.publish(channel, {"records": out})

    def _retire_worker_log(self, h, reason: str, busy: bool) -> None:
        """A dead worker's capture file gets one final synchronous drain
        (local workers only — agents drain remote files BEFORE reporting
        the death, so the tail is already here), then its ring is
        retired-but-kept: that is what makes a SIGKILL'd worker's last
        stderr retrievable from the head after death.  If the tail ends
        in error output nobody consumed, surface it as the crash
        explanation (the doctor's worker_stderr_at_death rule)."""
        stream = f"worker-{h.worker_id.hex()}"
        if self._log_monitor is not None and h.proc is not None:
            self._log_monitor.unregister(stream)
        err_rows, _ = self.log_store.query(stream=stream, errors=True,
                                           limit=12)
        self.log_store.retire(stream)
        if not err_rows:
            return
        has_tb = any(r["line"].startswith("Traceback (") for r in err_rows)
        if not (has_tb or busy):
            return  # idle reaping with routine stderr chatter is not a crash
        events_mod.emit(
            "log", f"worker died with uncollected stderr: {reason}",
            severity="ERROR" if busy else "WARNING",
            entity_id=h.worker_id.hex(), node=h.node_id,
            tail=[r["line"] for r in err_rows][-8:])

    def _get_log(self, msg: dict) -> dict:
        """Record query for the state API / CLI.  ``job-<id>`` streams
        fall back to the JobManager's complete on-disk file when the
        store has nothing (log plane disabled, or the ring aged out) —
        job driver logs and worker logs stay one surface either way."""
        rows, cursor = self.log_store.query(
            stream=msg.get("stream"), job=msg.get("job"),
            task=msg.get("task"), actor=msg.get("actor"),
            node=msg.get("node"), pid=msg.get("pid"),
            trace=msg.get("trace"), grep=msg.get("grep"),
            errors=bool(msg.get("errors")),
            since_seq=msg.get("since_seq", 0),
            limit=msg.get("limit", 1000))
        stream = msg.get("stream")
        if not rows and stream and stream.startswith("job-") \
                and not msg.get("since_seq"):
            text = self.job_manager.logs(stream[len("job-"):])
            if text:
                rows = [{"seq": 0, "ts": None, "stream": stream, "src": "o",
                         "job": stream[len("job-"):], "task": "",
                         "actor": "", "trace": "", "line": ln,
                         "node": self._head_node_id, "pid": None}
                        for ln in text.splitlines()[-msg.get("limit", 1000):]]
        return {"records": rows, "cursor": cursor}

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def _list_state(self, what: str, limit: int = 1000,
                    filters: Optional[dict] = None) -> List[dict]:
        return self._list_state_page(what, limit, filters)[0]

    def _list_state_page(self, what: str, limit: int = 1000,
                         filters: Optional[dict] = None,
                         ) -> Tuple[List[dict], int]:
        """State API backend (experimental/state/api.py:729-1333 analog),
        returning ``(rows, total)`` so a truncated listing is visibly
        truncated.  ``filters`` (events only: source/severity) apply
        BEFORE the limit truncation — filtering the newest N cluster-wide
        rows client-side would hide a rare WARNING behind thousands of
        sampled DEBUGs.  Node rows carry each node's ``available``
        resources beside its totals (``"GPU"`` among them)."""

        def rows(items):
            out = []
            for it in list(items)[:limit]:
                d = {}
                for k in it.__dataclass_fields__:
                    if k == "creation_spec":  # big blobs; not introspection data
                        continue
                    v = getattr(it, k)
                    d[k] = v.hex() if isinstance(v, bytes) else v
                out.append(d)
            return out

        with self.gcs.lock:
            if what == "actors":
                return rows(self.gcs.actors.values()), len(self.gcs.actors)
            if what == "nodes":
                node_rows, total = rows(self.gcs.nodes.values()), len(self.gcs.nodes)
            if what == "tasks":
                return rows(self.gcs.tasks.values()), len(self.gcs.tasks)
            if what == "placement_groups":
                return (rows(self.gcs.placement_groups.values()),
                        len(self.gcs.placement_groups))
        if what == "nodes":
            with self.lock:
                for r in node_rows:
                    ns = self.nodes.get(r["node_id"])
                    r["available"] = dict(ns.available) if ns is not None and ns.alive else {}
            return node_rows, total
        if what == "slices":
            # failure-domain view: one row per slice, the unit the
            # autoscaler provisions/replaces atomically
            with self.lock:
                by_slice: Dict[str, dict] = {}
                for ns in self.nodes.values():
                    if ns.slice_id is None:
                        continue
                    row = by_slice.setdefault(ns.slice_id, {
                        "slice_id": ns.slice_id, "members": [],
                        "alive_members": 0, "dead_members": 0,
                        "draining": ns.slice_id in self._draining_slices,
                    })
                    row["members"].append(ns.node_id)
                    row["alive_members" if ns.alive else "dead_members"] += 1
                out = []
                for sid in sorted(by_slice):
                    row = by_slice[sid]
                    row["members"].sort()
                    row["degraded"] = (row["dead_members"] > 0
                                       and row["alive_members"] > 0
                                       and not row["draining"])
                    out.append(row)
            return out[:limit], len(out)
        if what == "objects":
            return (self.registry.list_objects(limit),
                    self.registry.stats()["num_objects"])
        if what == "workers":
            with self.lock:
                return [
                    {"worker_id": w.worker_id.hex(), "node_id": w.node_id,
                     "state": w.state, "is_actor_worker": w.is_actor_worker,
                     "pid": w.proc.pid if w.proc else None}
                    for w in list(self.workers.values())[:limit]
                ], len(self.workers)
        if what == "jobs":
            jobs = self.job_manager.list_jobs()
            return jobs[:limit], len(jobs)
        if what == "events":
            # worker-shipped table + the head's own ring, one timeline;
            # the table computes its filtered total in the same pass
            src = (filters or {}).get("source")
            sev = (filters or {}).get("severity")
            out, table_total = self.events.list_with_total(
                limit, source=src, severity=sev)
            local = [
                dict(r, origin="head") for r in self._session_ring.since(0)
                if (src is None or r.get("source") == src)
                and (sev is None or r.get("severity") == sev)]
            out.extend(local)
            out.sort(key=lambda r: r.get("ts", 0.0))
            return out[-limit:], table_total + len(local)
        if what == "traces":
            self._fold_local_traces()
            return self.traces.list(limit), len(self.traces)
        if what == "tenants":
            # one row per driver job (live + recently dead), with actor
            # counts per namespace — what chaos resolves pids from and
            # what `ray_tpu_torch list tenants` renders
            with self.gcs.lock:
                actor_counts: Dict[str, int] = {}
                for a in self.gcs.actors.values():
                    if a.job_id and a.state != "DEAD":
                        actor_counts[a.job_id] = actor_counts.get(a.job_id, 0) + 1
            with self.lock:
                out = [dict(rec, actors=actor_counts.get(jid, 0))
                       for jid, rec in self._jobs.items()]
            out.sort(key=lambda r: r["job_id"])
            return out[:limit], len(out)
        if what == "logs":
            # one row per captured stream (worker/job/head files the
            # monitors are tailing, retired death tails included)
            rows = self.log_store.stats()
            return rows[:limit], len(rows)
        if what == "incidents":
            # the watchdog's tracked incident set, open + resolved;
            # the history deque rides along for `incidents --history`
            if self.watchdog is None:
                return [], 0
            rows = self.watchdog.incidents.list(include_resolved=True)
            return rows[:limit], len(rows)
        if what == "slos":
            if self.watchdog is None:
                return [], 0
            rows = self.watchdog.slos()
            return rows[:limit], len(rows)
        raise ValueError(f"unknown state table {what!r}")

    # ------------------------------------------------------------------
    # request traces (state_aggregator + tracing backend analog)
    # ------------------------------------------------------------------
    def _fold_local_traces(self) -> None:
        """Fold span events the HEAD process itself emitted (in-process
        drivers, serve routers living here) into the trace table.  Lazy —
        run at query time, cursored so each ring row folds once (the lock
        keeps the cursor single-writer across query + flush threads)."""
        with self._traces_fold_lock:
            rows = events_mod.buffer().since(self._traces_local_seq)
            if rows:
                self._traces_local_seq = rows[-1]["seq"]
                self.traces.add("head", rows)

    def _task_spans(self, trace_id: str) -> Tuple[List[dict], int]:
        """Task-table rows of this trace rendered as spans: the task span
        itself plus scheduler-queue and execution child spans — queue-time
        attribution comes straight from the control plane, no extra
        instrumentation on the dispatch path.

        Bounded like the TraceTable: the join keeps the FIRST N matching
        tasks by submission time (root/ingress work lands early; a traced
        50k-task streaming job must not produce a 150k-span payload) and
        the match runs on a snapshot taken under gcs.lock, not with the
        lock held across rendering."""
        with self.gcs.lock:
            snapshot = list(self.gcs.tasks.values())
        tasks = [t for t in snapshot
                 if t.trace_ctx and t.trace_ctx.get("trace_id") == trace_id]
        dropped = 0
        cap = max(1, events_mod.DEFAULT_TRACE_SPANS // 3)
        if len(tasks) > cap:
            tasks.sort(key=lambda t: t.start_time)
            dropped = len(tasks) - cap
            tasks = tasks[:cap]
        out: List[dict] = []
        now = time.time()
        for t in tasks:
            tc = t.trace_ctx
            sid = tc.get("span_id") or t.task_id.hex()[:16]
            end = t.end_time or now
            out.append({
                "name": t.name, "trace_id": trace_id, "span_id": sid,
                "parent_span_id": tc.get("parent_span_id", ""),
                "phase": "task", "source": "task",
                "origin": t.node_id or "pending",
                "start": t.start_time, "end": end,
                "data": {"task_id": t.task_id.hex(), "state": t.state},
            })
            if t.exec_start:
                out.append({
                    "name": f"{t.name} (queued)", "trace_id": trace_id,
                    "span_id": f"{sid}.q", "parent_span_id": sid,
                    "phase": "scheduler_queue", "source": "task",
                    "origin": t.node_id or "pending",
                    "start": t.start_time, "end": t.exec_start,
                })
                out.append({
                    "name": f"{t.name} (exec)", "trace_id": trace_id,
                    "span_id": f"{sid}.x", "parent_span_id": sid,
                    "phase": "execution", "source": "task",
                    "origin": t.node_id or "pending",
                    "start": t.exec_start, "end": t.exec_end or end,
                })
        return out, dropped

    def _get_trace(self, trace_id: str) -> Optional[dict]:
        """One assembled trace: shipped/local recorder spans + task-table
        spans, sorted by start time.  None for an unknown id."""
        self._fold_local_traces()
        base = self.traces.get(trace_id)
        task_spans, task_dropped = self._task_spans(trace_id)
        if base is None and not task_spans:
            return None
        spans = (base["spans"] if base else []) + task_spans
        spans.sort(key=lambda s: s["start"])
        # the trace's log records (stamped lines whose writer was inside
        # one of these spans) join the tree — prints become evidence on
        # the same timeline as the spans that produced them
        log_rows, _ = self.log_store.query(trace=trace_id, limit=500)
        return {
            "trace_id": trace_id,
            "spans": spans,
            "logs": log_rows,
            "dropped_spans": (base["dropped_spans"] if base else 0)
            + task_dropped,
        }

    def _summarize_state(self, what: str) -> dict:
        """Head-side aggregation for ``summarize_*`` (state_aggregator
        analog): counting happens HERE over the full tables instead of
        shipping up to 100k rows to the client to be counted locally."""
        from collections import Counter

        if what == "events":
            by_source: Dict[str, Counter] = {}
            for e in self._list_state("events", 100_000):
                by_source.setdefault(
                    e["source"], Counter())[e["severity"]] += 1
            return {src: dict(sev) for src, sev in by_source.items()}
        if what == "tasks":
            by_name: Dict[str, Counter] = {}
            with self.gcs.lock:
                for t in self.gcs.tasks.values():
                    by_name.setdefault(t.name, Counter())[t.state] += 1
            return {name: dict(states) for name, states in by_name.items()}
        if what == "actors":
            by_cls: Dict[str, Counter] = {}
            with self.gcs.lock:
                for a in self.gcs.actors.values():
                    by_cls.setdefault(a.class_name, Counter())[a.state] += 1
            return {cls: dict(states) for cls, states in by_cls.items()}
        if what == "traces":
            self._fold_local_traces()
            return self.traces.summarize()
        raise ValueError(f"unknown summary table {what!r}")

    # ------------------------------------------------------------------
    # resource accounting over time (metrics TSDB + top/memory surfaces)
    # ------------------------------------------------------------------
    def _actor_states(self, actor_ids_hex: List[str]) -> List[dict]:
        """State rows of the named actors (a compiled graph's liveness
        check); an unknown id has no row."""
        rows = []
        with self.lock:
            for h in actor_ids_hex:
                art = self.actors.get(bytes.fromhex(h))
                if art is None:
                    continue
                info = art.info
                rows.append({"actor_id": h, "class_name": info.class_name,
                             "state": info.state,
                             "num_restarts": info.num_restarts,
                             "death_cause": info.death_cause})
        return rows

    # ------------------------------------------------------------------
    # resource accounting over time (metrics TSDB + top/memory surfaces)
    # ------------------------------------------------------------------
    def _tsdb_loop(self) -> None:
        """Head-side sampler on the shared deadline grid
        (``metrics.grid_ticks``): every push interval, expire origins
        that stopped pushing, refresh the runtime gauges, sample local
        processes' /proc stats, and fold the head's own registry into
        the TSDB.  The ticker's ``stalled`` flag skips expiry on a tick
        right after a head stall (everyone's timestamps lag equally —
        sweeping then would wipe live peers)."""
        from ray_tpu_torch._private.resource_spec import ProcSampler
        from ray_tpu_torch.util.metrics import grid_ticks, push_interval_s
        from ray_tpu_torch.util.metrics import registry as head_registry

        sampler = ProcSampler()
        for stalled in grid_ticks(push_interval_s(), self._tsdb_stop.wait):
            if self._shutdown:
                continue
            try:
                if not stalled:
                    expired = self.worker_metrics_registry.expire_origins(
                        self._origin_expiry_s)
                    for origin in expired:
                        events_mod.emit(
                            "node", "metrics origin expired",
                            severity="DEBUG", entity_id=origin)
                self._sample_local_procs(sampler)
                self.refresh_runtime_gauges()
                self.tsdb.ingest("head", self._history_rows(head_registry().snapshot()))
                if not stalled:
                    self.tsdb.expire_stale(self._tsdb_expiry_s)
                    # profile rings age on the TSDB's clock: staged decay
                    # every tick, whole origins retired once their pushes
                    # stop — on the history horizon, but never sooner than
                    # two of a profiler's longest intervals: an idle process
                    # backs off to a burst every max_interval_s, and at a
                    # sub-second push the history horizon alone would drop
                    # it between two of its bursts
                    self.profile_store.prune()
                    for origin in self.profile_store.retire_stale(
                            self._profile_retire_s):
                        events_mod.emit(
                            "profile", "profile origin retired",
                            severity="DEBUG", entity_id=origin)
                    for name in self.log_store.retire_stale(
                            self._tsdb_expiry_s):
                        events_mod.emit(
                            "log", "log stream retired",
                            severity="DEBUG", entity_id=name)
                    self._scan_tenant_logs()
            except Exception:
                logger.debug("tsdb sampler tick failed", exc_info=True)
    def _scan_tenant_logs(self) -> None:
        """Adopt proxied tenant-driver capture files (``tenant-*.log``
        under the session logs dir).  The proxier spawns those drivers
        from its own process, so spawn-time registration can't reach this
        monitor — a narrow glob keeps the registration-based ownership
        rule intact (nothing else ever writes tenant-*.log there)."""
        if self._log_monitor is None:
            return
        import glob as glob_mod

        known = set(self._log_monitor.streams())
        pattern = os.path.join(self.session_dir, "logs", "tenant-*.log")
        for path in glob_mod.glob(pattern):
            stream = os.path.basename(path)[:-len(".log")]
            if stream not in known:
                self._log_monitor.register(stream, path,
                                           node=self._head_node_id)


    def _sample_local_procs(self, sampler) -> None:
        """/proc stats for the head process and every worker whose process
        lives on this host (agent nodes sample their own workers and ship
        over metrics_report).  Lands as tagged gauges in the head registry
        — and therefore in the merged view and the TSDB — with dead workers'
        label series retired via Metric.remove."""
        from ray_tpu_torch._private.resource_spec import (
            PROC_CPU_PCT,
            PROC_OPEN_FDS,
            PROC_RSS_MB,
            _PROC_METRIC_HELP,
            resource_metrics_snapshot,
        )
        from ray_tpu_torch.util.metrics import Gauge

        entities = [({"entity": "head", "worker_id": "head",
                      "node": self._head_node_id}, os.getpid())]
        with self.lock:
            for wid, w in self.workers.items():
                if w.proc is not None and w.state != "dead":
                    entities.append((
                        {"entity": "actor" if w.is_actor_worker else "worker",
                         "worker_id": wid.hex(), "node": w.node_id},
                        w.proc.pid))
        _, raw = resource_metrics_snapshot(sampler, entities)
        gauges = {
            name: Gauge(name, _PROC_METRIC_HELP[name])
            for name in (PROC_RSS_MB, PROC_CPU_PCT, PROC_OPEN_FDS)
        }
        live_keys = set()
        proc_live = {}
        for tags, pid, stats in raw:
            full = {**tags, "pid": str(pid)}
            live_keys.add(tuple(sorted(full.items())))
            gauges[PROC_RSS_MB].set(stats["rss_mb"], tags=full)
            gauges[PROC_CPU_PCT].set(stats["cpu_pct"], tags=full)
            if "open_fds" in stats:
                gauges[PROC_OPEN_FDS].set(stats["open_fds"], tags=full)
            proc_live[tags["worker_id"]] = dict(stats, node=tags["node"],
                                                local=True)
        # retire label series of processes that vanished (Metric.remove —
        # without this the per-worker gauges grow with worker churn)
        for g in gauges.values():
            for labels in g.label_sets():
                if tuple(sorted(labels.items())) not in live_keys:
                    g.remove(labels)
        # local rows replace wholesale; remote rows (shipped by agents)
        # persist until their next report or until they go stale (a dead
        # remote worker stops appearing in its agent's reports — prune by
        # timestamp, or churn accumulates rows forever)
        cutoff = time.time() - self._origin_expiry_s
        with self._proc_lock:
            self._proc_live = {
                **{k: v for k, v in self._proc_live.items()
                   if not v.get("local") and v.get("ts", 0.0) >= cutoff},
                **proc_live,
            }

    # seconds after a worker's first task or constructor before its /proc
    # rows enter the history: its first calls still load the CUDA
    # libraries' kernels lazily (a GPT-2 stage's host RSS grows by ~0.5 GB
    # in its first forward on an H100)
    WORKER_WARMUP_S = 10.0
    # seconds after a worker registers by which its rows enter the history
    # even while its first task still runs: a first task that runs long
    # (a training or ETL loop) gets a trend series all the same
    WORKER_START_BOUND_S = 60.0

    def _history_rows(self, metrics: Dict[str, dict]) -> Dict[str, dict]:
        """``metrics`` as the TSDB keeps it: a worker's ``/proc`` rows
        enter the history only ``WORKER_WARMUP_S`` after its first plain
        task or its actor's constructor has finished, or
        ``WORKER_START_BOUND_S`` after it registered if that comes first,
        so its series starts after its start-up.  A worker imports torch,
        makes its CUDA context and builds its model before then, and
        loads the CUDA libraries' kernels in its first calls, its RSS
        climbing by hundreds of MB to GBs; at a sub-second push those
        samples read as a leak to the doctor's ``rss_growth`` rule
        (ROADMAP C5: an agent's cold start; C12: a pipeline stage's
        constructor and first forward).  The live registry and the top
        view keep every row."""
        from ray_tpu_torch._private.resource_spec import _PROC_METRIC_HELP

        now = time.time()
        keep = {w for w, t in self._history_from.copy().items() if t <= now} | {"head"}
        out = dict(metrics)
        for name in _PROC_METRIC_HELP:
            m = metrics.get(name)
            if m:
                out[name] = dict(m, values={
                    key: v for key, v in m.get("values", {}).items()
                    if dict(key).get("worker_id", "head") in keep})
        return out

    def _fold_resource_report(self, origin: str, metrics: Dict[str, dict]) -> None:
        """Keep the live top-view cache current from a node agent's (or
        any remote sampler's) shipped per-process gauges."""
        from ray_tpu_torch._private.resource_spec import (
            PROC_CPU_PCT,
            PROC_OPEN_FDS,
            PROC_RSS_MB,
        )

        names = {PROC_RSS_MB: "rss_mb", PROC_CPU_PCT: "cpu_pct",
                 PROC_OPEN_FDS: "open_fds"}
        now = time.time()
        with self._proc_lock:
            for name, field in names.items():
                m = metrics.get(name)
                if not m:
                    continue
                for key, value in m.get("values", {}).items():
                    tags = dict(key)
                    wid = tags.get("worker_id") or (
                        f"agent:{tags.get('node', origin)}"
                        if tags.get("entity") == "agent" else None)
                    if wid is None:
                        continue
                    row = self._proc_live.setdefault(
                        wid, {"node": tags.get("node", origin)})
                    row[field] = value
                    row["local"] = False
                    row["ts"] = now

    def refresh_runtime_gauges(self) -> None:
        """Refresh the head's runtime gauges (store/arena occupancy, task
        states, queue depth, owner-pinned bytes...) — shared by the
        TSDB sample loop and ``top``/``perf``, so the merged view and the
        time series always agree (metric_defs.cc analog)."""
        from ray_tpu_torch.util.metrics import Gauge

        g = Gauge("ray_tpu_objects_in_store", "objects tracked by the registry")
        stats = self.registry.stats()
        g.set(stats["num_objects"])
        Gauge("ray_tpu_object_store_bytes", "head-local shm bytes").set(
            stats["bytes_used"])
        Gauge("ray_tpu_objects_spilled", "objects spilled to disk").set(
            stats.get("num_spilled", 0))
        arena = getattr(self, "arena", None)
        if arena is not None:
            try:
                astats = arena.stats()
                Gauge("ray_tpu_arena_bytes_used",
                      "native arena bytes allocated").set(astats["bytes_used"])
                Gauge("ray_tpu_arena_capacity_bytes",
                      "native arena capacity").set(astats["capacity"])
            except Exception:
                pass
        with self.lock:
            n_workers = len([w for w in self.workers.values()
                             if w.state != "dead"])
            n_nodes = len([ns for ns in self.nodes.values() if ns.alive])
            n_pending = (len(self.pending_tasks)
                         + sum(len(q) for q in self._starved.values()))
        Gauge("ray_tpu_num_workers", "live workers").set(n_workers)
        Gauge("ray_tpu_num_nodes", "alive nodes").set(n_nodes)
        Gauge("ray_tpu_sched_queue_depth",
              "tasks pending cluster-wide (not yet staged on a node)").set(
            n_pending)
        for src, n in self.events.counts().items():
            Gauge("ray_tpu_events_recorded",
                  "flight-recorder events held per source").set(
                n, tags={"source": src})
        with self.gcs.lock:
            for state in ("PENDING", "RUNNING", "FINISHED", "FAILED"):
                n = sum(1 for t in self.gcs.tasks.values() if t.state == state)
                Gauge("ray_tpu_tasks", "tasks by state").set(
                    n, tags={"state": state})
        # object-store bytes pinned per owner, from the ownership table —
        # the "who owns these 6 GiB" trend; stale owners' series retire
        audit = self._memory_audit(limit=0)
        g = Gauge("ray_tpu_owner_pinned_bytes",
                  "sealed object-store bytes attributed per owner")
        live = set()
        for row in audit["by_owner"][:50]:
            tags = {"owner": row["owner"], "kind": row["owner_kind"]}
            live.add(tuple(sorted(tags.items())))
            g.set(row["bytes"], tags=tags)
        for labels in g.label_sets():
            if tuple(sorted(labels.items())) not in live:
                g.remove(labels)
        # cluster-wide share of busy samples inside serialization frames —
        # the trend behind doctor's serialization_hot rule
        try:
            Gauge("ray_tpu_profile_serialization_frac",
                  "fraction of sampled busy time spent serializing").set(
                round(self.profile_store.serialization_frac(300.0), 4))
        except Exception:
            pass
        # log-plane ship pressure: cumulative records absorbed + source-
        # side suppression markers (the "are we dropping logs" rates)
        try:
            lc = self.log_store.counters()
            Gauge("ray_tpu_log_records_total",
                  "log records ingested by the head store").set(
                lc["ingested_total"])
            Gauge("ray_tpu_log_suppressed_total",
                  "log records dropped by source-side suppression").set(
                lc["suppressed_total"])
        except Exception:
            pass

    def _profile_ledger(self, window_s: float,
                        tasks: Optional[int] = None) -> dict:
        """The per-task CPU cost ledger over the trailing window: the
        store's duty-cycle class rates joined with the task lane.  Only
        task-path processes enter the sum — the head (which also hosts
        the in-process driver) and the workers; node agents profile too
        but their cycles are not per-task cost.  ``tasks`` defaults to
        the FINISHED delta the TSDB saw over the window (callers that
        counted exactly pass their own)."""
        with self.lock:
            worker_origins = {w.worker_id.hex() for w in self.workers.values()}
        roles = {"head": "head"}
        for row in self.profile_store.stats():
            if row["origin"] in worker_origins:
                roles[row["origin"]] = "worker"
        if tasks is None:
            tasks = 0
            try:
                res = self.tsdb.query(
                    "ray_tpu_tasks", window_s=window_s,
                    tags={"state": "FINISHED"}, agg="max")
                points = [v for s in res.get("series", [])
                          for _, v in s.get("points", []) if v is not None]
                if points:
                    tasks = int(max(points) - min(points))
            except Exception:
                pass
            if not tasks:
                with self.gcs.lock:
                    tasks = sum(1 for t in self.gcs.tasks.values()
                                if t.state == "FINISHED")
        return self.profile_store.cost_ledger(window_s, tasks, roles)

    def _memory_audit(self, limit: int = 200) -> dict:
        """The ``ray memory`` analog: every sealed object's bytes
        attributed to the worker/actor/driver that produced it, with pin
        reasons, ages, and orphan flags (owner process no longer alive).
        ``limit`` caps the per-object rows shipped; ``limit=0`` (the
        every-tick gauge refresh and ``top``) takes the aggregate-only
        registry pass — no per-object row dicts, no sort."""
        with self.lock:
            live_workers = {w.worker_id.hex() for w in self.workers.values()
                            if w.state != "dead"}
            live_actors = {a.info.actor_id.hex() for a in self.actors.values()
                           if a.worker is not None and a.worker.state != "dead"}
        with self.gcs.lock:
            actor_names = {a.actor_id.hex(): a.class_name
                           for a in self.gcs.actors.values()}
            actor_ns = {a.actor_id.hex(): a.namespace
                        for a in self.gcs.actors.values()}
            ns_actors: Dict[str, int] = {}
            for a in self.gcs.actors.values():
                if a.state != "DEAD":
                    ns_actors[a.namespace] = ns_actors.get(a.namespace, 0) + 1
        with self.lock:
            job_ns = {jid: rec["namespace"] for jid, rec in self._jobs.items()}

        def owner_namespace(owner: str, kind: str) -> str:
            """Namespace a sealed owner rolls up under: actors carry
            theirs, driver owners are job ids, pooled workers are shared
            infrastructure (their seals serve whichever tenant's task ran
            last — attributing them to one would lie)."""
            if kind == "actor":
                return actor_ns.get(owner, "default")
            if kind == "driver":
                return job_ns.get(owner, "default")
            return "(shared)"

        def annotate(owner: str, kind: str):
            """(display label, owner process still alive)."""
            if kind == "actor":
                return (f"{actor_names.get(owner, 'actor')}:{owner[:8]}",
                        owner in live_actors)
            if kind == "worker":
                return f"worker:{owner[:8]}", owner in live_workers
            # driver/head seals live exactly as long as the session
            return owner, True

        rows: List[dict] = []
        num_objects = 0
        if limit:
            rows = self.registry.memory_audit()
            num_objects = len(rows)
            owner_aggs: Dict[tuple, dict] = {}
            by_reason: Dict[str, int] = {}
            for r in rows:
                key = (r["owner"], r["owner_kind"])
                agg = owner_aggs.setdefault(key, {"bytes": 0, "objects": 0})
                agg["bytes"] += r["size"] or 0
                agg["objects"] += 1
                by_reason[r["pin_reason"]] = by_reason.get(
                    r["pin_reason"], 0) + (r["size"] or 0)
        else:
            # aggregate-only path: O(owners) read of the incrementally-
            # maintained summary (no table scan under the registry lock
            # on the every-tick gauge refresh); the pin-reason breakdown
            # needs per-object pins and only ships with the rows
            owner_aggs = self.registry.owner_summary()
            by_reason = {}
            num_objects = sum(a["objects"] for a in owner_aggs.values())
        total = attributed = orphan_bytes = 0
        by_owner = []
        for (owner, kind), agg in owner_aggs.items():
            label, alive = annotate(owner, kind)
            total += agg["bytes"]
            if owner != "unknown":
                attributed += agg["bytes"]
            if not alive:
                orphan_bytes += agg["bytes"]
            by_owner.append({
                "owner": owner, "owner_kind": kind, "owner_label": label,
                "bytes": agg["bytes"], "objects": agg["objects"],
                "orphan": not alive,
            })
        by_owner.sort(key=lambda a: -a["bytes"])
        # per-namespace rollup: one row per tenant — pinned bytes, object
        # and actor counts, owning jobs (one tenant's footprint reads off
        # a single row of `ray_tpu_torch top` / `memory`)
        ns_rows: Dict[str, dict] = {}
        for o in by_owner:
            nsn = owner_namespace(o["owner"], o["owner_kind"])
            row = ns_rows.setdefault(nsn, {
                "namespace": nsn, "bytes": 0, "objects": 0,
                "actors": ns_actors.get(nsn, 0), "jobs": 0})
            row["bytes"] += o["bytes"]
            row["objects"] += o["objects"]
            if o["owner_kind"] == "driver":
                row["jobs"] += 1
        for nsn, count in ns_actors.items():
            ns_rows.setdefault(nsn, {
                "namespace": nsn, "bytes": 0, "objects": 0,
                "actors": count, "jobs": 0})
        by_namespace = sorted(ns_rows.values(), key=lambda r: -r["bytes"])
        rows = rows[:limit]  # only shipped rows need per-row annotation
        for r in rows:
            r["owner_label"], alive = annotate(r["owner"], r["owner_kind"])
            r["orphan"] = not alive
        return {
            "ts": time.time(),
            "total_bytes": total,
            "attributed_bytes": attributed,
            "attributed_frac": (attributed / total) if total else 1.0,
            "orphan_bytes": orphan_bytes,
            "num_objects": num_objects,
            "by_owner": by_owner,
            "by_namespace": by_namespace,
            "by_pin_reason": by_reason,
            "rows": rows,
            "store": self.registry.stats(),
        }

    def _top_snapshot(self) -> dict:
        """One frame of ``ray_tpu_torch top``: nodes with live host stats,
        workers/actors with their sampled RSS/CPU/fds and pinned bytes,
        plus store + task-state summaries."""
        from ray_tpu_torch._private.resource_spec import host_stats

        audit = self._memory_audit(limit=0)
        pinned = {a["owner"]: a["bytes"] for a in audit["by_owner"]}
        with self._proc_lock:
            proc_live = dict(self._proc_live)
        with self.lock:
            nodes = [{
                "node_id": ns.node_id, "alive": ns.alive,
                "total": dict(ns.total), "available": dict(ns.available),
                "utilization": round(ns.utilization(), 3),
                "host_stats": ns.host_stats if ns.agent_conn is not None
                else None,
                # only head-local/emulated nodes genuinely share this
                # host: filling a remote node's missing stats (agent yet
                # to pong) with the head's /proc would mislabel them
                "_local_host": ns.agent_conn is None,
            } for ns in self.nodes.values()]
            workers = []
            for wid, w in self.workers.items():
                if w.state == "dead":
                    continue
                hexid = wid.hex()
                stats = proc_live.get(hexid, {})
                workers.append({
                    "worker_id": hexid, "node_id": w.node_id,
                    "pid": w.proc.pid if w.proc else None,
                    "state": w.state,
                    "kind": "actor" if w.is_actor_worker else "worker",
                    "actor_id": w.actor_id.hex() if w.actor_id else None,
                    "rss_mb": stats.get("rss_mb"),
                    "cpu_pct": stats.get("cpu_pct"),
                    "open_fds": stats.get("open_fds"),
                    "pinned_bytes": pinned.get(hexid)
                    or (pinned.get(w.actor_id.hex()) if w.actor_id else 0)
                    or 0,
                })
        with self.gcs.lock:
            actor_names = {a.actor_id.hex(): a.class_name
                           for a in self.gcs.actors.values()}
            task_states: Dict[str, int] = {}
            for t in self.gcs.tasks.values():
                task_states[t.state] = task_states.get(t.state, 0) + 1
        for w in workers:
            if w["actor_id"]:
                w["actor_class"] = actor_names.get(w["actor_id"])
        head_stats = proc_live.get("head", {})
        for n in nodes:
            if n.pop("_local_host") and n["host_stats"] is None \
                    and n["alive"]:
                n["host_stats"] = host_stats()
        return {
            "ts": time.time(),
            "nodes": nodes,
            "workers": workers,
            "head": head_stats,
            "tasks": task_states,
            "store": audit["store"],
            "owners": audit["by_owner"][:20],
            "namespaces": audit["by_namespace"][:20],
            "total_pinned_bytes": audit["total_bytes"],
            "orphan_bytes": audit["orphan_bytes"],
            "tsdb": self.tsdb.stats(),
            # device-memory watermark rows (util/perf.py gauges pushed
            # by train workers / serve engines; host-RSS kind on CPU)
            "hbm": self._hbm_rows(),
        }

    def _merged_metrics_snapshot(self) -> dict:
        """Head registry + worker-pushed registries, one snapshot (what
        perf/top aggregate over)."""
        from ray_tpu_torch.util import metrics as metrics_mod

        return metrics_mod.merge_snapshots(
            metrics_mod.registry().snapshot(),
            self.worker_metrics_registry.snapshot())

    def _hbm_rows(self, merged: Optional[dict] = None) -> List[dict]:
        """Device-memory gauge rows from the merged registry: one row
        per (device, kind, origin) with in-use/limit/peak joined."""
        if merged is None:
            merged = self._merged_metrics_snapshot()
        rows: Dict[tuple, dict] = {}
        for name, field in (("ray_tpu_hbm_bytes_in_use", "bytes_in_use"),
                            ("ray_tpu_hbm_bytes_limit", "bytes_limit"),
                            ("ray_tpu_hbm_peak_bytes_in_use",
                             "peak_bytes_in_use")):
            m = merged.get(name)
            if not m:
                continue
            for key, v in m.get("values", {}).items():
                if not isinstance(v, (int, float)):
                    continue
                row = rows.setdefault(tuple(key), {"tags": dict(key)})
                row[field] = v
        return [rows[k] for k in sorted(rows)]

    @staticmethod
    def _merged_histogram_summary(merged: dict, name: str) -> Optional[dict]:
        """Count/mean + bucket-estimated p50/p99 for one merged-registry
        histogram, label series with identical bounds folded together
        (percentiles from cumulative bucket edges — coarse but honest:
        the estimate is an upper bound at bucket resolution, and a
        percentile whose mass lands in the +inf overflow bucket reports
        None rather than clamping to the last bound, which would be a
        FALSE upper bound on exactly the tail this layer explains;
        ``last_bound`` lets renderers say "> last_bound")."""
        m = merged.get(name)
        if not m or m.get("type") != "histogram":
            return None
        bounds: Optional[list] = None
        agg: Optional[list] = None
        total = 0
        total_sum = 0.0
        for v in m.get("values", {}).values():
            if not isinstance(v, dict):
                continue
            b = list(v.get("buckets") or [])
            vb = list(v.get("bounds") or [])
            if bounds is None:
                bounds, agg = vb, [0] * len(b)
            if vb != bounds or len(b) != len(agg):
                continue  # foreign bounds: skip rather than mis-fold
            agg = [a + x for a, x in zip(agg, b)]
            total += int(v.get("count") or 0)
            total_sum += float(v.get("sum") or 0.0)
        if not total or not bounds:
            return None

        def pct(q: float):
            target = q * total
            acc = 0
            for i, c in enumerate(agg):
                acc += c
                if acc >= target:
                    return bounds[i] if i < len(bounds) else None
            return None

        return {"count": total, "mean_s": round(total_sum / total, 6),
                "p50_est_s": pct(0.5), "p99_est_s": pct(0.99),
                "last_bound_s": bounds[-1]}

    def _perf_summary(self, window_s: float = 1800.0) -> dict:
        """Head-side aggregate behind ``ray_tpu_torch perf``:
        the step-phase breakdown + compile table folded from the
        ``perf`` event source (cluster table + the head's own ring), the
        MFU trend from the TSDB, HBM watermarks and decode TTFT/ITL
        histograms from the merged registry, and each serve engine's
        latest prefill-interference meter state."""
        rows = self._list_state("events", 100_000, {"source": "perf"})
        steps = 0
        wall = 0.0
        tokens = 0
        phase_totals: Dict[str, float] = {}
        last_mfu: Dict[str, float] = {}
        compiles: Dict[tuple, dict] = {}
        interference: Dict[str, dict] = {}
        for r in rows:
            d = r.get("data") or {}
            msg = r.get("message")
            if msg == "step phases":
                steps += 1
                wall += float(d.get("wall_s") or r.get("span_dur") or 0.0)
                tokens += int(d.get("tokens") or 0)
                for k, v in (d.get("phases") or {}).items():
                    phase_totals[k] = phase_totals.get(k, 0.0) + float(v)
                if d.get("mfu") is not None:
                    # origin-qualified: two gangs both have a rank0, and
                    # bare entity ids would show one job's MFU as the
                    # other's
                    who = (f"{r.get('origin') or 'head'}:"
                           f"{r.get('entity_id')}")
                    last_mfu[who] = float(d["mfu"])
            elif msg == "jit compile":
                key = (str(r.get("origin") or "head"), str(d.get("fn", "?")))
                e = compiles.setdefault(key, {
                    "origin": key[0], "fn": key[1], "compiles": 0,
                    "compile_s": 0.0, "n_sigs": 0, "hits": 0, "misses": 0})
                e["compiles"] += 1
                e["compile_s"] += float(r.get("span_dur") or 0.0)
                # hits/misses/n_sigs ride every compile event cumulatively
                e["n_sigs"] = max(e["n_sigs"], int(d.get("n_sigs") or 0))
                e["hits"] = max(e["hits"], int(d.get("hits") or 0))
                e["misses"] = max(e["misses"], int(d.get("misses") or 0))
            elif msg == "prefill interference":
                eid = f"{r.get('origin') or 'head'}:{r.get('entity_id')}"
                prev = interference.get(eid)
                if prev is None or float(r.get("ts") or 0.0) >= float(
                        prev.get("ts") or 0.0):
                    interference[eid] = r
        merged = self._merged_metrics_snapshot()

        def counter_by_origin_fn(name: str) -> Dict[tuple, float]:
            out: Dict[tuple, float] = {}
            for key, v in (merged.get(name) or {}).get("values",
                                                       {}).items():
                if isinstance(v, (int, float)):
                    d = dict(key)
                    out[(d.get("origin", "head"), d.get("fn", "?"))] = v
            return out

        # hit/miss counts ride compile EVENTS only at compile time — a
        # steady-state fn that compiled once then served 100k hits would
        # read hits≈0 forever off events alone.  The live registry
        # counters keep counting, so they win where present.
        live_hits = counter_by_origin_fn("ray_tpu_jit_cache_hits_total")
        live_misses = counter_by_origin_fn("ray_tpu_jit_cache_misses_total")
        for key, e in compiles.items():
            if key in live_hits:
                e["hits"] = int(live_hits[key])
            if key in live_misses:
                e["misses"] = int(live_misses[key])
        try:
            mfu_series = self.tsdb.query(
                "ray_tpu_train_step_mfu", window_s=window_s).get("series", [])
        except Exception:
            mfu_series = []
        phases_out = {
            k: {"s": round(v, 6),
                "frac": round(v / wall, 4) if wall > 0 else 0.0}
            for k, v in sorted(phase_totals.items(), key=lambda kv: -kv[1])}
        for e in compiles.values():
            e["compile_s"] = round(e["compile_s"], 6)
        return {
            "ts": time.time(),
            "window_s": window_s,
            "steps": {"count": steps, "wall_s": round(wall, 6),
                      "tokens": tokens, "phases": phases_out,
                      "last_mfu": last_mfu},
            "mfu_trend": mfu_series,
            "compiles": sorted(compiles.values(),
                               key=lambda e: -e["compile_s"]),
            "hbm": self._hbm_rows(merged),
            "decode": {
                "ttft": self._merged_histogram_summary(
                    merged, "ray_tpu_llm_ttft_s"),
                "itl": self._merged_histogram_summary(
                    merged, "ray_tpu_llm_itl_s"),
                "interference": {eid: dict(r.get("data") or {})
                                 for eid, r in sorted(interference.items())},
            },
        }

    def _doctor_report(self, trend_window_s: float = 1800.0) -> List[dict]:
        """Head-side doctor pass over head-local tables — what the
        ``doctor_report`` RPC serves so `ray_tpu_torch doctor` never pulls
        100k event/task rows to the client per invocation."""
        from ray_tpu_torch.util import doctor as doctor_mod

        try:
            tasks, _total = self._list_state_page("tasks", 5000)
        except Exception:
            tasks = []
        return doctor_mod.head_report(
            self.events, self._session_ring, self.tsdb, tasks=tasks,
            trend_window_s=trend_window_s)

    def _state_snapshot(self) -> dict:
        snap = self.gcs.snapshot()
        snap["object_store"] = self.registry.stats()
        snap["dashboard"] = (
            list(self.dashboard.address) if self.dashboard else None)
        with self.lock:
            snap["cluster_resources"] = {
                nid: dict(ns.total) for nid, ns in self.nodes.items() if ns.alive
            }
            snap["available_resources"] = {
                nid: dict(ns.available) for nid, ns in self.nodes.items() if ns.alive
            }
        return snap

    # ------------------------------------------------------------------
    # shutdown
    # ------------------------------------------------------------------
    def shutdown(self) -> None:
        self._shutdown = True
        self._tsdb_stop.set()
        if self._head_profiler is not None:
            try:
                self._head_profiler.stop()
            except Exception:
                pass
        if self.watchdog is not None:
            try:
                self.watchdog.stop()
            except Exception:
                pass
        if self._log_monitor is not None:
            try:
                self._log_monitor.stop()  # final drain into the store
            except Exception:
                pass
        if self._head_log_handler is not None:
            import logging as _logging

            try:
                _logging.getLogger("ray_tpu_torch").removeHandler(
                    self._head_log_handler)
                self._head_log_handler.close()
            except Exception:
                pass
        try:
            self._dump_head_events()  # final increment of the crash trail
        except Exception:
            pass
        if self._forkserver is not None:
            self._forkserver.close()
        try:
            self._pub_queue.put(None)  # end the publisher thread
        except Exception:
            pass
        with self.lock:
            workers = list(self.workers.values())
        for w in workers:
            if w.conn is not None:
                try:
                    w.send({"type": "exit"})
                except Exception:
                    pass
        deadline = time.time() + 2.0
        for w in workers:
            if w.proc is not None:
                try:
                    w.proc.wait(timeout=max(0.05, deadline - time.time()))
                except Exception:
                    try:
                        w.proc.kill()
                    except Exception:
                        pass
        with self.lock:
            agents = [ns for ns in self.nodes.values() if ns.agent_conn is not None]
        for ns in agents:
            try:
                ns.agent_send({"type": "shutdown"})
            except Exception:
                pass
        from ray_tpu_torch._private.netutil import (
            force_close_connection,
            unblock_listener,
        )

        # wake the accept loops (close alone leaves accept(2) parked) and
        # every reader thread (their peers also see EOF promptly)
        unblock_listener(self._listener)
        unblock_listener(self._tcp_listener)
        with self.lock:
            conns = list(self._live_conns)
            self._live_conns.clear()
        for conn in conns:
            force_close_connection(conn)
        try:
            if self.dashboard is not None:
                self.dashboard.close()
        except Exception:
            pass
        try:
            self.job_manager.shutdown()
        except Exception:
            pass
        try:
            self.object_server.close()
        except Exception:
            pass
        from ray_tpu_torch._private import object_transfer

        object_transfer.reset()
        if self.gcs_store is not None:
            with self._gcs_flush_lock:
                try:
                    self.gcs.flush(self.gcs_store)
                    self.gcs_store.close()
                except Exception:
                    pass
        self.registry.shutdown()
        if self.arena is not None:
            from ray_tpu_torch._private import object_store as ostore_mod

            ostore_mod.set_owned_arena(None)
            try:
                self.arena.close(unlink=True)
            except Exception:
                pass
        from ray_tpu_torch._private import shm as shm_mod
        from ray_tpu_torch._private import usage

        with self.gcs.lock:
            usage.record_set("tasks_total", len(self.gcs.tasks))
            usage.record_set("actors_total", len(self.gcs.actors))
            usage.record_set("nodes_total", len(self.gcs.nodes))
        # fold in features recorded by worker/driver processes via KV
        for key in self.gcs.kv_keys("usage"):
            usage.record_feature(key.decode(errors="replace"))
        usage.write_report(self.session_dir)
        shm_mod.remove_session_marker(self.session_id)
