"""The port's core API: ``init``, ``shutdown``, ``remote``, ``get``,
``put``, ``wait``, ``kill``, ``get_actor`` and the rest of ``ray_tpu``'s
top level, over the port's own copy of the runtime (``_private/``), with
the **GPU as a first-class resource** (``num_gpus=``) where the JAX
package has TPU chips.

``ray_tpu_torch/__init__.py`` loads this module on first use of one of
its names, so ``import ray_tpu_torch`` starts nothing.  The port's
runtime keeps its own session directory (``$TMPDIR/ray_tpu_torch``),
``/dev/shm`` prefix (``rtpt``) and ``RAY_TPU_TORCH_*`` environment
variables, so it never meets the JAX package's runtime on one machine.
"""

from __future__ import annotations

import atexit
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import log_plane as _log_plane
from ray_tpu_torch._private.object_ref import ObjectRef, ObjectRefGenerator
from ray_tpu_torch._private.worker import global_worker
from ray_tpu_torch.actor import ActorClass, ActorHandle, get_actor
from ray_tpu_torch.remote_function import RemoteFunction
from ray_tpu_torch.runtime_context import get_runtime_context

__version__ = "0.1.0"

_init_lock = threading.Lock()


def init(
    address: Optional[str] = None,
    num_cpus: Optional[int] = None,
    num_gpus: Optional[int] = None,
    resources: Optional[Dict[str, float]] = None,
    ignore_reinit_error: bool = True,
    namespace: Optional[str] = None,
    _authkey: Optional[bytes] = None,
    _gcs_persistence_path: Optional[str] = None,
    **_kwargs,
) -> None:
    """Start (or join) a cluster and connect as the driver.

    With no ``address``, boots the head runtime in this process — the
    ``ray.init`` head-node path (reference ``worker.py:1031`` →
    ``node.py:1083 start_ray_processes``): GCS/raylet/object directory run
    as threads of the driver process, workers spawn on demand.

    With ``address="tcp://host:port"`` (or ``"auto"`` to read the session
    file a running head wrote), joins an existing cluster as an external
    driver — the ``ray.init(address=...)`` path.  The authkey comes from
    ``$RAY_TPU_TORCH_AUTHKEY`` unless passed.

    With ``address="client://host:port"`` joins as a thin client (Ray
    Client analog): a process that shares no shared memory with the
    cluster, whose object payloads ride the control socket both ways.
    With ``address="ray_tpu_torch://host:port"`` connects through the
    multi-tenant client proxy (``ray_tpu_torch.util.client``): the proxy
    spawns an isolated driver subprocess for this connection, and named
    actors default to this tenant's own ``namespace`` (its job id unless
    given).  ``namespace`` scopes named-actor registration and lookup in
    every mode.

    ``_gcs_persistence_path`` (a head started here) keeps the head's
    tables in that SQLite file, flushed every 2 s and at shutdown; a head
    started over an existing file replays it first: its KV back, the old
    head's actors DEAD ("head restarted"), its unfinished tasks FAILED,
    its placement groups REMOVED (``_private/gcs.py`` ``replay``).

    ``num_gpus`` defaults to the cards this process can see
    (``_private/resource_spec.py`` ``autodetect_gpus``: ``nvidia-smi -L``
    under ``CUDA_VISIBLE_DEVICES``); the head never creates a CUDA
    context of its own.
    """
    import json
    import os

    from ray_tpu_torch._private import events as _events
    from ray_tpu_torch._private import object_transfer
    from ray_tpu_torch._private import shm as _shm
    from ray_tpu_torch._private.client import CoreClient
    from ray_tpu_torch._private.config import session_root
    from ray_tpu_torch._private.node import Node

    # every import above, not under ``_init_lock``: an import takes the
    # interpreter's import lock, which must never nest inside ours
    # (raylint R4)
    if address is None and os.environ.get("RAY_TPU_TORCH_ADDRESS", "").startswith("tcp://"):
        # submitted jobs join the cluster that launched them (the
        # reference's $RAY_ADDRESS behavior)
        address = os.environ["RAY_TPU_TORCH_ADDRESS"]
    with _init_lock:
        if global_worker.connected:
            if ignore_reinit_error:
                return
            raise RuntimeError("ray_tpu_torch.init() called twice")
        thin = False
        proxied = False
        if address is not None:
            thin = address.startswith("client://")
            if thin:
                # Ray Client analog (reference ``ray.init("ray://...")``,
                # util/client/ARCHITECTURE.md): a remote process that shares
                # no shm with the cluster; object payloads ride the control
                # socket both ways, everything else is already socket-based
                address = "tcp://" + address[len("client://"):]
            elif address.startswith("ray_tpu_torch://"):
                # multi-tenant proxy mode: thin-client object paths over a
                # per-connection isolated driver the proxy owns
                proxied = thin = True
                address = "tcp://" + address[len("ray_tpu_torch://"):]
            if address == "auto":
                with open(os.path.join(session_root(), "last_session.json")) as f:
                    sess = json.load(f)
                address = sess["address"]
                authkey = bytes.fromhex(sess["authkey"])
                if sess.get("session_id"):
                    # adopt the head's shm namespace so this driver's puts
                    # live (and are swept) with the session they belong to
                    os.environ[_shm._SESSION_ENV] = sess["session_id"]
            else:
                authkey = _authkey or bytes.fromhex(os.environ["RAY_TPU_TORCH_AUTHKEY"])
            object_transfer.configure(authkey)
            node = None
            client = CoreClient(address, authkey,
                                proxy_namespace=namespace, proxy=proxied)
            if not thin and _shm._SESSION_ENV not in os.environ:
                # adopt the head's shm namespace so this driver's puts are
                # swept with the session they belong to
                try:
                    sess_id = client.request({"type": "whoami"}, timeout=30)["value"]
                    os.environ[_shm._SESSION_ENV] = sess_id["session_id"]
                except Exception:
                    pass
        else:
            node = Node(num_cpus=num_cpus, num_gpus=num_gpus, resources=resources,
                        gcs_persistence_path=_gcs_persistence_path)
            client = CoreClient(node.address, node.authkey)
        ident = client.register_client(namespace=namespace)
        global_worker.mode = "driver"
        global_worker.thin_client = thin
        global_worker.job_id = ident.get("job_id")
        global_worker.namespace = ident.get("namespace") or namespace or "default"
        global_worker.node = node
        global_worker.client = client
        global_worker.node_id = node._head_node_id if node else "node-head"
        # driver log streaming (reference: print_to_stdstream over GCS
        # pubsub): subscribe to this job's shipped log records and
        # re-emit them prefixed "(name pid=… node=…)".  RAY_TPU_TORCH_LOG_TO_DRIVER=0
        # turns the re-emission off.
        if (global_worker.job_id
                and os.environ.get("RAY_TPU_TORCH_LOG_TO_DRIVER", "1") != "0"):
            if _log_plane.enabled():
                try:
                    client.subscribe(f"logs:{global_worker.job_id}",
                                     _log_plane.make_driver_log_callback())
                except Exception:
                    pass  # log streaming is best-effort, never boot-fatal
        if node is None:
            # external driver: its flight-recorder events (streaming pump,
            # serve router) ship to the head like a worker's do.  The
            # in-process head path needs no pusher — driver emits land in
            # the head's own ring.
            origin = (f"tenant-{global_worker.job_id}" if proxied
                      else f"driver-{os.getpid()}")
            global_worker._events_pusher = _events.EventsPusher(
                client.send, origin=origin,
                closed_fn=lambda: client.closed).start()
        atexit.register(shutdown)


def is_initialized() -> bool:
    return global_worker.connected


def shutdown() -> None:
    with _init_lock:
        if not global_worker.connected:
            return
        if global_worker.node is not None:
            # the in-process driver's own disconnect must not run a tenant
            # reap against the head it is about to tear down
            global_worker.node._reap_on_disconnect = False
        pusher = getattr(global_worker, "_events_pusher", None)
        if pusher is not None:
            try:
                pusher.stop()  # final event ship while the socket is live
            except Exception:
                pass
            global_worker._events_pusher = None
        try:
            # a driver that leaves on purpose says so first: the head then
            # records its disconnect as a clean exit, not a tenant death
            # (the same frame reaches the head through the proxy's splice)
            global_worker.client.send({"type": "client_leaving"})
        except Exception:
            pass
        try:
            global_worker.client.close()
        except Exception:
            pass
        if global_worker.node is not None:
            global_worker.node.shutdown()
        global_worker.client = None
        global_worker.node = None
        global_worker.mode = None
        global_worker.thin_client = False
        global_worker.job_id = None
        global_worker.namespace = None
        global_worker.function_cache.clear()
        global_worker.registered_fn_ids.clear()
        # uploaded packages live in this head's KV (or its store's)
        global_worker._prepared_envs.clear()


def remote(*args, **kwargs):
    """``@remote`` decorator for tasks and actors (``ray.remote`` analog).

    Supports ``@remote``, ``@remote(num_cpus=..., num_gpus=..., ...)`` on
    functions and classes.
    """
    if len(args) == 1 and not kwargs and (callable(args[0]) or isinstance(args[0], type)):
        return _make_remote(args[0], {})
    if args:
        raise TypeError("@remote takes keyword options only, e.g. @remote(num_gpus=1)")

    def decorator(fn_or_cls):
        return _make_remote(fn_or_cls, kwargs)

    return decorator


def _make_remote(fn_or_cls, options):
    if isinstance(fn_or_cls, type):
        return ActorClass(fn_or_cls, options)
    return RemoteFunction(fn_or_cls, options)


def put(value: Any) -> ObjectRef:
    _ensure_connected()
    return global_worker.put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]], *, timeout: Optional[float] = None):
    _ensure_connected()
    if isinstance(refs, ObjectRef):
        return global_worker.get([refs], timeout=timeout)[0]
    # A CompiledDAGRef can only exist if dag.compiled is already imported,
    # so a sys.modules probe keeps get() import-free for every process
    # that never compiles a graph (the dag package's lazy-load contract).
    import sys as _sys

    compiled_mod = _sys.modules.get("ray_tpu_torch.dag.compiled")
    CompiledDAGRef = (compiled_mod.CompiledDAGRef if compiled_mod is not None
                      else None)
    if CompiledDAGRef is not None and isinstance(refs, CompiledDAGRef):
        # compiled-graph results read their pre-allocated output channel
        # directly — no object plane involved (dag/compiled.py)
        return refs.get(timeout=timeout)
    if not isinstance(refs, (list, tuple)):
        raise TypeError(f"get() takes an ObjectRef or a list of them, got {type(refs)}")
    if CompiledDAGRef is not None and any(
            isinstance(r, CompiledDAGRef) for r in refs):
        import time as _time

        for r in refs:
            if not isinstance(r, (ObjectRef, CompiledDAGRef)):
                raise TypeError(
                    f"get() list elements must be ObjectRefs or "
                    f"CompiledDAGRefs, got {type(r)}")
        # one overall deadline across the list, matching the pure-
        # ObjectRef path's timeout semantics; the ObjectRef elements still
        # fetch as ONE batched call (a single CompiledDAGRef must not
        # degrade a 1000-ref get into 1000 head round trips)
        deadline = None if timeout is None else _time.monotonic() + timeout
        plain = [r for r in refs if isinstance(r, ObjectRef)]
        values: dict = {}
        if plain:
            fetched = global_worker.get(plain, timeout=timeout)
            values = {id(r): v for r, v in zip(plain, fetched)}
        out = []
        for r in refs:
            if isinstance(r, ObjectRef):
                out.append(values[id(r)])
            else:
                remaining = (None if deadline is None
                             else max(0.0, deadline - _time.monotonic()))
                out.append(r.get(timeout=remaining))
        return out
    for r in refs:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() list elements must be ObjectRefs, got {type(r)}")
    return global_worker.get(list(refs), timeout=timeout)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    _ensure_connected()
    if num_returns > len(refs):
        raise ValueError("num_returns cannot exceed the number of refs")
    return global_worker.wait(list(refs), num_returns, timeout)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    _ensure_connected()
    global_worker.client.kill_actor(actor._actor_id, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True) -> None:
    """Cancel the task that produces ``ref`` (reference
    ``python/ray/_private/worker.py:2573``).

    Queued tasks are dequeued; running tasks get a KeyboardInterrupt
    (``force=True`` SIGKILLs the worker instead — not allowed for actor
    tasks); finished tasks are untouched.  ``recursive`` also cancels
    tasks the cancelled task submitted.  Cancelled returns raise
    :class:`ray_tpu_torch.exceptions.TaskCancelledError` on ``get``."""
    _ensure_connected()
    if not isinstance(ref, ObjectRef):
        raise TypeError(f"cancel() expects an ObjectRef, got {type(ref)}")
    global_worker.client.cancel_task(ref.binary(), force=force,
                                     recursive=recursive)


def cluster_resources() -> Dict[str, float]:
    _ensure_connected()
    snap = global_worker.client.state_snapshot()
    totals: Dict[str, float] = {}
    for res in snap["cluster_resources"].values():
        for k, v in res.items():
            totals[k] = totals.get(k, 0.0) + v
    return totals


def available_resources() -> Dict[str, float]:
    _ensure_connected()
    snap = global_worker.client.state_snapshot()
    totals: Dict[str, float] = {}
    for res in snap["available_resources"].values():
        for k, v in res.items():
            totals[k] = totals.get(k, 0.0) + v
    return totals


def nodes() -> List[dict]:
    _ensure_connected()
    snap = global_worker.client.state_snapshot()
    return [
        {"NodeID": n.node_id, "Alive": n.alive, "Resources": n.resources}
        for n in snap["nodes"]
    ]


def _ensure_connected() -> None:
    if not global_worker.connected:
        import threading

        if threading.current_thread() is not threading.main_thread():
            # a BACKGROUND thread (e.g. a stale poller from a torn-down
            # session) must never silently boot a fresh default head: that
            # zombie session would absorb every later init() in the process
            raise RuntimeError(
                "ray_tpu_torch is not initialized (auto-init only runs on the "
                "main thread)")
        init()


# Convenience re-exports matching the reference's layout.
from ray_tpu_torch.util.placement_group import (  # noqa: E402
    placement_group,
    remove_placement_group,
)

__all__ = [
    "ObjectRef",
    "ActorClass",
    "ActorHandle",
    "RemoteFunction",
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "put",
    "get",
    "wait",
    "kill",
    "get_actor",
    "get_runtime_context",
    "cluster_resources",
    "available_resources",
    "nodes",
    "placement_group",
    "remove_placement_group",
    "exceptions",
]
