"""Worker/driver runtime: the process-local half of the core API.

Combines the roles of the reference's Python worker
(``python/ray/_private/worker.py`` — global ``Worker`` singleton, ``init``,
``get/put/wait``) and the Cython task-execution callback
(``python/ray/_raylet.pyx:680`` ``execute_task``): argument resolution,
function-table fetch on miss (``FunctionActorManager``,
``python/ray/_private/function_manager.py:56``), running the user function,
and storing returns.  Also builds task specs (TaskSpecBuilder analog,
``src/ray/common/task/task_spec.h``).
"""

from __future__ import annotations

import asyncio
import hashlib
import inspect
import os
import queue
import sys
import threading
import time
import traceback
import weakref
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle

from ray_tpu_torch._private import events as _events
from ray_tpu_torch._private import log_plane
from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.client import CoreClient
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.object_ref import ObjectRef, new_id
from ray_tpu_torch._private.object_store import ObjectLocation, read_value, store_value

FN_NAMESPACE = "fn"

# per-execution tenant identity (see Worker.current_job_id): contextvars
# so the value follows the executing thread OR asyncio task, never leaks
# between a threaded actor's concurrent methods or interleaved coroutines
import contextvars  # noqa: E402

_job_ctx: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar(
    "ray_tpu_current_job", default=None)
_ns_ctx: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar(
    "ray_tpu_current_namespace", default=None)


class _ArgPlaceholder:
    """Marks a top-level ObjectRef argument resolved by the head before dispatch."""

    __slots__ = ("oid",)

    def __init__(self, oid: bytes):
        self.oid = oid

    def __reduce__(self):
        return (_ArgPlaceholder, (self.oid,))


class Worker:
    """Process-global runtime state (driver or worker mode)."""

    def __init__(self):
        self.mode: Optional[str] = None  # "driver" | "worker"
        self.client: Optional[CoreClient] = None
        self.node: Optional["Node"] = None  # driver only: in-process head
        self.node_id: str = ""
        self.worker_id: bytes = b""
        # thin-client mode (ray_tpu_torch.init("client://...") — Ray Client
        # analog): this process shares no shm with the cluster, so object
        # payloads ride the control socket both ways
        self.thin_client: bool = False
        self.function_cache: Dict[bytes, Any] = {}
        self.registered_fn_ids: set = set()
        # runtime_env package uploads are once per unique env per driver
        # session (content addressing dedups across drivers at the KV)
        self._prepared_envs: Dict[str, dict] = {}
        self._current_task_id: Optional[bytes] = None
        self._current_actor_id: Optional[bytes] = None
        self.actor_instance: Any = None
        # tenant identity: for drivers, assigned at register_client; for
        # workers, inherited per-task from the executing spec (actor
        # workers pin theirs at creation).  get_runtime_context() and
        # namespace-scoped get_actor read these.  The per-task half
        # lives in CONTEXTVARS (module-level _job_ctx/_ns_ctx): threaded
        # actors run methods from different submitters concurrently, and
        # async methods hop to the event-loop thread — contextvars track
        # the executing thread AND the asyncio task, so one method never
        # reads another's tenant.
        self.job_id: Optional[str] = None
        self.namespace: Optional[str] = None
        # per-thread: threaded actors run several methods at once, and each
        # thread's nested-get blocked/unblocked notifications must pair up
        self._depth_local = threading.local()
        # local handle counts per oid; the head is told when this process's
        # first handle appears (borrow) and when its last one dies
        self._ref_counts: Dict[bytes, int] = {}
        self._ref_lock = threading.Lock()
        # Finalizers only ever append here — a deque append is atomic,
        # allocates without taking our lock, and is reentrancy-safe, so a
        # GC pass firing a finalizer mid-track_ref can't self-deadlock
        # (the reference's ReferenceCounter defers finalizer work the same
        # way).  Drained by flush_removals on client calls + a 1s timer.
        self._dead_handles: "deque[bytes]" = deque()
        self._flusher_started = False

    # task/actor identity are properties so EVERY set site invalidates
    # the log plane's per-thread stamp cache (print()-path lines carry
    # the live context without re-deriving it per line)
    @property
    def current_task_id(self) -> Optional[bytes]:
        return self._current_task_id

    @current_task_id.setter
    def current_task_id(self, value: Optional[bytes]) -> None:
        self._current_task_id = value
        log_plane.bump_context_epoch()

    @property
    def current_actor_id(self) -> Optional[bytes]:
        return self._current_actor_id

    @current_actor_id.setter
    def current_actor_id(self, value: Optional[bytes]) -> None:
        self._current_actor_id = value
        log_plane.bump_context_epoch()

    @property
    def current_job_id(self) -> Optional[str]:
        return _job_ctx.get()

    @current_job_id.setter
    def current_job_id(self, value: Optional[str]) -> None:
        _job_ctx.set(value)
        log_plane.bump_context_epoch()

    @property
    def current_namespace(self) -> Optional[str]:
        return _ns_ctx.get()

    @current_namespace.setter
    def current_namespace(self, value: Optional[str]) -> None:
        _ns_ctx.set(value)

    @property
    def task_depth(self) -> int:
        return getattr(self._depth_local, "depth", 0)

    @task_depth.setter
    def task_depth(self, value: int) -> None:
        self._depth_local.depth = value

    # ------------------------------------------------------------------
    # reference tracking (client half of ReferenceCounter)
    # ------------------------------------------------------------------
    def track_ref(self, ref: ObjectRef, *, owned: bool) -> ObjectRef:
        """Register a live handle.  ``owned=True`` for refs whose head-side
        entry was created on this process's behalf with an initial count
        (put / task returns); ``owned=False`` for deserialized borrows,
        which add_ref immediately (the enclosing container's pin is still
        held, so the increment can't race the object's deletion)."""
        oid = ref.binary()
        announce = False
        with self._ref_lock:
            n = self._ref_counts.get(oid, 0)
            self._ref_counts[oid] = n + 1
            if n == 0 and not owned:
                announce = True
        if announce and self.client is not None and not self.client.closed:
            try:
                self.client.add_refs([oid])
            except Exception:
                pass
        weakref.finalize(ref, self._dead_handles.append, oid)
        self._ensure_flusher()
        return ref

    def _ensure_flusher(self) -> None:
        if self._flusher_started:
            return
        self._flusher_started = True

        def loop():
            while True:
                time.sleep(1.0)
                if self.client is None or self.client.closed:
                    continue
                try:
                    self.flush_removals()
                except Exception:
                    pass

        threading.Thread(target=loop, daemon=True, name="ref-flusher").start()

    def flush_removals(self) -> None:
        """Drain finalizer notifications: decrement local counts, tell the
        head about handles whose last local copy died."""
        removals: List[bytes] = []
        with self._ref_lock:
            while True:
                try:
                    oid = self._dead_handles.popleft()
                except IndexError:
                    break
                n = self._ref_counts.get(oid, 0) - 1
                if n > 0:
                    self._ref_counts[oid] = n
                else:
                    self._ref_counts.pop(oid, None)
                    removals.append(oid)
        if removals and self.client is not None and not self.client.closed:
            try:
                self.client.remove_refs(removals)
            except Exception:
                pass

    @property
    def connected(self) -> bool:
        return self.client is not None

    # ------------------------------------------------------------------
    # objects
    # ------------------------------------------------------------------
    def put(self, value: Any) -> ObjectRef:
        self.flush_removals()
        ref = ObjectRef.random()
        if self.thin_client:
            self._put_blob(ref, value)
        else:
            loc, contained = store_value(ref, value)
            self.client.seal(ref.binary(), loc, [r.binary() for r in contained])
        return self.track_ref(ref, owned=True)

    def _put_blob(self, ref: ObjectRef, value: Any,
                  track_contained: bool = True) -> None:
        """Thin-client put: ship serialized bytes; the head stores them."""
        meta, buffers, contained = serialization.serialize(value)
        reply = self.client.request({
            "type": "put_blob",
            "oid": ref.binary(),
            "blob": serialization.to_bytes(meta, buffers),
            # big-args specs track their refs via pinned_refs instead
            "contained": [r.binary() for r in contained] if track_contained else [],
        }, timeout=300)["value"]
        if isinstance(reply, dict) and reply.get("error"):
            raise RuntimeError(reply["error"])

    def _get_blobs(self, oids: List[bytes], timeout: Optional[float]) -> List[Any]:
        """Thin-client get: the head ships each payload over the socket.
        One shared deadline across the batch (fat-client get semantics);
        fetches run concurrently over the req_id-multiplexed connection."""
        from concurrent.futures import ThreadPoolExecutor

        from ray_tpu_torch.exceptions import GetTimeoutError

        deadline = None if timeout is None else time.monotonic() + timeout

        def fetch(oid: bytes):
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise GetTimeoutError(f"Get timed out after {timeout}s")
            reply = self.client.request(
                {"type": "get_blob", "oid": oid, "timeout": remaining},
                timeout=None if remaining is None else remaining + 30,
            )["value"]
            if reply.get("timeout"):
                raise GetTimeoutError(f"Get timed out after {timeout}s")
            if reply.get("error"):
                raise RuntimeError(reply["error"])
            value = serialization.deserialize(memoryview(reply["blob"]))
            return value, bool(reply.get("is_error"))

        unique = list(dict.fromkeys(oids))
        if len(unique) == 1:
            results = [fetch(unique[0])]
        else:
            with ThreadPoolExecutor(min(8, len(unique))) as ex:
                results = list(ex.map(fetch, unique))
        values: Dict[bytes, Any] = {}
        for oid, (value, is_error) in zip(unique, results):
            if is_error:
                raise value
            values[oid] = value
        return [values[oid] for oid in oids]

    def get(self, refs: List[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        # traced callers get a get_wait span (object availability + transfer
        # is a first-class phase of a request's critical path); untraced or
        # events-off callers pay one flag check
        trace_ctx = None
        if _events.ENABLED:
            from ray_tpu_torch.util import tracing

            trace_ctx = tracing.current_context()
        if trace_ctx is None:
            return self._get(refs, timeout)
        t0 = time.perf_counter()
        try:
            return self._get(refs, timeout)
        finally:
            waited = time.perf_counter() - t0
            if waited >= 0.001:
                from ray_tpu_torch.util import tracing

                tracing.emit_span(
                    f"get x{len(refs)}", waited,
                    tracing.child_context("get"), phase="get_wait",
                    num_objects=len(refs))

    def _get(self, refs: List[ObjectRef], timeout: Optional[float]) -> List[Any]:
        from ray_tpu_torch.exceptions import GetTimeoutError

        self.flush_removals()
        oids = [r.binary() for r in refs]
        if self.thin_client:
            return self._get_blobs(oids, timeout)
        blocked = self.mode == "worker" and self.task_depth > 0
        if blocked:
            self.client.notify_blocked()
        try:
            locations = self.client.get_locations(list(set(oids)), timeout)
        finally:
            if blocked:
                self.client.notify_unblocked()
        if locations is None:
            raise GetTimeoutError(f"Get timed out after {timeout}s for {len(oids)} objects")
        try:
            return [read_value(locations[oid], oid) for oid in oids]
        except FileNotFoundError:
            # segment spilled/moved between location reply and attach —
            # one refetch gets the fresh location
            locations = self.client.get_locations(list(set(oids)), timeout)
            return [read_value(locations[oid], oid) for oid in oids]

    def wait(
        self, refs: List[ObjectRef], num_returns: int, timeout: Optional[float]
    ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        self.flush_removals()
        oids = [r.binary() for r in refs]
        blocked = self.mode == "worker" and self.task_depth > 0
        if blocked:
            self.client.notify_blocked()
        try:
            ready_ids, _ = self.client.wait(oids, num_returns, timeout)
        finally:
            if blocked:
                self.client.notify_unblocked()
        ready_set = set(ready_ids)
        ready, not_ready = [], []
        for r in refs:
            (ready if r.binary() in ready_set and len(ready) < num_returns else not_ready).append(r)
        return ready, not_ready

    # ------------------------------------------------------------------
    # task specs
    # ------------------------------------------------------------------
    def register_function(self, blob: bytes) -> bytes:
        fn_id = hashlib.sha1(blob).digest()
        if fn_id not in self.registered_fn_ids:
            self.client.kv_put(FN_NAMESPACE, fn_id, blob)
            self.registered_fn_ids.add(fn_id)
        return fn_id

    def fetch_function(self, fn_id: bytes) -> Any:
        fn = self.function_cache.get(fn_id)
        if fn is None:
            blob = self.client.kv_get(FN_NAMESPACE, fn_id)
            if blob is None:
                raise RuntimeError(f"function {fn_id.hex()} not found in GCS KV")
            fn = cloudpickle.loads(blob)
            self.function_cache[fn_id] = fn
        return fn

    def build_task_spec(
        self,
        *,
        name: str,
        fn_id: Optional[bytes],
        args: tuple,
        kwargs: dict,
        num_returns: int,
        resources: Dict[str, float],
        scheduling_strategy: Optional[dict] = None,
        max_retries: int = 0,
        actor_id: Optional[bytes] = None,
        method_name: Optional[str] = None,
        is_actor_creation: bool = False,
        max_restarts: int = 0,
        max_task_retries: int = 0,
        actor_name: Optional[str] = None,
        runtime_env: Optional[dict] = None,
        max_concurrency: int = 1,
        release_cpu_after_start: bool = False,
        concurrency_group: Optional[str] = None,
        concurrency_groups: Optional[Dict[str, int]] = None,
        lifetime: Optional[str] = None,
        namespace: Optional[str] = None,
    ) -> Tuple[dict, List[ObjectRef]]:
        cfg = get_config()
        if runtime_env and (runtime_env.get("working_dir")
                            or runtime_env.get("py_modules")):
            import json as _json

            from ray_tpu_torch._private.runtime_env_packaging import (
                prepare_runtime_env,
            )

            ck = _json.dumps(runtime_env, sort_keys=True)
            prepared = self._prepared_envs.get(ck)
            if prepared is None:
                prepared = prepare_runtime_env(runtime_env, self.client)
                self._prepared_envs[ck] = prepared
            runtime_env = prepared
        dep_ids: List[bytes] = []

        def _convert(v):
            if isinstance(v, ObjectRef):
                dep_ids.append(v.binary())
                return _ArgPlaceholder(v.binary())
            return v

        conv_args = tuple(_convert(a) for a in args)
        conv_kwargs = {k: _convert(v) for k, v in kwargs.items()}
        meta, buffers, contained = serialization.serialize((conv_args, conv_kwargs))
        # Pin every referenced object for the task's lifetime: top-level arg
        # refs (dep_ids) and refs nested inside serialized args.  Counted
        # HERE, while the caller's handles are provably alive (they sit in
        # ``args``), so a handle finalizer can't race the increment; the
        # head releases the pins when the task completes.
        pinned = list(dict.fromkeys(dep_ids + [r.binary() for r in contained]))
        if pinned:
            self.client.add_refs(pinned, reason="task_arg")
        owned_oids: List[bytes] = []
        total = serialization.total_size(meta, buffers)
        if total <= cfg.max_direct_call_object_size:
            args_blob = serialization.to_bytes(meta, buffers)
            args_oid = None
        else:
            # big args travel via the object store, not the control socket;
            # the spec owns this object's initial refcount
            big_ref = ObjectRef.random()
            if self.thin_client:
                self._put_blob(big_ref, (conv_args, conv_kwargs),
                               track_contained=False)
            else:
                loc, _ = store_value(big_ref, (conv_args, conv_kwargs))
                self.client.seal(big_ref.binary(), loc, [])
            args_blob = None
            args_oid = big_ref.binary()
            dep_ids.append(args_oid)
            owned_oids.append(args_oid)
        task_id = new_id()
        return_ids = [new_id() for _ in range(num_returns)]
        spec = {
            "task_id": task_id,
            "name": name,
            "fn_id": fn_id,
            "args_blob": args_blob,
            "args_oid": args_oid,
            "dep_ids": dep_ids,
            "pinned_refs": pinned,
            "owned_oids": owned_oids,
            "return_ids": return_ids,
            "num_returns": num_returns,
            "resources": dict(resources),
            "scheduling_strategy": scheduling_strategy,
            "retries_left": max_retries,
            "actor_id": actor_id,
            "method_name": method_name,
            "is_actor_creation": is_actor_creation,
            "max_restarts": max_restarts,
            "max_task_retries": max_task_retries,
            "actor_name": actor_name,
            "runtime_env": runtime_env,
            "max_concurrency": max_concurrency,
            "release_cpu_after_start": release_cpu_after_start,
            "concurrency_group": concurrency_group,
            "concurrency_groups": concurrency_groups,
            "lifetime": lifetime,
            # lineage edge for recursive cancellation (the reference embeds
            # the parent in the task id itself, src/ray/common/id.h)
            "parent_task_id": self.current_task_id,
            # tenant attribution: the submitting job, inherited by nested
            # submissions from inside tasks (current_*) or the driver's
            # own identity; actor creation may pin an explicit namespace
            "job_id": self.current_job_id or self.job_id,
            "namespace": (namespace if is_actor_creation and namespace
                          else self.current_namespace or self.namespace),
        }
        # strip default/absent fields off the wire — every consumer reads
        # optionals with .get(); a plain task's spec shrinks ~2x
        spec = {
            k: v for k, v in spec.items()
            if not (v is None or v == [] or v is False or v == 0)
            or k in ("task_id", "name", "return_ids", "num_returns")
        }
        from ray_tpu_torch.util import tracing

        trace_ctx = tracing.child_context_for_task(name)
        if trace_ctx is not None:
            spec["trace_ctx"] = trace_ctx
        return spec, [
            self.track_ref(ObjectRef(oid), owned=True) for oid in return_ids
        ]


global_worker = Worker()

# -- cancellation state (worker mode) ---------------------------------------
# ids cancelled before they started: the exec loop skips them.  Async
# in-flight coroutines register here so a cancel can .cancel() them.
_cancelled_ids: set = set()
_async_futs: Dict[bytes, Any] = {}
_async_futs_lock = threading.Lock()
# main-thread execution state for interruption: "tid" is set only while
# user code for that task is running ON the main thread (the only thread
# interrupt_main can reach); "spec" outlives it until task_done is sent so
# the main loop can recover a report if a late KeyboardInterrupt lands
# between the user code finishing and the report going out.
_main_exec: Dict[str, Any] = {"tid": None, "spec": None}


def _on_cancel_message(msg: dict) -> None:
    """Runs on the client's recv thread (ray_tpu_torch cancel -> CancelTask RPC
    analog).  Three cases: not started yet (skip via _cancelled_ids),
    running on the main thread (KeyboardInterrupt via interrupt_main — the
    reference raises the same into the worker), running as a coroutine
    (Future.cancel)."""
    tid = msg["task_id"]
    _cancelled_ids.add(tid)
    with _async_futs_lock:
        fut = _async_futs.get(tid)
    if fut is not None:
        fut.cancel()
        _cancelled_ids.discard(tid)  # consumed; nothing else will skip it
        return
    # interrupt only while the TARGET task's user code is on the main
    # thread — checking current_task_id alone could interrupt whatever ran
    # next (sealing, or an unrelated pipelined task)
    if _main_exec["tid"] == tid:
        import _thread

        _thread.interrupt_main()
    if len(_cancelled_ids) > 10_000:
        # unconsumed ids (cancels that raced completion) must not grow
        # forever; losing 10k-old skip markers is harmless
        _cancelled_ids.clear()


# ---------------------------------------------------------------------------
# Task execution (worker process)
# ---------------------------------------------------------------------------

_async_loop: Optional[asyncio.AbstractEventLoop] = None
_async_loop_lock = threading.Lock()
_async_sem: Optional[asyncio.Semaphore] = None
# per-concurrency-group coroutine bounds (created on the loop thread's
# first use of each group; setdefault keeps racing creators consistent)
_async_group_sems: Dict[str, asyncio.Semaphore] = {}


def _get_async_loop() -> asyncio.AbstractEventLoop:
    """Lazily start the worker's single persistent event loop thread."""
    global _async_loop
    with _async_loop_lock:
        if _async_loop is None:
            loop = asyncio.new_event_loop()
            t = threading.Thread(target=loop.run_forever, daemon=True,
                                 name="actor-async-loop")
            t.start()
            _async_loop = loop
    return _async_loop


_group_caps_cache: Optional[Dict[str, int]] = None


def _concurrency_group_caps() -> Dict[str, int]:
    """Declared concurrency groups of this (actor) worker, from the env
    the head set at spawn (``@remote(concurrency_groups={...})``).
    Parsed once — the env is fixed for the worker's lifetime and this
    sits on the async-method execution path."""
    global _group_caps_cache
    if _group_caps_cache is None:
        raw = os.environ.get("RAY_TPU_TORCH_CONCURRENCY_GROUPS")
        caps: Dict[str, int] = {}
        if raw:
            import json

            try:
                caps = {str(k): int(v) for k, v in json.loads(raw).items()}
            except (ValueError, TypeError, AttributeError):
                caps = {}
        _group_caps_cache = caps
    return _group_caps_cache


async def _ensure_coro(awaitable, trace_ctx=None, group: Optional[str] = None,
                       job_id: Optional[str] = None,
                       namespace: Optional[str] = None):
    if trace_ctx is not None:
        # run_coroutine_threadsafe creates the Task with the LOOP thread's
        # context, not the submitting executor thread's — re-adopt here so
        # nested submissions from async actor methods stay in the trace
        from ray_tpu_torch.util import tracing

        tracing._current.set(trace_ctx)
    # same re-adoption for tenant identity: the coroutine body must see
    # the SUBMITTER's job/namespace (runtime context, get_actor default,
    # nested-submission stamping), not the loop thread's leftovers
    _job_ctx.set(job_id)
    _ns_ctx.set(namespace)
    # max_concurrency must bound RUNNING coroutines, not just threads: the
    # head pipelines extra calls beyond max_concurrency (actor_pipeline_depth)
    # and an async method frees its executor thread immediately, so without
    # this gate pipelined coroutines would interleave past the user's limit
    # (an async actor declared max_concurrency=1 expects serial execution).
    # Concurrency groups get one semaphore EACH (the asyncio half of the
    # reference's ConcurrencyGroupManager<FiberState>): a saturated default
    # group never starves a named group's coroutines.
    caps = _concurrency_group_caps()
    if group is not None and group in caps:
        sem = _async_group_sems.get(group)
        if sem is None:
            sem = _async_group_sems.setdefault(
                group, asyncio.Semaphore(caps[group]))
    else:
        global _async_sem
        if _async_sem is None:
            _async_sem = asyncio.Semaphore(
                int(os.environ.get("RAY_TPU_TORCH_MAX_CONCURRENCY", "1")))
        sem = _async_sem
    async with sem:
        return await awaitable


_completion_pool = None
_completion_pool_lock = threading.Lock()


def _completion_executor():
    """Single side thread that seals async-method results so the event loop
    never blocks on serialization/shm writes."""
    global _completion_pool
    with _completion_pool_lock:
        if _completion_pool is None:
            _completion_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="async-complete"
            )
        return _completion_pool


def _resolve_args(spec: dict, dep_locs: Dict[bytes, ObjectLocation]) -> Tuple[tuple, dict]:
    if spec.get("args_oid"):
        conv_args, conv_kwargs = read_value(dep_locs[spec["args_oid"]], spec["args_oid"])
    else:
        conv_args, conv_kwargs = serialization.deserialize(memoryview(spec["args_blob"]))

    def _resolve(v):
        if isinstance(v, _ArgPlaceholder):
            return read_value(dep_locs[v.oid], v.oid)
        return v

    args = tuple(_resolve(a) for a in conv_args)
    kwargs = {k: _resolve(v) for k, v in conv_kwargs.items()}
    return args, kwargs


def _execute_task(msg: dict) -> None:
    from ray_tpu_torch.exceptions import RayTaskError

    w = global_worker
    spec = msg["spec"]
    if spec["task_id"] in _cancelled_ids:
        # cancelled while queued at this worker: report without executing
        # (the head pre-sealed the returns; our duplicate seal is dropped)
        from ray_tpu_torch.exceptions import TaskCancelledError

        _cancelled_ids.discard(spec["task_id"])
        _seal_and_report(
            w, spec,
            [TaskCancelledError("task was cancelled")] * spec["num_returns"],
            True, "TaskCancelledError: cancelled before start", time.time())
        return
    dep_locs = msg.get("dep_locs", {})
    gpu_ids = msg.get("gpu_ids", [])
    # The per-task grant, set on every plain task (a pooled worker may be
    # reused for a task holding other cards than its previous one, or none:
    # "" hides every card).  CUDA reads CUDA_VISIBLE_DEVICES once, at the
    # process's first CUDA call, so a pooled worker keeps the cards of the
    # first task that touched CUDA; only dedicated actor workers, whose
    # grant is set at spawn, are exact (the reference's caveat too).
    if gpu_ids or spec.get("actor_id") is None:
        ids = ",".join(str(i) for i in gpu_ids)
        os.environ["CUDA_VISIBLE_DEVICES"] = ids
        os.environ["RAY_TPU_TORCH_ASSIGNED_GPUS"] = ids
    w.current_task_id = spec["task_id"]
    # tenant context: nested submissions and get_runtime_context() inside
    # this task see the submitting job/namespace (set even when absent so
    # a pooled worker never leaks the previous tenant's identity)
    w.current_job_id = spec.get("job_id")
    w.current_namespace = spec.get("namespace")
    # continue the submitter's trace: nested submissions from this thread
    # chain under it (tracing_helper.py span-resume analog).  Set even when
    # None — a pooled worker must not leak the previous task's context.
    from ray_tpu_torch.util import tracing

    tracing._current.set(spec.get("trace_ctx"))
    exec_start = time.time()  # profile event (core_worker profiling.h:30)
    failed = False
    error_str = None
    on_main = threading.current_thread() is threading.main_thread()
    if on_main:
        _main_exec["spec"] = spec
        _main_exec["tid"] = spec["task_id"]
    try:
        try:
            args, kwargs = _resolve_args(spec, dep_locs)
        except FileNotFoundError:
            # a dep's segment was spilled between dispatch and attach —
            # refetch locations once (same guard Worker.get has)
            fresh = w.client.get_locations(list(dep_locs), timeout=60)
            args, kwargs = _resolve_args(spec, fresh or dep_locs)
        if spec.get("is_actor_creation"):
            cls = w.fetch_function(spec["fn_id"])
            w.task_depth += 1
            try:
                w.actor_instance = cls(*args, **kwargs)
            finally:
                w.task_depth -= 1
            w.current_actor_id = spec["actor_id"]
            # a dedicated actor worker belongs to its actor's tenant for
            # life: method calls without a job context still resolve
            # namespace-scoped lookups against the actor's own namespace
            w.job_id = spec.get("job_id") or w.job_id
            w.namespace = spec.get("namespace") or w.namespace
            log_plane.bump_context_epoch()  # job_id is a plain attribute
            results = [None]
        elif spec.get("compiled_graph"):
            # compiled-graph control op (dag/compiled.py): a shipped
            # function run with the actor instance, outside the
            # method-name lane.  The op returns quickly; any execution
            # loop it installs runs on its own thread.
            fn = w.fetch_function(spec["fn_id"])
            w.task_depth += 1
            try:
                out = fn(w.actor_instance, *args, **kwargs)
            finally:
                w.task_depth -= 1
            results = _split_returns(out, spec["num_returns"])
        elif spec.get("actor_id") is not None:
            method = getattr(w.actor_instance, spec["method_name"])
            w.task_depth += 1
            try:
                out = method(*args, **kwargs)
                if inspect.isawaitable(out):
                    # async actor method: hand the coroutine to the worker's
                    # persistent event loop and finish via callback (fiber.h
                    # / asyncio concurrency-group analog).  No thread parks
                    # on the result, so in-flight concurrency is bounded by
                    # the loop, not the executor pool — 1000 awaiting calls
                    # cost 1000 loop tasks, not 1000 threads.
                    fut = asyncio.run_coroutine_threadsafe(
                        _ensure_coro(out, spec.get("trace_ctx"),
                                     spec.get("concurrency_group"),
                                     spec.get("job_id"),
                                     spec.get("namespace")),
                        _get_async_loop()
                    )
                    with _async_futs_lock:
                        _async_futs[spec["task_id"]] = fut
                        if spec["task_id"] in _cancelled_ids:
                            fut.cancel()  # cancel raced the registration

                    def _complete(f, spec=spec, exec_start=exec_start):
                        with _async_futs_lock:
                            _async_futs.pop(spec["task_id"], None)
                        # runs on the loop thread: compute the outcome only,
                        # then seal on a side thread — result serialization
                        # must never stall the other in-flight coroutines
                        try:
                            res = _split_returns(f.result(), spec["num_returns"])
                            failed_, err_str = False, None
                        except BaseException as e:  # noqa: BLE001
                            tb = traceback.format_exc()
                            err = e if isinstance(e, RayTaskError) else RayTaskError(
                                f"Task {spec.get('name')} failed:\n{tb}", cause=e
                            )
                            res = [err] * spec["num_returns"]
                            failed_, err_str = True, f"{type(e).__name__}: {e}"
                        _completion_executor().submit(
                            _seal_and_report, w, spec, res, failed_, err_str,
                            exec_start,
                        )

                    fut.add_done_callback(_complete)
                    if on_main:  # the coroutine owns reporting from here
                        _main_exec["spec"] = None
                    return
            finally:
                w.task_depth -= 1
            results = _split_returns(out, spec["num_returns"])
        else:
            fn = w.fetch_function(spec["fn_id"])
            w.task_depth += 1
            try:
                out = fn(*args, **kwargs)
                if inspect.isawaitable(out):  # async remote function
                    out = asyncio.run_coroutine_threadsafe(
                        _ensure_coro(out, spec.get("trace_ctx"),
                                     None, spec.get("job_id"),
                                     spec.get("namespace")),
                        _get_async_loop()
                    ).result()
                if spec.get("dynamic_returns"):
                    out = _stream_dynamic_returns(w, spec, out)
            finally:
                w.task_depth -= 1
            results = (
                [out] if spec.get("dynamic_returns")
                else _split_returns(out, spec["num_returns"])
            )
    except BaseException as e:  # noqa: BLE001
        failed = True
        tb = traceback.format_exc()
        error_str = f"{type(e).__name__}: {e}"
        err = e if isinstance(e, RayTaskError) else RayTaskError(
            f"Task {spec.get('name')} failed:\n{tb}", cause=e
        )
        results = [err] * spec["num_returns"]
    finally:
        if on_main:  # close the cancellation-interrupt window
            _main_exec["tid"] = None
    _seal_and_report(w, spec, results, failed, error_str, exec_start)


def _seal_and_report(w, spec: dict, results: List[Any], failed: bool,
                     error_str: Optional[str],
                     exec_start: Optional[float] = None) -> None:
    """Seal the return objects and tell the head the task finished.  Runs on
    the executing thread for sync tasks and on the event-loop thread (via
    add_done_callback) for async actor methods."""
    from ray_tpu_torch.exceptions import RayTaskError

    seals = []
    for oid, value in zip(spec["return_ids"], results):
        ref = ObjectRef(oid)
        try:
            loc, contained = store_value(ref, value, is_error=failed)
        except BaseException as e:  # unserializable result
            loc, contained = store_value(
                ref, RayTaskError(f"Failed to serialize result of {spec.get('name')}: {e}"),
                is_error=True,
            )
        seals.append((oid, loc, [r.binary() for r in contained]))
    # returns ride inside task_done — one message per task instead of
    # num_returns+1; the head seals them before the done bookkeeping
    w.client.send({
        "type": "task_done",
        "seals": seals,
        "spec_ref": {
            "task_id": spec["task_id"],
            "return_ids": spec["return_ids"],
            "is_actor_creation": spec.get("is_actor_creation"),
            "actor_id": spec.get("actor_id"),
            "name": spec.get("name"),
        },
        "failed": failed,
        "error_str": error_str,
        # profile event window (Profiler/ProfileEvent analog) — the head
        # stores it on TaskInfo for `ray_tpu_torch timeline`
        "exec_start": exec_start,
        "exec_end": time.time(),
        "worker_pid": os.getpid(),
    })
    w.current_task_id = None
    if threading.current_thread() is threading.main_thread():
        _main_exec["spec"] = None  # reported; nothing left to recover


def _stream_dynamic_returns(w: Worker, spec: dict, out) -> "ObjectRefGenerator":
    """``num_returns="dynamic"`` executor half (reference
    ``_raylet.pyx`` dynamic-return storing): each yielded value becomes its
    own object sealed AS PRODUCED — the head's yield directory streams the
    refs to any ObjectRefGenerator consumer before the task even finishes.
    The terminal return is the materialized generator, whose contained refs
    pin the yielded objects."""
    from ray_tpu_torch._private.object_ref import ObjectRefGenerator

    refs = []
    for item in out:
        r = ObjectRef.random()
        loc, contained = store_value(r, item)
        w.client.seal(r.binary(), loc, [c.binary() for c in contained])
        w.client.send({"type": "dynamic_yield",
                       "task_id": spec["task_id"], "oid": r.binary()})
        refs.append(w.track_ref(r, owned=True))
    return ObjectRefGenerator(refs)


def _split_returns(out: Any, num_returns: int) -> List[Any]:
    if num_returns == 1:
        return [out]
    if not isinstance(out, (tuple, list)) or len(out) != num_returns:
        raise ValueError(
            f"Task declared num_returns={num_returns} but returned {type(out)}"
        )
    return list(out)


def _redirect_output_to_log() -> None:
    """Redirect this worker's stdout/stderr into its per-worker rotating
    log file (``RAY_TPU_TORCH_WORKER_LOG``, set at spawn), stamped with live
    task/actor/job/trace context so the log plane can correlate plain
    ``print()`` output (reference: per-worker log files under the session
    dir + the log monitor's line attribution).  dup2 at the fd level
    catches subprocess and C-level writes too; self-redirection works for
    every spawn path, including forkserver forks that inherit the
    template's fds.  Failures are swallowed inside
    ``redirect_process_output`` — logging must never block a worker
    boot."""
    path = os.environ.get("RAY_TPU_TORCH_WORKER_LOG")
    if not path:
        return
    from ray_tpu_torch._private.log_plane import redirect_process_output

    redirect_process_output(path)


def main() -> None:
    """Worker process entry point (python -m ray_tpu_torch._private.worker)."""
    _redirect_output_to_log()
    address = os.environ["RAY_TPU_TORCH_ADDRESS"]
    authkey = bytes.fromhex(os.environ["RAY_TPU_TORCH_AUTHKEY"])
    node_id = os.environ["RAY_TPU_TORCH_NODE_ID"]
    worker_id = bytes.fromhex(os.environ["RAY_TPU_TORCH_WORKER_ID"])

    w = global_worker
    w.mode = "worker"
    w.node_id = node_id
    w.worker_id = worker_id
    from ray_tpu_torch._private import object_transfer

    object_transfer.configure(authkey)  # cross-node pulls (SURVEY §3.3)
    from multiprocessing import AuthenticationError

    try:
        client = CoreClient(address, authkey, worker_id=worker_id, node_id=node_id)
        client._exec_queue = queue.Queue()
        w.client = client
    except (OSError, EOFError, AuthenticationError):
        # our head died while we were booting (connect refused / reset) or
        # we're a straggler from a killed session whose port got reused
        # (authkey mismatch): exit quietly — a traceback on the inherited
        # stderr reads like a live-session failure
        os._exit(0)

    # materialize package URIs (working_dir chdir / py_modules sys.path)
    # BEFORE registering: a persistently failing package then dies
    # pre-registration, which is what the spawn-failure circuit breaker
    # counts — registering first would reset the breaker every respawn
    # and loop forever (the same pre-registration invariant the pip
    # bootstrap shim keeps by exiting 77 before exec)
    try:
        from ray_tpu_torch._private.runtime_env_packaging import (
            apply_packages_in_worker,
        )

        apply_packages_in_worker(client)
    except Exception as e:  # noqa: BLE001
        print(f"runtime_env package setup failed: {e}", file=sys.stderr)
        os._exit(77)

    try:
        client.register_worker()
    except (OSError, EOFError, AuthenticationError):
        os._exit(0)

    # app metrics recorded in this worker (the card-memory gauges of
    # util/perf.py among them) flow to the head's merged registry and its
    # TSDB; the push cadence follows RAY_TPU_TORCH_METRICS_PUSH_S so the
    # head's sample grid, origin-expiry window, and this pusher agree.
    # One pusher per process: it starts here, once, and stops on the exit
    # path below with the events pusher.
    from ray_tpu_torch.util.metrics import MetricsPusher

    _metrics_pusher = MetricsPusher(
        client.send, origin=worker_id.hex(),
        closed_fn=lambda: client.closed).start()

    # flight-recorder events ship to the head's event table; the pusher
    # also rewrites this worker's crash-dump file each cycle, so a
    # SIGKILL'd worker leaves its last-flushed ring in the log dir
    from ray_tpu_torch._private import events as events_mod

    _events_dump = None
    _session_dir = os.environ.get("RAY_TPU_TORCH_SESSION_DIR")
    if _session_dir:
        _events_dump = os.path.join(
            _session_dir, "logs", f"events-worker-{worker_id.hex()}.jsonl")
    _events_pusher = events_mod.EventsPusher(
        client.send, origin=worker_id.hex(), dump_path=_events_dump,
        closed_fn=lambda: client.closed).start()

    # the always-on flamegraph plane: low-duty-cycle stack bursts ship to
    # the head's ProfileStore over this same control connection
    from ray_tpu_torch._private import sampling_profiler as _sp

    _cont_profiler = None
    if _sp.continuous_enabled():
        _cont_profiler = _sp.ContinuousProfiler(
            worker_id.hex(), send_fn=client.send,
            closed_fn=lambda: client.closed).start()

    # Threaded/async actor support: with max_concurrency > 1 the head
    # pipelines up to N methods at us; a BoundedExecutor-analog pool runs
    # them concurrently (creation always runs inline, before any method).
    # Declared concurrency groups each get their OWN bounded pool
    # (ConcurrencyGroupManager<BoundedExecutor> analog) — and force the
    # default lane through a pool too, even at max_concurrency=1:
    # executing the default group inline on this loop thread would stop
    # message draining and starve the named groups it exists to protect.
    max_concurrency = int(os.environ.get("RAY_TPU_TORCH_MAX_CONCURRENCY", "1"))
    group_caps = _concurrency_group_caps()
    pool = None
    group_pools: Dict[str, Any] = {}
    if max_concurrency > 1 or group_caps:
        from concurrent.futures import ThreadPoolExecutor

        # Threads are created lazily; async methods release their thread as
        # soon as the coroutine is scheduled, so the pool only fills when
        # the user runs that many *sync* methods concurrently.
        pool = ThreadPoolExecutor(
            max_workers=max_concurrency, thread_name_prefix="actor-exec"
        )
        for gname, cap in group_caps.items():
            # one pool per group: FIFO within the group (a single executor
            # queue), non-interfering across groups (disjoint threads)
            group_pools[gname] = ThreadPoolExecutor(
                max_workers=max(1, cap), thread_name_prefix=f"cg-{gname}"
            )

    client._cancel_handler = _on_cancel_message

    def _on_reclaim_message(msg):
        """The head reclaims this worker's UNSTARTED pipelined tasks while
        the current task is blocked in a get: a pipelined task whose output
        the blocked task is waiting on would otherwise deadlock behind it
        in this FIFO queue.  Drain execute messages out of the local queue
        and report their ids; the head requeues exactly those (any message
        the main loop already claimed simply runs here, unreported)."""
        returned = []
        keep = []
        while True:
            try:
                m = client._exec_queue.get_nowait()
            except queue.Empty:
                break
            spec = m.get("spec") or {}
            if m.get("type") == "execute" and spec.get("actor_id") is None:
                returned.append(spec["task_id"])
            else:
                keep.append(m)
        for m in keep:
            client._exec_queue.put(m)
        client.send({"type": "pipeline_returned", "task_ids": returned})

    client._reclaim_handler = _on_reclaim_message

    def _on_profile_message(msg):
        # dashboard on-demand profiling (profile_manager.py analog): sample
        # this process for the requested window, report back to the head
        from ray_tpu_torch._private.sampling_profiler import profile_for

        report = profile_for(float(msg.get("duration", 3.0)),
                             top=int(msg.get("top", 40)))
        client.send({"type": "profile_result", "token": msg.get("token"),
                     "report": report})

    client._profile_handler = _on_profile_message

    while True:
        try:
            msg = client._exec_queue.get()
            if msg["type"] == "exit":
                break
            if msg["type"] == "execute":
                spec = msg["spec"]
                if (
                    pool is not None
                    and spec.get("actor_id") is not None
                    and not spec.get("is_actor_creation")
                ):
                    # route to the method's concurrency group's pool;
                    # unknown/absent group -> default pool
                    target = group_pools.get(
                        spec.get("concurrency_group"), pool)
                    target.submit(_execute_task, msg)
                else:
                    _execute_task(msg)
        except KeyboardInterrupt:
            # a cancel's interrupt_main landed outside user code — either
            # between tasks (harmless) or in the tiny window between the
            # user code finishing and task_done going out.  In the latter
            # case the head still thinks the task is running: send the
            # report it was owed so dispatch bookkeeping stays in sync.
            spec = _main_exec.get("spec")
            _main_exec["spec"] = None
            _main_exec["tid"] = None
            if spec is not None:
                from ray_tpu_torch.exceptions import TaskCancelledError

                try:
                    _seal_and_report(
                        w, spec,
                        [TaskCancelledError("task was cancelled")]
                        * spec["num_returns"],
                        True, "TaskCancelledError: cancelled", time.time())
                except Exception:
                    pass
            continue
    if pool is not None:
        pool.shutdown(wait=False)
    for gp in group_pools.values():
        gp.shutdown(wait=False)
    _metrics_pusher.stop()  # no send after the connection closes
    if _cont_profiler is not None:
        _cont_profiler.stop()  # final profile ship before the hard exit
    _events_pusher.stop()  # final ship + crash-dump before the hard exit
    client.close()
    os._exit(0)


if __name__ == "__main__":
    # Delegate to the canonical module so classes defined here are not
    # duplicated under the __main__ module name (placeholder identity).
    from ray_tpu_torch._private.worker import main as _canonical_main

    _canonical_main()
