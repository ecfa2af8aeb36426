"""Workflow execution + storage.

Storage layout (``workflow_storage.py`` analog), one directory per
workflow under ``$RAY_TPU_TORCH_WORKFLOW_STORAGE`` (default
``workflows/`` under the port's session root, ``$TMPDIR/ray_tpu_torch``,
never the JAX package's ``/tmp/ray_tpu``)::

    <id>/meta.json        status + timestamps
    <id>/dag.pkl          the bound DAG (for resume)
    <id>/steps/<sid>.pkl  checkpointed step results
    <id>/output.pkl       final result

Step ids are deterministic (topological index + function name), so a
resumed run maps steps onto their prior checkpoints.  Steps run as
cluster tasks; their *values* are checkpointed (results must be
picklable — the durability contract of the reference).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import cloudpickle

from ray_tpu_torch._private.config import session_root
from ray_tpu_torch.dag import ClassNode, DAGNode, FunctionNode, InputNode


def _root() -> str:
    return (os.environ.get("RAY_TPU_TORCH_WORKFLOW_STORAGE")
            or os.path.join(session_root(), "workflows"))


class WorkflowStorage:
    def __init__(self, workflow_id: str):
        self.workflow_id = workflow_id
        self.dir = os.path.join(_root(), workflow_id)

    def _ensure_dirs(self) -> None:
        # lazy: reads (get_status of an unknown id, cancel probes) must
        # not fabricate phantom workflow directories
        os.makedirs(os.path.join(self.dir, "steps"), exist_ok=True)

    # -- meta ----------------------------------------------------------
    def _meta_path(self) -> str:
        return os.path.join(self.dir, "meta.json")

    def write_meta(self, **updates) -> None:
        self._ensure_dirs()
        meta = self.read_meta() or {"workflow_id": self.workflow_id,
                                    "created": time.time()}
        meta.update(updates)
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, self._meta_path())

    def read_meta(self) -> Optional[dict]:
        try:
            with open(self._meta_path()) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    # -- dag / steps / output -----------------------------------------
    def save_dag(self, dag: DAGNode) -> None:
        self._ensure_dirs()
        with open(os.path.join(self.dir, "dag.pkl"), "wb") as f:
            cloudpickle.dump(dag, f)

    def load_dag(self) -> DAGNode:
        with open(os.path.join(self.dir, "dag.pkl"), "rb") as f:
            return cloudpickle.load(f)

    def step_path(self, step_id: str) -> str:
        return os.path.join(self.dir, "steps", f"{step_id}.pkl")

    def has_step(self, step_id: str) -> bool:
        return os.path.exists(self.step_path(step_id))

    def save_step(self, step_id: str, value: Any) -> None:
        self._ensure_dirs()
        tmp = self.step_path(step_id) + ".tmp"
        with open(tmp, "wb") as f:
            cloudpickle.dump(value, f)
        os.replace(tmp, self.step_path(step_id))

    def load_step(self, step_id: str) -> Any:
        with open(self.step_path(step_id), "rb") as f:
            return cloudpickle.load(f)

    def save_step_meta(self, step_id: str, meta: dict) -> None:
        self._ensure_dirs()
        tmp = self.step_path(step_id) + ".meta.tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, self.step_path(step_id) + ".meta")

    def load_step_metas(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        steps_dir = os.path.join(self.dir, "steps")
        try:
            names = os.listdir(steps_dir)
        except OSError:
            return out
        for n in names:
            if n.endswith(".pkl.meta"):
                try:
                    with open(os.path.join(steps_dir, n)) as f:
                        out[n[:-len(".pkl.meta")]] = json.load(f)
                except (OSError, json.JSONDecodeError):
                    pass
        return out

    def save_output(self, value: Any) -> None:
        self._ensure_dirs()
        with open(os.path.join(self.dir, "output.pkl"), "wb") as f:
            cloudpickle.dump(value, f)

    def load_output(self) -> Any:
        with open(os.path.join(self.dir, "output.pkl"), "rb") as f:
            return cloudpickle.load(f)

    def has_output(self) -> bool:
        return os.path.exists(os.path.join(self.dir, "output.pkl"))

    def save_inputs(self, args: tuple, kwargs: dict) -> None:
        self._ensure_dirs()
        with open(os.path.join(self.dir, "inputs.pkl"), "wb") as f:
            cloudpickle.dump((args, kwargs), f)

    def load_inputs(self) -> tuple:
        try:
            with open(os.path.join(self.dir, "inputs.pkl"), "rb") as f:
                return cloudpickle.load(f)
        except OSError:
            return (), {}


class WorkflowError(Exception):
    """Base for workflow failures (reference workflow/exceptions.py)."""


class WorkflowExecutionError(WorkflowError):
    pass


class WorkflowCancellationError(WorkflowError):
    pass


# live runs: workflow_id -> {"cancel": bool, "refs": set}
_running: Dict[str, dict] = {}
_running_lock = threading.Lock()

_WOPT_KEYS = frozenset(("name", "max_retries", "catch_exceptions",
                        "checkpoint"))


class options:
    """Per-step workflow options, as a decorator over ``@remote``
    functions (reference ``workflow.options``)::

        @workflow.options(max_retries=3, catch_exceptions=True)
        @ray_tpu_torch.remote
        def flaky(): ...

    - ``name``: step-id suffix (stable across code moves).
    - ``max_retries``: resubmit a failed step N times before failing
      the workflow.
    - ``catch_exceptions``: the step's checkpointed value becomes
      ``(result, None)`` or ``(None, exception)`` — downstream steps
      handle the error as data.
    - ``checkpoint``: ``False`` skips persisting this step's result
      (recomputed on resume).
    """

    def __init__(self, **opts):
        unknown = set(opts) - _WOPT_KEYS
        if unknown:
            raise ValueError(f"unknown workflow options {sorted(unknown)}; "
                             f"supported: {sorted(_WOPT_KEYS)}")
        self._opts = opts

    def __call__(self, fn):
        fn.__workflow_options__ = dict(self._opts)
        return fn


def _wopts(node: FunctionNode) -> dict:
    return getattr(node._remote_fn, "__workflow_options__", None) or {}


def _step_ids(dag: DAGNode, prefix: str = "") -> Dict[int, str]:
    """Deterministic step ids over the topological order."""
    ids: Dict[int, str] = {}
    for i, node in enumerate(dag.topological()):
        if isinstance(node, FunctionNode):
            name = (_wopts(node).get("name")
                    or getattr(node._remote_fn, "__name__", None)
                    or getattr(getattr(node._remote_fn, "_function", None),
                               "__name__", "step"))
            ids[id(node)] = f"{prefix}{i:04d}-{name}"
    return ids


def _check_task_dag(dag: DAGNode) -> None:
    if any(isinstance(n, ClassNode) for n in dag.topological()):
        raise TypeError("workflows support task DAGs only (no actor nodes)")


# last cross-process cancel poll per workflow (monotonic seconds): meta.json
# is disk + JSON parse, so the per-step-boundary check is throttled — a
# foreign cancel() lands within the poll interval, not instantly
_meta_cancel_poll: dict = {}
_META_CANCEL_POLL_S = 1.0


def _check_cancel(workflow_id: str) -> None:
    with _running_lock:
        st = _running.get(workflow_id)
        if st is not None and st["cancel"]:
            raise WorkflowCancellationError(
                f"workflow {workflow_id} was cancelled")
    if workflow_id:
        # cross-PROCESS cancel lands as a flag in meta.json (the owning
        # process's status must not be overwritten under it); honor it at
        # a step boundary within the poll interval
        now = time.monotonic()
        if now - _meta_cancel_poll.get(workflow_id, 0.0) \
                < _META_CANCEL_POLL_S:
            return
        _meta_cancel_poll[workflow_id] = now
        meta = WorkflowStorage(workflow_id).read_meta()
        if meta and meta.get("cancel_requested") \
                and meta.get("status") == "RUNNING":
            raise WorkflowCancellationError(
                f"workflow {workflow_id} was cancelled (cross-process)")


def _pid_alive(pid) -> bool:
    try:
        os.kill(int(pid), 0)
    except (ProcessLookupError, ValueError, TypeError, OverflowError):
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    return True


def _live_foreign_run(meta: Optional[dict]) -> bool:
    """Does ``meta`` record a RUNNING workflow owned by a DIFFERENT
    process that is verifiably alive?  The pid + host stamped into
    meta.json at RUNNING time make a cross-process ``cancel()`` /
    ``resume_all()`` distinguish a live run (must not double-run or have
    its status overwritten) from a crashed one (safe to take over).
    Liveness is only probeable on the recording host; a RUNNING meta from
    another host is treated as dead — the storage root is host-local by
    default, so a foreign-host meta means the dir was copied."""
    if not meta or meta.get("status") != "RUNNING":
        return False
    pid = meta.get("pid")
    if not pid or int(pid) == os.getpid():
        return False
    import socket

    if meta.get("host") not in (None, socket.gethostname()):
        return False
    return _pid_alive(pid)


def _track_ref(workflow_id: str, ref) -> None:
    with _running_lock:
        st = _running.get(workflow_id)
        if st is not None:
            st["refs"].add(ref)


def _finish_value(value: Any, storage: WorkflowStorage, sid: str,
                  workflow_id: str, depth: int) -> Any:
    """Continuation handling: a step that RETURNS a DAG continues the
    workflow with that DAG (reference ``workflow.continuation``); the
    sub-DAG executes durably under ``<sid>~`` step ids and its final
    value becomes the step's value."""
    if isinstance(value, DAGNode):
        if depth > 50:
            raise WorkflowExecutionError(
                f"continuation depth > 50 at step {sid} (unbounded "
                f"recursive continuation?)")
        return _execute_durably(value, storage, (), {},
                                workflow_id=workflow_id,
                                prefix=f"{sid}~", depth=depth + 1)
    return value


def _run_step_sync(node: FunctionNode, args: tuple, kwargs: dict,
                   storage: WorkflowStorage, sid: str, workflow_id: str,
                   depth: int) -> Any:
    """Resolve one step to a VALUE, honoring max_retries /
    catch_exceptions.  Used for steps with workflow options (they are
    synchronization points: an error-as-data value must not flow
    downstream as a raising ObjectRef)."""
    import ray_tpu_torch

    wopts = _wopts(node)
    retries = int(wopts.get("max_retries", 0))
    attempt = 0
    while True:
        _check_cancel(workflow_id)
        step_meta = {"start": time.time(), "attempt": attempt}
        try:
            ref = node._execute_impl(args, kwargs)
            _track_ref(workflow_id, ref)
            value = _finish_value(ray_tpu_torch.get(ref), storage, sid,
                                  workflow_id, depth)
            storage.save_step_meta(sid, dict(step_meta, status="SUCCEEDED",
                                             end=time.time()))
            return (value, None) if wopts.get("catch_exceptions") else value
        except WorkflowCancellationError:
            raise
        except Exception as e:  # noqa: BLE001 — retry/catch semantics
            # a cancel() lands as TaskCancelledError out of the get —
            # surface it as cancellation, not step failure
            _check_cancel(workflow_id)
            storage.save_step_meta(sid, dict(step_meta, status="FAILED",
                                             end=time.time(),
                                             error=str(e)[:500]))
            if attempt < retries:
                attempt += 1
                continue
            if wopts.get("catch_exceptions"):
                return (None, e)
            raise


def _execute_durably(dag: DAGNode, storage: WorkflowStorage,
                     input_args: tuple, input_kwargs: dict, *,
                     workflow_id: str = "", prefix: str = "",
                     depth: int = 0) -> Any:
    import ray_tpu_torch
    from ray_tpu_torch.dag.dag_node import _DAGInput

    _check_task_dag(dag)
    ids = _step_ids(dag, prefix)
    results: Dict[int, Any] = {}
    # submit eagerly: steps whose checkpoints are missing get their
    # upstream *ObjectRefs* as args (data moves through the object plane,
    # independent branches run concurrently); checkpoints are then taken
    # in topological order as each ref resolves.  Steps with workflow
    # options (retries / catch_exceptions) resolve synchronously instead.
    submitted = []
    for node in dag.topological():
        if isinstance(node, InputNode):
            # same input representation as DAGNode.execute()
            results[id(node)] = (input_args[0]
                                 if len(input_args) == 1 and not input_kwargs
                                 else _DAGInput(input_args, input_kwargs))
            continue
        _check_cancel(workflow_id)
        sid = ids[id(node)]
        if storage.has_step(sid):
            results[id(node)] = storage.load_step(sid)
            continue
        args = tuple(node._resolve(a, results) for a in node._bound_args)
        kwargs = {k: node._resolve(v, results)
                  for k, v in node._bound_kwargs.items()}
        wopts = _wopts(node)
        if wopts.get("max_retries") or wopts.get("catch_exceptions"):
            # ONLY these two force a synchronization point (an
            # error-as-data value must not flow downstream as a raising
            # ObjectRef); name/checkpoint options keep the eager path
            value = _run_step_sync(node, args, kwargs, storage, sid,
                                   workflow_id, depth)
            if wopts.get("checkpoint", True):
                storage.save_step(sid, value)
            results[id(node)] = value
            continue
        ref = node._execute_impl(args, kwargs)
        _track_ref(workflow_id, ref)
        results[id(node)] = ref
        submitted.append((sid, node, ref))
    for sid, node, ref in submitted:
        _check_cancel(workflow_id)
        step_meta = {"start": time.time()}
        try:
            value = _finish_value(ray_tpu_torch.get(ref), storage, sid,
                                  workflow_id, depth)
        except WorkflowCancellationError:
            raise
        except Exception as e:  # noqa: BLE001 — record then surface
            _check_cancel(workflow_id)  # cancelled get, not a step failure
            storage.save_step_meta(sid, dict(step_meta, status="FAILED",
                                             end=time.time(),
                                             error=str(e)[:500]))
            raise
        if _wopts(node).get("checkpoint", True):
            storage.save_step(sid, value)
        storage.save_step_meta(sid, dict(step_meta, status="SUCCEEDED",
                                         end=time.time()))
        results[id(node)] = value
    return results[id(dag)]


def _run_sync(dag: DAGNode, storage: WorkflowStorage,
              args: tuple, kwargs: dict) -> Any:
    wid = storage.workflow_id
    with _running_lock:
        # setdefault, never overwrite: run_async/resume_all pre-register
        # BEFORE their thread starts, so a cancel() in the start window
        # lands on this entry instead of being lost
        _running.setdefault(wid, {"cancel": False, "refs": set()})
    try:
        import socket

        # pid + host let another process probe liveness (cancel /
        # resume_all); cancel_requested resets so a resumed run doesn't
        # inherit a stale cross-process cancel aimed at its predecessor
        storage.write_meta(status="RUNNING", started=time.time(),
                           pid=os.getpid(), host=socket.gethostname(),
                           cancel_requested=False)
        _check_cancel(wid)  # cancelled before the first step ran
        out = _execute_durably(dag, storage, args, kwargs, workflow_id=wid)
    except WorkflowCancellationError:
        storage.write_meta(status="CANCELED", ended=time.time(), pid=None)
        raise
    except BaseException as e:
        storage.write_meta(status="FAILED", error=str(e), ended=time.time(),
                           pid=None)
        raise
    finally:
        with _running_lock:
            _running.pop(wid, None)
    storage.save_output(out)
    storage.write_meta(status="SUCCEEDED", ended=time.time(), pid=None)
    return out


def run(dag: DAGNode, *, workflow_id: Optional[str] = None,
        args: tuple = (), kwargs: Optional[dict] = None) -> Any:
    """Run a DAG durably; blocks and returns the final result."""
    from ray_tpu_torch._private.usage import record_feature
    record_feature("workflow")
    _check_task_dag(dag)
    workflow_id = workflow_id or f"wf-{os.urandom(4).hex()}"
    storage = WorkflowStorage(workflow_id)
    storage.save_dag(dag)
    storage.save_inputs(args, kwargs or {})
    return _run_sync(dag, storage, args, kwargs or {})


class WorkflowHandle:
    """Async-run handle: ``.result(timeout)`` blocks for the value."""

    def __init__(self, workflow_id: str):
        self.workflow_id = workflow_id
        self._value = None
        self._error: Optional[BaseException] = None
        self._done = threading.Event()

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError(f"workflow {self.workflow_id} still running")
        if self._error is not None:
            raise self._error
        return self._value


def _start_async_run(dag: DAGNode, storage: WorkflowStorage, args: tuple,
                     kwargs: dict) -> WorkflowHandle:
    h = WorkflowHandle(storage.workflow_id)
    with _running_lock:
        # visible to cancel()/resume_all() from the moment the handle
        # exists, not from whenever the thread gets scheduled
        _running.setdefault(storage.workflow_id,
                            {"cancel": False, "refs": set()})

    def runner():
        try:
            h._value = _run_sync(dag, storage, args, kwargs)
        except BaseException as e:  # noqa: BLE001
            h._error = e
        finally:
            h._done.set()

    threading.Thread(target=runner, daemon=True,
                     name=f"workflow-{storage.workflow_id}").start()
    return h


def run_async(dag: DAGNode, *, workflow_id: Optional[str] = None,
              args: tuple = (), kwargs: Optional[dict] = None):
    """Run in a background thread; returns a handle with .result()."""
    _check_task_dag(dag)
    workflow_id = workflow_id or f"wf-{os.urandom(4).hex()}"
    storage = WorkflowStorage(workflow_id)
    storage.save_dag(dag)
    storage.save_inputs(args, kwargs or {})
    return _start_async_run(dag, storage, args, kwargs or {})


def resume(workflow_id: str) -> Any:
    """Re-run a workflow; completed steps load from their checkpoints."""
    storage = WorkflowStorage(workflow_id)
    if storage.has_output():
        return storage.load_output()
    if _live_foreign_run(storage.read_meta()):
        raise ValueError(
            f"workflow {workflow_id!r} is running in another live process; "
            f"resuming would double-run it")
    dag = storage.load_dag()
    args, kwargs = storage.load_inputs()  # the original run's inputs
    return _run_sync(dag, storage, args, kwargs)


def get_status(workflow_id: str) -> Optional[str]:
    meta = WorkflowStorage(workflow_id).read_meta()
    return meta.get("status") if meta else None


def get_output(workflow_id: str) -> Any:
    storage = WorkflowStorage(workflow_id)
    if not storage.has_output():
        raise ValueError(f"workflow {workflow_id} has no output "
                         f"(status={get_status(workflow_id)})")
    return storage.load_output()


def list_all() -> List[Dict[str, Any]]:
    out = []
    try:
        ids = sorted(os.listdir(_root()))
    except OSError:
        return out
    for wid in ids:
        if not os.path.isdir(os.path.join(_root(), wid)):
            continue  # stray file in the storage root is not a workflow
        meta = WorkflowStorage(wid).read_meta()
        if meta:
            out.append(meta)
    return out


def delete(workflow_id: str) -> None:
    import shutil

    shutil.rmtree(os.path.join(_root(), workflow_id), ignore_errors=True)


def cancel(workflow_id: str) -> None:
    """Cancel a running workflow: in-flight step tasks are cancelled and
    the run raises :class:`WorkflowCancellationError`; checkpoints stay,
    so ``resume`` can pick up later (reference ``workflow.cancel``)."""
    import ray_tpu_torch

    with _running_lock:
        st = _running.get(workflow_id)
        if st is None:
            # not running in this process: mark storage — but never
            # fabricate a phantom workflow for an unknown id, and never
            # downgrade a terminal status
            meta = WorkflowStorage(workflow_id).read_meta()
            if meta is None:
                raise ValueError(f"no workflow {workflow_id!r}")
            if meta.get("status") in ("SUCCEEDED", "FAILED", "CANCELED"):
                return
            if _live_foreign_run(meta):
                # the owning process is ALIVE: overwriting its status
                # would let it keep running under a CANCELED label.
                # Request cancellation instead — the owner honors the
                # flag at its next step boundary and writes CANCELED
                # itself.
                WorkflowStorage(workflow_id).write_meta(
                    cancel_requested=True)
                return
            WorkflowStorage(workflow_id).write_meta(status="CANCELED",
                                                    ended=time.time())
            return
        st["cancel"] = True
        refs = list(st["refs"])
    for ref in refs:
        try:
            ray_tpu_torch.cancel(ref, force=True)
        except Exception:  # noqa: BLE001 — already-finished refs are fine
            pass


def resume_all(include_failed: bool = False) -> List[tuple]:
    """Resume every resumable workflow (status RUNNING whose process
    died, or CANCELED; plus FAILED with ``include_failed``).  Returns
    ``[(workflow_id, handle)]`` with async handles (reference
    ``workflow.resume_all``)."""
    out = []
    for meta in list_all():
        status = meta.get("status")
        wid = meta["workflow_id"]
        with _running_lock:
            if wid in _running:
                continue  # actually live in this process
        if _live_foreign_run(meta):
            continue  # live in ANOTHER process: resuming would double-run
        if status in ("RUNNING", "CANCELED") or (
                include_failed and status == "FAILED"):
            storage = WorkflowStorage(wid)
            if storage.has_output():
                continue
            try:
                dag = storage.load_dag()
                args, kwargs = storage.load_inputs()
            except Exception:  # noqa: BLE001 — one corrupt dir (missing
                continue  # dag.pkl, bad pickle) must not abort the sweep
            out.append((wid, _start_async_run(dag, storage, args, kwargs)))
    return out


def get_metadata(workflow_id: str) -> Dict[str, Any]:
    """Workflow + per-step metadata (status, timestamps, attempts,
    errors) — reference ``workflow.get_metadata``."""
    storage = WorkflowStorage(workflow_id)
    meta = storage.read_meta()
    if meta is None:
        raise ValueError(f"no workflow {workflow_id!r}")
    return {**meta, "steps": storage.load_step_metas()}


# ---------------------------------------------------------------------------
# events (reference workflow/event_listener.py + api.wait_for_event):
# an event is just two chained steps — poll (runs until the event
# arrives; NOT checkpointed mid-poll) then commit (checkpointed, so a
# resumed workflow doesn't re-wait a consumed event).


class EventListener:
    """Subclass with ``async poll_for_event(*args)`` (resolve when the
    event arrives) and optionally ``async event_checkpointed(event)``
    (commit the consumption upstream, e.g. ack a queue offset)."""

    async def poll_for_event(self, *args, **kwargs):
        raise NotImplementedError

    async def event_checkpointed(self, event) -> None:
        pass


class TimerListener(EventListener):
    async def poll_for_event(self, end_time: float):
        import asyncio

        await asyncio.sleep(max(0.0, end_time - time.time()))
        return end_time


def wait_for_event(event_listener_type, *args, **kwargs) -> DAGNode:
    """A DAG node that resolves once the listener observes its event
    (reference ``workflow.wait_for_event``)."""
    if not (isinstance(event_listener_type, type)
            and issubclass(event_listener_type, EventListener)):
        raise TypeError(f"{event_listener_type!r} is not an EventListener "
                        f"subclass")

    import ray_tpu_torch

    @ray_tpu_torch.remote
    def get_message(listener_cls, *a, **kw):
        import asyncio

        return asyncio.run(listener_cls().poll_for_event(*a, **kw))

    @ray_tpu_torch.remote
    def message_committed(listener_cls, event):
        import asyncio

        asyncio.run(listener_cls().event_checkpointed(event))
        return event

    get_message.__name__ = f"wait_for_event.{event_listener_type.__name__}"
    message_committed.__name__ = "event_committed"
    return message_committed.bind(
        event_listener_type,
        get_message.bind(event_listener_type, *args, **kwargs))


def sleep(duration: float) -> DAGNode:
    """A step that resolves ``duration`` seconds after it first runs;
    the wake-up TIME is checkpointed, so a resumed workflow doesn't
    restart the clock (reference ``workflow.sleep``)."""
    import ray_tpu_torch

    @ray_tpu_torch.remote
    def end_time():
        return time.time() + duration

    end_time.__name__ = "sleep.end_time"
    return wait_for_event(TimerListener, end_time.bind())


def continuation(dag_node: DAGNode):
    """Mark a DAG as a continuation (reference
    ``workflow.continuation``): returned from inside a workflow step, it
    continues the workflow; called outside one, it just executes."""
    import ray_tpu_torch
    from ray_tpu_torch._private.worker import global_worker

    if not isinstance(dag_node, DAGNode):
        raise TypeError("workflow.continuation() expects a DAG")
    if global_worker.mode == "worker":
        return dag_node  # inside a step: the executor picks it up
    return ray_tpu_torch.get(dag_node.execute())
