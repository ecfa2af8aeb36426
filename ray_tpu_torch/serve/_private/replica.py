"""ServeReplica: the actor hosting one copy of a deployment's callable.

Analog of ``python/ray/serve/_private/replica.py:250`` (RayServeReplica):
constructs the user's class (or wraps a function), executes requests,
applies ``user_config`` through ``reconfigure``, and answers health checks.
GPU-backed deployments get here with ``ray_actor_options={"num_gpus": 1}``
(or a fraction of a card), so the scheduler grants the card, as the
process's ``CUDA_VISIBLE_DEVICES``, before the model loads.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import cloudpickle

from ray_tpu_torch.serve.exceptions import ReplicaDrainingError


class ServeReplica:
    def __init__(
        self,
        deployment_name: str,
        replica_tag: str,
        serialized_def: bytes,
        init_args: Tuple,
        init_kwargs: Dict,
        user_config: Optional[Any] = None,
    ):
        self.deployment_name = deployment_name
        self.replica_tag = replica_tag
        func_or_class = cloudpickle.loads(serialized_def)
        if isinstance(func_or_class, type):
            self.callable = func_or_class(*init_args, **init_kwargs)
            self._is_function = False
        else:
            self.callable = func_or_class
            self._is_function = True
        if user_config is not None:
            self.reconfigure(user_config)
        # lock-guarded: batched replicas serve requests from concurrent
        # threads, and a bare += (or a max() read-modify-write) can lose or
        # regress counts under preemption
        import threading

        self._stats_lock = threading.Lock()
        self._num_requests = 0
        self._inflight = 0
        self._draining = False
        self._drain_deadline: Optional[float] = None
        self._start_time = time.time()
        # live streaming responses: stream id -> iterator (the proxy pulls
        # batches of chunks with next_chunks until exhausted)
        self._streams: Dict[str, Any] = {}
        self._streams_lock = threading.Lock()

    def handle_request(self, method_name: str, args: Tuple, kwargs: Dict) -> Any:
        """Run one request (``replica.py:250`` handle_request analog).
        ``method_name='__call__'`` hits the callable itself.  During a
        drain's graceful window, requests that raced past a stale routing
        table still EXECUTE (the drain loop waits for them too — a handle
        caller must not see an error on a request the pre-drain replica
        would have served); only once the window has lapsed — when the
        controller is about to kill the actor anyway — does the typed
        refusal fire, so the caller gets a cleanly retryable error
        instead of a mid-execution RayActorError."""
        with self._stats_lock:
            if self._draining and (
                    self._drain_deadline is None
                    or time.monotonic() >= self._drain_deadline):
                raise ReplicaDrainingError(self.replica_tag)
            self._num_requests += 1
            self._inflight += 1
        try:
            return self._run_request(method_name, args, kwargs)
        finally:
            with self._stats_lock:
                self._inflight -= 1

    def _run_request(self, method_name: str, args: Tuple, kwargs: Dict) -> Any:
        if self._is_function:
            if method_name not in ("__call__", None):
                raise AttributeError(
                    f"function deployment {self.deployment_name!r} has no "
                    f"method {method_name!r}"
                )
            result = self.callable(*args, **kwargs)
        elif method_name == "__call__":
            if not callable(self.callable):
                raise TypeError(
                    f"deployment {self.deployment_name!r} defines no __call__; "
                    "invoke a named method via handle.<method>.remote()"
                )
            result = self.callable(*args, **kwargs)
        else:
            result = getattr(self.callable, method_name)(*args, **kwargs)
        from ray_tpu_torch.serve._private.http_util import (
            Request as _HttpRequest,
            StreamingResponse,
        )

        if isinstance(result, StreamingResponse):
            if not (args and isinstance(args[0], _HttpRequest)):
                raise TypeError(
                    "StreamingResponse is only supported for HTTP requests "
                    "(the proxy drains it incrementally); a DeploymentHandle "
                    "caller should return/iterate the data directly")
            return self._register_stream(result)
        return result

    def _register_stream(self, result) -> Dict[str, Any]:
        """Drain the generator on a dedicated thread into a bounded queue
        so follow-up ``next_chunks`` polls never BLOCK a replica executor
        thread between chunks (N slow streams would otherwise pin N
        threads and exhaust max_concurrency)."""
        import queue as queue_mod
        import threading
        import uuid

        from ray_tpu_torch.serve._private.http_util import encode_chunk

        sid = uuid.uuid4().hex
        state = {"q": queue_mod.Queue(maxsize=64), "done": False,
                 "error": None, "stop": threading.Event()}

        def drain(it=iter(result.iterable)):
            try:
                for chunk in it:
                    data = encode_chunk(chunk)
                    while not state["stop"].is_set():
                        try:
                            state["q"].put(data, timeout=0.2)
                            break
                        except queue_mod.Full:
                            continue
                    if state["stop"].is_set():
                        if hasattr(it, "close"):
                            it.close()
                        return
            except Exception as e:  # noqa: BLE001 — surfaced to the proxy
                state["error"] = f"{type(e).__name__}: {e}"
            finally:
                state["done"] = True

        threading.Thread(target=drain, daemon=True,
                         name=f"serve-stream-{sid[:8]}").start()
        with self._streams_lock:
            self._streams[sid] = state
        return {"__serve_stream__": sid, "content_type": result.content_type}

    def next_chunks(self, sid: str, max_n: int = 16) -> Dict[str, Any]:
        """Non-blocking drain of up to ``max_n`` buffered chunks; ``done``
        unregisters the stream, ``error`` carries a producer failure."""
        import queue as queue_mod

        with self._streams_lock:
            state = self._streams.get(sid)
        if state is None:
            return {"chunks": [], "done": True}
        chunks = []
        for _ in range(max_n):
            try:
                chunks.append(state["q"].get_nowait())
            except queue_mod.Empty:
                break
        finished = state["done"] and state["q"].empty()
        if finished:
            self.cancel_stream(sid)
        return {"chunks": chunks, "done": finished,
                "error": state["error"] if finished else None}

    def cancel_stream(self, sid: str) -> bool:
        with self._streams_lock:
            state = self._streams.pop(sid, None)
        if state is not None:
            state["stop"].set()
        return state is not None

    def reconfigure(self, user_config: Any) -> bool:
        """Apply a new ``user_config`` in place (deployment_state reconciler
        calls this instead of restarting the replica)."""
        if not self._is_function and hasattr(self.callable, "reconfigure"):
            self.callable.reconfigure(user_config)
        return True

    def ping(self) -> str:
        """Liveness probe: a dead worker fails the call with RayActorError,
        which is the controller's death signal."""
        return "pong"

    def stats(self) -> Dict[str, Any]:
        import os

        with self._stats_lock:
            inflight = self._inflight
            draining = self._draining
        return {
            "deployment": self.deployment_name,
            "replica_tag": self.replica_tag,
            "num_requests": self._num_requests,
            "inflight": inflight,
            "draining": draining,
            "pid": os.getpid(),
            "uptime_s": time.time() - self._start_time,
        }

    # -- graceful draining ---------------------------------------------
    def prepare_for_drain(self, grace_s: Optional[float] = None) -> Dict[str, Any]:
        """Begin draining: the controller calls this AFTER pulling the
        replica from the routing set, then polls :meth:`drain_status`
        until in-flight work hits zero (or the graceful window lapses)
        before killing the actor.  ``grace_s`` bounds the window in
        which racing requests are still served (see handle_request);
        None refuses new work immediately."""
        with self._stats_lock:
            self._draining = True
            self._drain_deadline = (
                time.monotonic() + grace_s if grace_s is not None else None)
        return self.drain_status()

    def drain_status(self) -> Dict[str, Any]:
        """{"inflight": n, "streams": m, "draining": bool} — zero inflight
        AND zero live streams means the replica is safe to terminate
        without losing accepted work."""
        with self._stats_lock:
            inflight = self._inflight
            draining = self._draining
        with self._streams_lock:
            streams = len(self._streams)
        return {"inflight": inflight, "streams": streams,
                "draining": draining}

    def prepare_for_shutdown(self) -> bool:
        """Graceful-shutdown hook: user callables may define ``__del__`` or
        ``shutdown``; call the latter if present."""
        if not self._is_function and hasattr(self.callable, "shutdown"):
            try:
                self.callable.shutdown()
            except Exception:
                pass
        return True
