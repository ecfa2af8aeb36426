"""CoreClient — every process's connection to the head runtime.

Plays the role of the reference's ``CoreWorker`` RPC surface
(``src/ray/core_worker/core_worker.h:249``): task submission, object
get/put/wait, actor creation/calls, KV access for function shipping.  Both
the driver and each worker hold one; replies are routed to blocked callers
by request id (the client-call manager pattern of ``src/ray/rpc/client_call.h``).
"""

from __future__ import annotations

import itertools
import pickle
import queue
import threading
import time
from multiprocessing.connection import Client as MPClient
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.object_store import ObjectLocation


def connect_control(address: str, authkey: bytes):
    """Open a wire-wrapped control-plane connection.

    Address is a unix-socket path or ``tcp://host:port`` (remote workers
    joining the head's TCP control plane).  The handshake occasionally
    loses a challenge race when several processes connect at once —
    retry, it is not a credentials problem.  Shared by CoreClient and
    the tenant driver relay (``util/client/driver.py``)."""
    from multiprocessing import AuthenticationError

    from ray_tpu_torch._private import wire

    if isinstance(address, str) and address.startswith("tcp://"):
        host, _, port = address[len("tcp://"):].rpartition(":")
        target, family = (host, int(port)), "AF_INET"
    else:
        target, family = address, "AF_UNIX"
    for attempt in range(5):
        try:
            return wire.wrap(
                MPClient(target, family=family, authkey=authkey))
        except (AuthenticationError, OSError, EOFError):
            if attempt == 4:
                raise
            time.sleep(0.05 * (attempt + 1))


class CoreClient:
    def __init__(self, address: str, authkey: bytes, worker_id: Optional[bytes] = None, node_id: str = "",
                 proxy_namespace: Optional[str] = None, proxy: bool = False):
        self.conn = connect_control(address, authkey)
        if proxy:
            # multi-tenant proxy mode (ray_tpu_torch://): ask the proxy to spawn
            # this connection's isolated driver subprocess, then the conn
            # becomes a transparent pipe to the head.  Done BEFORE the
            # recv loop starts — the handshake owns the socket.
            self.conn.send({"type": "proxy_hello",
                            "namespace": proxy_namespace})
            reply = self.conn.recv()
            mtype = reply.get("type")
            if mtype == "proxy_ready":
                pass  # this conn is now a pipe to our isolated driver
            elif mtype == "proxy_error":
                raise ConnectionError(
                    f"proxy refused connection: {reply.get('error')}")
            else:
                raise ConnectionError(
                    f"unexpected proxy handshake reply: {reply!r}")
        self.send_lock = threading.Lock()
        self._req_ids = itertools.count(1)
        self._pending: Dict[int, dict] = {}
        self._pending_lock = threading.Lock()
        # Submit coalescing: task/actor-task submissions buffer here and
        # ride one "submit_batch" message (the pipelined-pushes idea of the
        # reference's direct submitters, direct_actor_task_submitter.h:67,
        # applied to the wire).  Every other send flushes first, so
        # cross-message ordering on this connection is preserved; a 1 ms
        # side flusher bounds the latency of fire-and-forget submits.
        self._submit_buf: List[tuple] = []
        # Borrow-announcement coalescing: handle-reason add_refs buffer
        # here and ride ONE add_ref frame per flush tick (a get() wave
        # over a list of refs was one frame per ref).  Ordering stays
        # safe because every other send flushes this buffer FIRST — an
        # add_ref can arrive early (a transient extra pin, harmless) but
        # never after a remove_ref sent on this connection.
        self._ref_add_buf: List[bytes] = []
        self._submit_lock = threading.Lock()
        self._flush_event = threading.Event()
        self._flush_thread: Optional[threading.Thread] = None
        self._exec_queue: "queue.Queue[dict]" = None  # set by worker loop
        # worker-side cancellation hook: runs ON the recv thread so a
        # cancel can interrupt the main thread mid-task (the exec queue
        # would only deliver it after the task finished)
        self._cancel_handler = None
        # worker-side pipeline-reclaim hook: runs ON the recv thread for
        # the same reason — the main thread is blocked inside the current
        # task, so only this thread can drain the local queue
        self._reclaim_handler = None
        # worker-side profiling hook (dashboard on-demand profiling): runs
        # on its own thread — sampling blocks for the requested duration
        self._profile_handler = None
        self._subscriptions: Dict[str, list] = {}  # channel -> callbacks
        self._pubsub_queue = None  # created on first subscribe
        self._pubsub_lock = threading.Lock()
        self.worker_id = worker_id
        self.node_id = node_id
        self.closed = False
        self._recv_thread = threading.Thread(target=self._recv_loop, daemon=True, name="core-client-recv")
        self._recv_thread.start()

    # -- plumbing ----------------------------------------------------------
    def send(self, msg: dict) -> None:
        with self.send_lock:
            if self._ref_add_buf or self._submit_buf:
                self._flush_submits_locked()
            self.conn.send(msg)

    _SUBMIT_FLUSH_THRESHOLD = 32

    def _buffer_submit(self, kind: str, spec: dict) -> None:
        with self._submit_lock:
            self._submit_buf.append((kind, spec))
            n = len(self._submit_buf)
        if n >= self._SUBMIT_FLUSH_THRESHOLD:
            self.flush_submits()
        elif n == 1:
            # arm the deferred flush only on the empty->nonempty transition;
            # re-setting per submit made the flusher spin at 1 kHz
            self._arm_flusher()

    def flush_submits(self) -> None:
        with self.send_lock:
            if self._ref_add_buf or self._submit_buf:
                self._flush_submits_locked()

    def _flush_submits_locked(self) -> None:
        """send_lock held.  Lock order is always send_lock -> _submit_lock.
        Refs flush BEFORE submits: a buffered borrow announcement must
        precede any task spec that could reference the borrowed object."""
        with self._submit_lock:
            refs, self._ref_add_buf = self._ref_add_buf, []
            batch, self._submit_buf = self._submit_buf, []
        try:
            if refs:
                self.conn.send({"type": "add_ref", "oids": refs,
                                "reason": "handle"})
            if batch:
                self.conn.send({"type": "submit_batch", "batch": batch})
        except (OSError, ValueError):
            pass  # connection gone; recv loop surfaces it

    def _flush_loop(self) -> None:
        while not self.closed:
            self._flush_event.wait()
            time.sleep(0.001)
            self._flush_event.clear()
            if not self._submit_buf and not self._ref_add_buf:
                continue  # threshold flush already drained it
            try:
                self.flush_submits()
            except Exception:
                pass

    def _arm_flusher(self) -> None:
        """Start/poke the deferred flusher (empty->nonempty transitions)."""
        if self._flush_thread is None:
            with self._submit_lock:  # two transitions racing must not
                if self._flush_thread is None:  # start two flushers
                    self._flush_thread = threading.Thread(
                        target=self._flush_loop, daemon=True,
                        name="submit-flush")
                    self._flush_thread.start()
        self._flush_event.set()

    def _recv_loop(self) -> None:
        while not self.closed:
            try:
                msg = self.conn.recv()
            except (EOFError, OSError, pickle.UnpicklingError):
                # UnpicklingError covers wire.WireDecodeError: a corrupt
                # or version-mismatched frame is a broken connection, not
                # a reason to leave request() waiters hanging
                self.closed = True
                # wake all waiters with a connection error
                with self._pending_lock:
                    for slot in self._pending.values():
                        slot["reply"] = {"type": "reply", "error": "connection closed"}
                        slot["event"].set()
                if self._exec_queue is not None:
                    self._exec_queue.put({"type": "exit"})
                return
            if msg.get("type") == "reply":
                with self._pending_lock:
                    slot = self._pending.pop(msg["req_id"], None)
                if slot is not None:
                    slot["reply"] = msg
                    slot["event"].set()
            elif msg.get("type") == "pubsub":
                # dispatch on a side thread: a callback that itself issues
                # a request must not block the only thread that can ever
                # deliver that request's reply
                self._pubsub_dispatch(msg)
            elif msg.get("type") == "cancel" and self._cancel_handler is not None:
                try:
                    self._cancel_handler(msg)
                except Exception:
                    pass
            elif (msg.get("type") == "reclaim_pipeline"
                    and self._reclaim_handler is not None):
                try:
                    self._reclaim_handler(msg)
                except Exception:
                    pass
            elif msg.get("type") == "profile" and self._profile_handler is not None:
                threading.Thread(
                    target=self._profile_handler, args=(msg,), daemon=True,
                    name="profile-request",
                ).start()
            elif self._exec_queue is not None:
                self._exec_queue.put(msg)

    def request(self, msg: dict, timeout: Optional[float] = None) -> dict:
        req_id = next(self._req_ids)
        msg["req_id"] = req_id
        slot = {"event": threading.Event(), "reply": None}
        with self._pending_lock:
            self._pending[req_id] = slot
        self.send(msg)
        if not slot["event"].wait(timeout):
            with self._pending_lock:
                self._pending.pop(req_id, None)
            raise TimeoutError("head did not reply")
        reply = slot["reply"]
        if reply.get("error"):
            raise ConnectionError(reply["error"])
        return reply

    # -- API ---------------------------------------------------------------
    def register_client(self, namespace: Optional[str] = None,
                        job_name: Optional[str] = None) -> dict:
        """Register this driver and learn its identity: the head assigns a
        job id and resolves the namespace (multi-tenancy attribution —
        everything this connection creates is owned by that job).  In
        proxy mode the per-connection driver subprocess enriches this
        frame in flight with its own pid/namespace."""
        import os as _os

        reply = self.request({
            "type": "register_client",
            "namespace": namespace,
            "job_name": job_name,
            "pid": _os.getpid(),
        }, timeout=60)
        return reply["value"]

    def _pubsub_dispatch(self, msg: dict) -> None:
        q = self._pubsub_queue
        if q is not None:
            q.put(msg)

    def _pubsub_loop(self) -> None:
        import logging

        log = logging.getLogger(__name__)
        while not self.closed:
            msg = self._pubsub_queue.get()
            if msg is None:
                return
            for cb in list(self._subscriptions.get(msg["channel"], [])):
                try:
                    cb(msg["data"])
                except Exception:
                    log.exception("pubsub callback for channel %r failed",
                                  msg["channel"])

    def subscribe(self, channel: str, callback) -> None:
        """Register a callback for a pubsub channel (Subscriber analog).
        Callbacks run on a dedicated dispatcher thread and may use the
        full client API."""
        with self._pubsub_lock:
            if self._pubsub_queue is None:
                self._pubsub_queue = queue.Queue()
                threading.Thread(target=self._pubsub_loop, daemon=True,
                                 name="pubsub-dispatch").start()
            first = channel not in self._subscriptions
            self._subscriptions.setdefault(channel, []).append(callback)
        if first:
            self.send({"type": "subscribe", "channel": channel})

    def unsubscribe(self, channel: str, callback=None) -> None:
        cbs = self._subscriptions.get(channel, [])
        if callback is None:
            cbs.clear()
        elif callback in cbs:
            cbs.remove(callback)
        if not cbs:
            self._subscriptions.pop(channel, None)
            self.send({"type": "unsubscribe", "channel": channel})

    def publish(self, channel: str, data) -> None:
        self.send({"type": "publish", "channel": channel, "data": data})

    def register_worker(self) -> None:
        self.send({
            "type": "register_worker",
            "worker_id": self.worker_id.hex(),
            "node_id": self.node_id,
        })

    def submit_task(self, spec: dict) -> None:
        self._buffer_submit("task", spec)

    def create_actor(self, spec: dict) -> None:
        self.send({"type": "create_actor", "spec": spec})

    def submit_actor_task(self, spec: dict) -> None:
        self._buffer_submit("actor_task", spec)

    def kill_actor(self, actor_id: bytes, no_restart: bool = True) -> None:
        self.send({"type": "kill_actor", "actor_id": actor_id, "no_restart": no_restart})

    def cancel_task(self, oid: bytes, force: bool = False,
                    recursive: bool = True) -> None:
        reply = self.request({"type": "cancel_task", "oid": oid,
                              "force": force, "recursive": recursive})
        err = reply.get("value")
        if err:
            raise ValueError(err)

    def seal(self, oid: bytes, loc: ObjectLocation, contained: List[bytes]) -> None:
        self.send({"type": "seal", "oid": oid, "loc": loc, "contained": contained})

    def get_locations(
        self, oids: List[bytes], timeout: Optional[float] = None
    ) -> Optional[Dict[bytes, ObjectLocation]]:
        """Blocks until all oids are sealed (or timeout -> None)."""
        reply = self.request({"type": "get_locations", "oids": oids, "timeout": timeout})
        if reply.get("timeout"):
            return None
        return reply["locations"]

    def wait(
        self, oids: List[bytes], num_returns: int, timeout: Optional[float]
    ) -> Tuple[List[bytes], Dict[bytes, ObjectLocation]]:
        reply = self.request({
            "type": "wait", "oids": oids, "num_returns": num_returns, "timeout": timeout,
        })
        return reply["ready"], reply["locations"]

    def kv_put(self, ns: str, key: bytes, value: bytes) -> None:
        self.send({"type": "kv_put", "ns": ns, "key": key, "value": value})

    def kv_get(self, ns: str, key: bytes, timeout: float = 30.0) -> Optional[bytes]:
        return self.request({"type": "kv_get", "ns": ns, "key": key}, timeout=timeout)["value"]

    def notify_blocked(self) -> None:
        self.send({"type": "blocked"})

    def notify_unblocked(self) -> None:
        self.send({"type": "unblocked"})

    _REF_FLUSH_THRESHOLD = 256

    def add_refs(self, oids: List[bytes], reason: str = "handle") -> None:
        """``reason`` labels the pin in the head's ownership audit
        ("handle" for live ObjectRefs, "task_arg" for spec-build arg
        pins); lifetime accounting is reason-agnostic.  Handle-reason
        announcements coalesce per flush tick (see _ref_add_buf); other
        reasons ship inline — their senders already batch per task."""
        if reason == "handle":
            with self._submit_lock:
                self._ref_add_buf.extend(oids)
                n = len(self._ref_add_buf)
            if n >= self._REF_FLUSH_THRESHOLD:
                self.flush_submits()
            elif n == len(oids):  # empty -> nonempty transition
                self._arm_flusher()
            return
        self.send({"type": "add_ref", "oids": oids, "reason": reason})

    def remove_refs(self, oids: List[bytes], reason: str = "handle") -> None:
        self.send({"type": "remove_ref", "oids": oids, "reason": reason})

    def broadcast(self, oid: bytes, timeout: float = 120.0) -> dict:
        return self.request({"type": "broadcast", "oid": oid,
                             "timeout": timeout}, timeout=timeout + 60)["value"]

    def create_pg(self, spec: dict) -> None:
        self.send({"type": "create_pg", "spec": spec})

    def remove_pg(self, pg_id: bytes) -> None:
        self.send({"type": "remove_pg", "pg_id": pg_id})

    def get_actor_by_name(self, name: str, namespace: Optional[str] = None):
        return self.request({"type": "get_actor_by_name", "name": name,
                             "namespace": namespace})["value"]

    def state_snapshot(self) -> dict:
        return self.request({"type": "state_snapshot"})["value"]

    def close(self) -> None:
        try:
            self.flush_submits()
        except Exception:
            pass
        self.closed = True
        self._flush_event.set()  # let the flusher thread exit
        from ray_tpu_torch._private.netutil import force_close_connection

        # shutdown(2) wakes the recv thread; close alone would leave it
        # parked forever (the per-session thread leak)
        force_close_connection(self.conn)
        if self._pubsub_queue is not None:
            self._pubsub_queue.put(None)  # end the dispatcher thread
        try:
            self.conn.close()
        except Exception:
            pass
