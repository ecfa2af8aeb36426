"""Compiled execution graphs: static actor DAGs over pre-allocated channels.

The reference's Compiled Graphs (aDAG, ``python/ray/dag/compiled_dag_node.py``)
applied to this runtime: ``dag.experimental_compile()`` schedules a
ClassMethodNode graph ONCE — after compile, a repeated ``execute()`` pays
zero scheduler involvement.  Every actor in the graph runs a persistent
execution loop on a dedicated thread (installed through the
``compiled_graph`` task lane in ``actor.py``/``_private/worker.py``, so the
loop never occupies the normal method lane), and every edge is a
pre-allocated channel (``dag/channel.py``): a fixed-slot SPSC shm ring for
same-node edges, an ``object_transfer``-style authenticated stream for
cross-node edges.  The dynamic path re-submits every node per call — each
hop paying dispatch + object-plane sealing; here a call is just channel
hops, which is what pipeline-parallel schedules and prefill→decode serving
need to keep up with a card's step times.

Compile protocol (driver-side, three actor round trips, all at compile
time only):

1. ``locality`` — each actor reports ``(hostname, shm_dir)``; comparing
   endpoint localities picks each edge's transport.
2. ``prepare`` — each actor creates its OUT-edge resources (shm rings in
   its node's namespace / stream listeners) and returns stream addresses.
3. ``start`` — each actor attaches its IN-edge readers and starts the loop.

Execution semantics:

- ``compiled.execute(x)`` writes the input into the entry channels and
  returns a :class:`CompiledDAGRef`; results are read from the output
  channel strictly in submission order (the static schedule makes per-seq
  ordering deterministic), buffered for out-of-order ``get``.
- In-flight executions are bounded by the channel slot count
  (``max_inflight``): a full ring backpressures ``execute``.
- A node exception becomes an error payload (``FLAG_ERROR``) that flows
  THROUGH downstream nodes (they skip execution and forward it) and
  re-raises on ``get`` — the graph itself survives and keeps serving.
- Actor death cannot hang the caller: ``get`` interleaves channel waits
  with actor-liveness checks against the head and raises
  :class:`ray_tpu_torch.exceptions.ActorDiedError`.
- ``teardown()`` poisons every channel (waking any blocked loop), asks
  each live actor to join its loop and unlink its segments, and is
  idempotent.

Observability: per-node execution spans and channel-wait spans are emitted
on the ``compiled_dag`` flight-recorder source (``_private/events.py``),
so the events show the pipeline's bubble structure beside the task
records.  When ``execute()`` runs inside a
``tracing.trace()`` block, the caller's context rides the channel
payloads (:class:`_Traced`): every node's exec/channel-wait span joins
the request's trace, stages chain parent→child, recv waits are clamped
to the request's entry time (loop idle never bills to a trace), and
the trace's spans attribute the request's wall time across node
execution vs channel wait vs result wait.  Untraced executions
serialize bare values — nothing changes off-trace.

Limitations vs the reference aDAG: DAG nodes must be actor method calls
(no bare task nodes), node arguments may reference other nodes only at
top level (no nesting inside containers), one output node, asyncio actors
not special-cased, ObjectRefs cannot ride channel payloads (nothing would
pin them; loudly rejected).  Concurrency caveat: compiled
methods run on the graph's dedicated loop thread — they are serialized
against each other but NOT against normal ``.remote()`` method calls on
the same actor (same tradeoff as the reference's aDAG executor thread),
so an actor serving both lanes concurrently must guard shared state
itself.
"""

from __future__ import annotations

import os
import socket
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import events as _events
from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.locks import make_lock
from ray_tpu_torch.util import tracing as _tracing
from ray_tpu_torch.dag.channel import (
    FLAG_ERROR,
    ChannelClosedError,
    ChannelTimeoutError,
    ShmChannel,
    StreamReaderChannel,
    StreamWriterChannel,
)
from ray_tpu_torch.dag.dag_node import ClassMethodNode, ClassNode, InputNode, _DAGInput
from ray_tpu_torch.exceptions import ActorDiedError, RayTaskError

DRIVER = -1  # endpoint index for the driver process
_SOURCE = "compiled_dag"  # flight-recorder source for node/channel spans
# channel waits shorter than this don't emit a span (ring-buffer noise)
_WAIT_SPAN_MIN_S = 0.001


class CompiledGraphError(Exception):
    """Compiled-graph lifecycle error (bad graph shape, use after
    teardown, capacity exceeded)."""


def _ser(value: Any) -> bytes:
    meta, buffers, refs = serialization.serialize(value)
    if refs:
        # Channel payloads bypass the object plane entirely, so nothing
        # would pin the referenced objects for the consumer (the submit
        # path pins via client.add_refs; here the producer has no idea
        # when the consumer's borrow registers).  A silent use-after-free
        # is worse than a loud rejection.
        raise ValueError(
            "ObjectRefs cannot pass through compiled-graph channels "
            f"({len(refs)} found); pass the value itself, or ray_tpu_torch.get "
            "it first")
    return serialization.to_bytes(meta, buffers)


def _deser(payload: bytes) -> Any:
    return serialization.deserialize(memoryview(payload))


def _ser_error(err: BaseException) -> bytes:
    """Serialize an error payload, falling back to a string-only
    RayTaskError when the user's exception itself won't pickle (custom
    __init__ signatures, captured locks/sockets, embedded ObjectRefs) —
    an unserializable error must degrade, not kill the loop."""
    try:
        return _ser(err)
    except Exception:
        return _ser(RayTaskError(
            f"{type(err).__name__}: {err} "
            f"(original exception not serializable)"))


def _deser_error(payload: bytes) -> BaseException:
    """Deserialize an error payload; a class importable on the producer
    but not here still yields a usable error object."""
    try:
        err = _deser(payload)
    except Exception as e:  # noqa: BLE001
        return RayTaskError(
            f"upstream compiled-graph error could not be deserialized: {e}")
    if isinstance(err, BaseException):
        return err
    return RayTaskError(f"upstream compiled-graph error: {err!r}")


def _locality() -> Tuple[str, str]:
    from ray_tpu_torch._private.shm import shm_dir

    return (socket.gethostname(), shm_dir())


# ---------------------------------------------------------------------------
# Plan structures (driver builds them; actors receive them cloudpickled)
# ---------------------------------------------------------------------------


class _TaskPlan:
    """One ClassMethodNode's slice of the compiled schedule."""

    __slots__ = ("idx", "method", "args", "kwargs", "in_edges", "out_edges",
                 "label")

    def __init__(self, idx: int, method: str, args: list, kwargs: dict,
                 in_edges: List[int], out_edges: List[int], label: str):
        self.idx = idx
        self.method = method
        self.args = args          # list of ("const", v) | ("edge", eid)
        self.kwargs = kwargs      # name -> same spec
        self.in_edges = in_edges  # ALL in-edge ids (incl. trigger edges)
        self.out_edges = out_edges
        self.label = label


class _ErrVal:
    """An error flowing through the graph as a value."""

    __slots__ = ("err",)

    def __init__(self, err: BaseException):
        self.err = err


class _Traced:
    """A channel payload carrying its trace context alongside the value.

    When ``execute()`` runs inside a ``tracing.trace()`` block, the input
    payload is wrapped so the context rides the channel with the data —
    each node loop unwraps it, emits its exec/channel-wait spans as
    children of the caller's trace, and re-wraps its output with its own
    span as the parent (so a pipeline's spans chain stage to stage).
    Untraced executions serialize the bare value: zero overhead and
    byte-identical payloads when tracing is unused."""

    __slots__ = ("ctx", "value")

    def __init__(self, ctx: Dict[str, str], value: Any):
        self.ctx = ctx
        self.value = value

    def __reduce__(self):
        return (_Traced, (self.ctx, self.value))


# ---------------------------------------------------------------------------
# Actor-side execution (runs inside the actor's worker process)
# ---------------------------------------------------------------------------

_LOCAL_GRAPHS: Dict[str, "_ActorGraph"] = {}
_LOCAL_LOCK = make_lock("compiled.local_channels")


class _ActorGraph:
    """Per-actor compiled-graph state living in the actor's worker."""

    def __init__(self, gid: str, tasks: List[_TaskPlan], authkey: bytes):
        self.gid = gid
        self.tasks = tasks
        self.authkey = authkey
        self.writers: Dict[int, Any] = {}   # eid -> writer channel
        self.readers: Dict[int, Any] = {}   # eid -> reader channel
        self.owned_segments: List[str] = []
        self.thread: Optional[threading.Thread] = None
        self.stop = threading.Event()

    # -- loop ----------------------------------------------------------
    def run_loop(self) -> None:
        seq = 0
        try:
            while not self.stop.is_set():
                self._run_one(seq)
                seq += 1
        except ChannelClosedError:
            pass  # teardown or upstream poison: exit (and cascade below)
        except BaseException as e:  # pragma: no cover - defensive
            _events.emit(_SOURCE, "actor loop died", severity="ERROR",
                         entity_id=self.gid, error=repr(e))
        finally:
            # ANY exit poisons this actor's out-edges: a mid-chain loop
            # death (internal error OR an upstream poison arriving outside
            # teardown) must cascade, or downstream loops and the driver's
            # get() would block on a silently-dead producer forever
            for w in self.writers.values():
                try:
                    w.poison()
                except Exception:
                    pass

    def _read_inputs(self, task: _TaskPlan, seq: int):
        """Read every in-edge; returns (vals, waits) where waits carries
        each edge's blocked time AND its wall-clock completion — emitted
        as channel-wait spans by the caller AFTER trace-context
        extraction (the lineage rides the payloads), each stamped at its
        own end time so sequential waits on a multi-input node render as
        sequential, not stacked at emission time."""
        vals: Dict[int, Any] = {}
        waits: List[Tuple[int, float, float]] = []  # (eid, waited, t_end)
        for eid in task.in_edges:
            t0 = time.perf_counter()
            while True:
                if self.stop.is_set():
                    raise ChannelClosedError("graph torn down")
                try:
                    payload, flags = self.readers[eid].get(timeout=1.0)
                    break
                except ChannelTimeoutError:
                    continue
            waits.append((eid, time.perf_counter() - t0, time.time()))
            if flags & FLAG_ERROR:
                vals[eid] = _ErrVal(_deser_error(payload))
            else:
                vals[eid] = _deser(payload)
        return vals, waits

    def _run_one(self, seq: int) -> None:
        from ray_tpu_torch.util.tracing import new_span_id, span_fields

        instance = self.instance
        for task in self.tasks:
            vals, waits = self._read_inputs(task, seq)
            # a traced execution's context rides the payload: unwrap, and
            # chain this node's spans under it
            ctx = None
            for eid, v in vals.items():
                if isinstance(v, _Traced):
                    ctx = ctx or v.ctx
                    vals[eid] = v.value
            node_ctx = None
            if ctx is not None:
                node_ctx = {"trace_id": ctx["trace_id"],
                            "span_id": new_span_id(),
                            "parent_span_id": ctx["span_id"],
                            "name": task.label}
                if "t0" in ctx:
                    node_ctx["t0"] = ctx["t0"]  # downstream clamps too
            # traced recv waits are clamped to the request's entry time: a
            # loop that sat idle for minutes BEFORE this request was
            # submitted must not charge that idle to the request's trace.
            # t0 is the DRIVER's wall clock; a consumer clock behind it by
            # more than the wait would push (t_end - t0) negative and erase
            # a genuine wait, so the clamp only applies while it is
            # positive — then the full wait is kept (idle billing is a
            # smaller lie than erasing the wait).  No skew headroom: on one
            # clock it started idle waits up to that much before the
            # request.
            req_t0 = None
            if node_ctx is not None and "t0" in node_ctx:
                req_t0 = float(node_ctx["t0"])
            for eid, waited, t_end in waits:
                if req_t0 is not None:
                    headroom = t_end - req_t0
                    if headroom > 0:
                        waited = min(waited, headroom)
                if waited >= _WAIT_SPAN_MIN_S:
                    # ts=t_end: each edge's span sits at ITS completion,
                    # so sequential waits render sequentially
                    _events.emit(_SOURCE, "channel wait", severity="DEBUG",
                                 entity_id=f"{self.gid}:{task.label}",
                                 span_dur=waited, ts=t_end, edge=eid,
                                 seq=seq, op="recv",
                                 **span_fields(node_ctx, "channel_wait"))
            err = next((v for v in vals.values() if isinstance(v, _ErrVal)),
                       None)
            if err is not None:
                out_payload, out_flags = _ser_error(err.err), FLAG_ERROR
            else:
                t0 = time.perf_counter()
                try:
                    args = [vals[s[1]] if s[0] == "edge" else s[1]
                            for s in task.args]
                    kwargs = {k: (vals[s[1]] if s[0] == "edge" else s[1])
                              for k, s in task.kwargs.items()}
                    result = getattr(instance, task.method)(*args, **kwargs)
                    if node_ctx is not None:
                        # downstream nodes (and the driver's output) chain
                        # under THIS node's span
                        result = _Traced(node_ctx, result)
                    out_payload, out_flags = _ser(result), 0
                except BaseException as e:  # noqa: BLE001 — user node error
                    tb = traceback.format_exc()
                    wrapped = e if isinstance(e, RayTaskError) else RayTaskError(
                        f"Compiled DAG node {task.label} failed:\n{tb}", cause=e)
                    out_payload, out_flags = _ser_error(wrapped), FLAG_ERROR
                # the exec span IS the node's own span (node_ctx), parented
                # to the incoming context
                _events.emit(_SOURCE, task.label, severity="DEBUG",
                             entity_id=f"{self.gid}:{task.label}",
                             span_dur=time.perf_counter() - t0, seq=seq,
                             **span_fields(
                                 ctx, "node_exec",
                                 span_id=(node_ctx or {}).get("span_id")))
            for eid in task.out_edges:
                t0 = time.perf_counter()
                while True:
                    if self.stop.is_set():
                        raise ChannelClosedError("graph torn down")
                    try:
                        self.writers[eid].put(out_payload, out_flags,
                                              timeout=1.0)
                        break
                    except ChannelTimeoutError:
                        continue
                waited = time.perf_counter() - t0
                if waited >= _WAIT_SPAN_MIN_S:
                    _events.emit(_SOURCE, "channel wait", severity="DEBUG",
                                 entity_id=f"{self.gid}:{task.label}",
                                 span_dur=waited, edge=eid, seq=seq,
                                 op="send",
                                 **span_fields(node_ctx, "channel_wait"))

    # -- teardown ------------------------------------------------------
    def teardown(self) -> None:
        self.stop.set()
        for ch in list(self.writers.values()) + list(self.readers.values()):
            try:
                ch.poison()
            except Exception:
                pass
        if self.thread is not None:
            self.thread.join(timeout=5.0)
        for ch in list(self.writers.values()) + list(self.readers.values()):
            try:
                ch.close()
            except Exception:
                pass
        from ray_tpu_torch._private.shm import ShmSegment

        for name in self.owned_segments:
            ShmSegment.unlink(name)


def _cdag_rpc(instance, op: str, blob: bytes = b"") -> Any:
    """Single actor-side entry point for all compiled-graph control ops.

    Submitted through the ``compiled_graph`` task lane
    (``ActorHandle._submit_compiled_task``): the worker executes it with
    the actor INSTANCE as first argument, outside the normal
    ``getattr(instance, method)`` path.  The ops themselves return
    quickly — the execution loop runs on its own daemon thread, so it
    never occupies the task lane.
    """
    import cloudpickle

    if op == "locality":
        return _locality()

    if op == "prepare":
        plan = cloudpickle.loads(blob)
        g = _ActorGraph(plan["gid"], plan["tasks"], plan["authkey"])
        addrs: Dict[int, tuple] = {}
        for eid, spec in plan["out_channels"].items():
            if spec["kind"] == "shm":
                ch = ShmChannel.create(spec["name"], spec["slots"],
                                       spec["slot_bytes"])
                g.owned_segments.append(spec["name"])
            else:
                ch = StreamWriterChannel(spec["slots"], plan["authkey"])
                addrs[eid] = ch.addr
            g.writers[eid] = ch
        with _LOCAL_LOCK:
            _LOCAL_GRAPHS[plan["gid"]] = g
        return addrs

    if op == "start":
        info = cloudpickle.loads(blob)
        with _LOCAL_LOCK:
            g = _LOCAL_GRAPHS[info["gid"]]
        for eid, spec in info["in_channels"].items():
            if spec["kind"] == "shm":
                g.readers[eid] = ShmChannel.attach(spec["name"])
            else:
                g.readers[eid] = StreamReaderChannel(spec["addr"], g.authkey)
        g.instance = instance
        g.thread = threading.Thread(
            target=g.run_loop, daemon=True,
            name=f"cdag-loop-{info['gid'][:8]}")
        g.thread.start()
        return "ok"

    if op == "teardown":
        with _LOCAL_LOCK:
            g = _LOCAL_GRAPHS.pop(blob.decode() if blob else "", None)
        if g is not None:
            g.teardown()
        return "ok"

    raise ValueError(f"unknown compiled-graph op {op!r}")


# ---------------------------------------------------------------------------
# Driver side
# ---------------------------------------------------------------------------


class CompiledDAGRef:
    """Handle to one compiled-graph execution's output.

    ``ray_tpu_torch.get`` accepts it alongside ObjectRefs; :meth:`get` reads the
    pre-allocated output channel directly (no object plane).  Dropping the
    ref without ``get`` releases its buffered result (a serving loop that
    abandons timed-out requests must not leak driver memory)."""

    __slots__ = ("_dag", "seq", "__weakref__")

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self.seq = seq

    def get(self, timeout: Optional[float] = None) -> Any:
        return self._dag._get_result(self.seq, timeout)

    def __del__(self):
        # lock-free (a GC pass may fire mid-locked-section on this very
        # thread): enqueue only; drained under the dag lock
        try:
            self._dag._abandoned_q.append(self.seq)
        except Exception:
            pass

    def __repr__(self) -> str:
        return f"CompiledDAGRef(seq={self.seq})"


class CompiledDAG:
    """A compiled static actor DAG.  Build via
    ``dag.experimental_compile(...)``; see the module docstring."""

    def __init__(self, root, *, max_inflight: int = 8,
                 slot_bytes: int = 1 << 20,
                 submit_timeout: float = 30.0,
                 get_timeout: Optional[float] = None):
        from ray_tpu_torch._private.worker import global_worker

        if global_worker.thin_client:
            raise CompiledGraphError(
                "compiled graphs require a co-located driver (thin "
                "client:// drivers share no data plane with the cluster)")
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self._w = global_worker
        self._max_inflight = max_inflight
        self._slot_bytes = slot_bytes
        self._submit_timeout = submit_timeout
        self._get_timeout = get_timeout
        self._gid = os.urandom(6).hex()  # raylint: disable=R3 (per compile)
        self._torn_down = False
        self._lock = make_lock("compiled.graph")
        self._seq = 0            # next execution index to submit
        self._next_out = 0       # next seq expected from the output channel
        self._results: Dict[int, Tuple[bytes, int]] = {}
        # consumed-seq tracking in O(max_inflight) memory: everything below
        # the low-water mark is consumed; the set holds out-of-order gets
        self._fetched_below = 0
        self._fetched: set = set()
        # refs dropped without get(): finalizers append here (deque append
        # is atomic + lock-free — the worker.py _dead_handles pattern);
        # drained under the lock so their buffered results are released
        from collections import deque

        self._abandoned_q: "deque" = deque()
        # traced executions: seq -> the execute-span context (result-wait
        # spans chain under it); popped when the seq is consumed, so the
        # dict mirrors _results' lifecycle and stays bounded
        self._trace_ctxs: Dict[int, dict] = {}
        self._broken: Optional[str] = None  # set on a partial input write
        try:
            self._compile(root)
        except BaseException:
            # release whatever the partial compile built (actors,
            # prepared loops, listeners, segments) — the caller never
            # gets a handle to teardown
            try:
                self.teardown()
            except Exception:
                pass
            raise

    # -- compilation ---------------------------------------------------
    def _compile(self, root) -> None:
        import ray_tpu_torch

        topo = root.topological()
        if not isinstance(root, ClassMethodNode):
            raise CompiledGraphError(
                "compiled DAGs must be rooted at an actor method node "
                f"(got {type(root).__name__}); bare task nodes are not "
                "supported")
        method_nodes: List[ClassMethodNode] = []
        input_nodes: List[InputNode] = []
        for n in topo:
            if isinstance(n, ClassMethodNode):
                method_nodes.append(n)
            elif isinstance(n, InputNode):
                input_nodes.append(n)
            elif not isinstance(n, ClassNode):
                raise CompiledGraphError(
                    f"unsupported node type in compiled DAG: "
                    f"{type(n).__name__}")
        if len(input_nodes) > 1:
            raise CompiledGraphError("compiled DAGs take a single InputNode")

        # create the actors (ClassNodes ran through the dynamic path keep
        # one actor per node instance — same semantics here)
        idx_of = {id(n): i for i, n in enumerate(method_nodes)}
        self.actors: List[Any] = []
        actor_of_node: List[int] = []  # method idx -> actor slot
        actor_slots: Dict[int, int] = {}  # id(class_node) -> actor slot
        for n in method_nodes:
            cn = n._class_node
            slot = actor_slots.get(id(cn))
            if slot is None:
                if any(_contains_node(a) for a in cn._bound_args) or any(
                        _contains_node(v) for v in cn._bound_kwargs.values()):
                    raise CompiledGraphError(
                        "node references in actor constructor arguments "
                        "are not supported in compiled DAGs (create the "
                        "value eagerly or pass it through the method "
                        "call instead)")
                args = tuple(cn._resolve(a, {}) for a in cn._bound_args)
                kwargs = {k: cn._resolve(v, {})
                          for k, v in cn._bound_kwargs.items()}
                handle = cn._execute_impl(args, kwargs)
                slot = len(self.actors)
                actor_slots[id(cn)] = slot
                self.actors.append(handle)
            actor_of_node.append(slot)

        # edges: one SPSC channel per (producer, consumer-node) pair
        edges: List[dict] = []   # {writer: idx|DRIVER, reader: idx|DRIVER}
        edge_ids: Dict[Tuple[int, int], int] = {}

        def edge(writer: int, reader: int) -> int:
            key = (writer, reader)
            eid = edge_ids.get(key)
            if eid is None:
                eid = len(edges)
                edge_ids[key] = eid
                edges.append({"writer": writer, "reader": reader})
            return eid

        def argspec(v, consumer: int):
            if isinstance(v, InputNode):
                return ("edge", edge(DRIVER, consumer))
            if isinstance(v, ClassMethodNode):
                return ("edge", edge(idx_of[id(v)], consumer))
            if isinstance(v, ClassNode):
                raise CompiledGraphError(
                    "actor handles cannot be passed as compiled DAG "
                    "arguments")
            if isinstance(v, (list, tuple, dict)) and _contains_node(v):
                raise CompiledGraphError(
                    "compiled DAGs support node references only at "
                    "top-level argument positions (no nesting inside "
                    "containers)")
            return ("const", v)

        plans: List[_TaskPlan] = []
        for j, n in enumerate(method_nodes):
            args = [argspec(a, j) for a in n._bound_args]
            kwargs = {k: argspec(v, j) for k, v in n._bound_kwargs.items()}
            label = f"{n._method_name}:{j}"
            plans.append(_TaskPlan(j, n._method_name, args, kwargs, [], [],
                                   label))
        # every task with no in-edges still needs a driver trigger edge to
        # pace its loop (a source node would otherwise free-run)
        for j, p in enumerate(plans):
            ins = sorted({s[1] for s in p.args if s[0] == "edge"}
                         | {s[1] for s in p.kwargs.values() if s[0] == "edge"})
            if not ins:
                ins = [edge(DRIVER, j)]
            p.in_edges = ins
        out_eid = edge(idx_of[id(root)], DRIVER)
        for eid, e in enumerate(edges):
            if e["writer"] != DRIVER:
                plans[e["writer"]].out_edges.append(eid)
        self._edges = edges
        self._out_eid = out_eid

        # -- locality gather (round trip 1) ----------------------------
        loc_refs = [h._submit_compiled_task(_cdag_rpc, ("locality",),
                                            name="cdag.locality")
                    for h in self.actors]
        localities = ray_tpu_torch.get(loc_refs, timeout=120)
        driver_loc = _locality()

        from ray_tpu_torch._private.shm import session_shm_name

        authkey = self._authkey()
        for eid, e in enumerate(edges):
            wloc = driver_loc if e["writer"] == DRIVER else \
                localities[actor_of_node[e["writer"]]]
            rloc = driver_loc if e["reader"] == DRIVER else \
                localities[actor_of_node[e["reader"]]]
            e["kind"] = "shm" if wloc == rloc else "stream"
            if e["kind"] == "shm":
                e["name"] = session_shm_name(f"cdag{self._gid}e{eid}")

        # -- prepare (round trip 2): writers create their channels ------
        import cloudpickle

        prep_refs = []
        for slot, h in enumerate(self.actors):
            my_tasks = [p for j, p in enumerate(plans)
                        if actor_of_node[j] == slot]
            out_channels = {}
            for p in my_tasks:
                for eid in p.out_edges:
                    e = edges[eid]
                    spec = {"kind": e["kind"], "slots": self._max_inflight,
                            "slot_bytes": self._slot_bytes}
                    if e["kind"] == "shm":
                        spec["name"] = e["name"]
                    out_channels[eid] = spec
            plan = {"gid": self._gid, "tasks": my_tasks, "authkey": authkey,
                    "out_channels": out_channels}
            prep_refs.append(h._submit_compiled_task(
                _cdag_rpc, ("prepare", cloudpickle.dumps(plan)),
                name="cdag.prepare"))
        stream_addrs: Dict[int, tuple] = {}
        for reply in ray_tpu_torch.get(prep_refs, timeout=120):
            stream_addrs.update(reply)
        # driver-side writers (input/trigger edges)
        self._writers: Dict[int, Any] = {}
        self._input_eids: List[int] = []
        for eid, e in enumerate(edges):
            if e["writer"] != DRIVER:
                continue
            self._input_eids.append(eid)
            if e["kind"] == "shm":
                self._writers[eid] = ShmChannel.create(
                    e["name"], self._max_inflight, self._slot_bytes)
            else:
                ch = StreamWriterChannel(self._max_inflight, authkey)
                stream_addrs[eid] = ch.addr
                self._writers[eid] = ch

        # -- start (round trip 3): readers attach, loops start ----------
        start_refs = []
        for slot, h in enumerate(self.actors):
            in_channels = {}
            for j, p in enumerate(plans):
                if actor_of_node[j] != slot:
                    continue
                for eid in p.in_edges:
                    e = edges[eid]
                    if e["kind"] == "shm":
                        in_channels[eid] = {"kind": "shm", "name": e["name"]}
                    else:
                        in_channels[eid] = {"kind": "stream",
                                            "addr": stream_addrs[eid]}
            info = {"gid": self._gid, "in_channels": in_channels}
            start_refs.append(h._submit_compiled_task(
                _cdag_rpc, ("start", cloudpickle.dumps(info)),
                name="cdag.start"))
        ray_tpu_torch.get(start_refs, timeout=120)
        out_e = edges[out_eid]
        if out_e["kind"] == "shm":
            self._reader = ShmChannel.attach(out_e["name"])
        else:
            self._reader = StreamReaderChannel(stream_addrs[out_eid], authkey)
        self._actor_ids = {h._actor_id.hex() for h in self.actors}
        # restart-detection baseline, snapshotted NOW: a ClassNode caches
        # its actor handle, so compile may adopt an actor that already
        # restarted before this graph existed — only a restart AFTER the
        # loops were installed means the graph's state died with an
        # incarnation
        self._baseline_restarts: Dict[str, int] = {}
        try:
            rows = self._actor_rows()
            self._baseline_restarts = {
                r["actor_id"]: r.get("num_restarts") or 0
                for r in rows if r.get("actor_id") in self._actor_ids}
        except Exception:
            pass  # conservative default 0 per actor
        _events.emit(_SOURCE, "graph compiled", entity_id=self._gid,
                     nodes=len(plans), actors=len(self.actors),
                     edges=len(edges),
                     stream_edges=sum(e["kind"] == "stream" for e in edges))

    # -- execution -----------------------------------------------------
    def execute(self, *args, **kwargs) -> CompiledDAGRef:
        """Run the graph once; returns a ref for the root node's output.
        Blocks only when ``max_inflight`` executions are already queued
        (channel backpressure)."""
        with self._lock:
            if self._torn_down:
                raise CompiledGraphError("compiled DAG is torn down")
            if self._broken:
                raise CompiledGraphError(
                    f"compiled DAG is broken ({self._broken}); teardown() "
                    f"and recompile")
            if len(args) == 1 and not kwargs:
                value = args[0]
            else:
                value = _DAGInput(args, kwargs)
            # a traced caller's context rides the channel payload: every
            # node loop's exec/channel-wait spans join this trace
            exec_ctx = None
            if _events.ENABLED:
                exec_ctx = _tracing.child_context(f"cdag.execute {self._gid[:6]}")
                if exec_ctx is not None:
                    # t0 = when the request entered the graph: node loops
                    # clamp their recv-wait spans to it, so idle-before-
                    # request time is never attributed to this trace
                    exec_ctx["t0"] = time.time()
                    value = _Traced(exec_ctx, value)
            payload = _ser(value)
            seq = self._seq
            deadline = time.monotonic() + self._submit_timeout
            t0 = time.perf_counter()
            # reserve-then-write: wait until EVERY input edge can accept
            # (draining completed outputs meanwhile), then write all of
            # them.  The driver is each edge's only writer, so a True
            # can_put() cannot be invalidated — the writes can't block,
            # and a timeout here leaves NO partial submission behind
            # (partial writes would desync the edges' seq pairing forever)
            while not all(self._writers[eid].can_put()
                          for eid in self._input_eids):
                self._drain_output(block=True)
                if self._broken:
                    raise CompiledGraphError(
                        f"compiled DAG is broken ({self._broken}); "
                        f"teardown() and recompile")
                if time.monotonic() >= deadline:
                    self._check_alive()
                    raise ChannelTimeoutError(
                        f"execute() backpressured for "
                        f"{self._submit_timeout}s ({self._max_inflight} "
                        f"executions in flight)")
            wrote = 0
            try:
                for eid in self._input_eids:
                    self._writers[eid].put(payload, 0, timeout=5.0)
                    wrote += 1
            except (ChannelClosedError, ChannelTimeoutError) as e:
                if wrote:
                    # some edges carry seq N that the others never got:
                    # the pairing is unrecoverable — poison everything so
                    # no consumer computes with mixed inputs
                    self._broken = f"partial input write ({e})"
                    for w in self._writers.values():
                        try:
                            w.poison()
                        except Exception:
                            pass
                self._check_alive()
                raise
            self._seq = seq + 1
            if exec_ctx is not None:
                self._trace_ctxs[seq] = exec_ctx
                _tracing.emit_span(f"cdag.execute {self._gid[:6]}",
                                  time.perf_counter() - t0, exec_ctx,
                                  phase="submit", seq=seq)
            waited = time.perf_counter() - t0
            if waited >= _WAIT_SPAN_MIN_S:
                _events.emit(_SOURCE, "execute backpressure", severity="DEBUG",
                             entity_id=self._gid, span_dur=waited, seq=seq)
            return CompiledDAGRef(self, seq)

    def _mark_consumed(self, seq: int) -> None:
        """Record ``seq`` as consumed (gotten or abandoned), advancing the
        low-water mark so tracking stays O(max_inflight).  Lock held."""
        self._fetched.add(seq)
        self._trace_ctxs.pop(seq, None)
        while self._fetched_below in self._fetched:
            self._fetched.discard(self._fetched_below)
            self._fetched_below += 1

    def _drain_abandoned(self) -> None:
        """Release results whose refs were GC'd without get().  Lock held."""
        while True:
            try:
                seq = self._abandoned_q.popleft()
            except IndexError:
                return
            if seq < self._fetched_below or seq in self._fetched:
                continue  # already consumed by get()
            self._results.pop(seq, None)
            self._mark_consumed(seq)

    def _drain_output(self, block: bool) -> bool:
        """Move any completed results from the output channel into the
        buffer (skipping abandoned seqs).  With ``block=False`` only takes
        what's already there."""
        self._drain_abandoned()
        got = False
        while True:
            try:
                payload, flags = self._reader.get(timeout=0.05 if block else 0)
            except ChannelTimeoutError:
                return got
            except ChannelClosedError:
                if self._torn_down:
                    raise
                # poisoned OUTSIDE teardown: an actor loop died and the
                # poison cascaded here — the graph cannot produce again
                self._broken = self._broken or "output channel closed"
                return got
            seq = self._next_out
            self._next_out += 1
            if seq < self._fetched_below or seq in self._fetched:
                continue  # abandoned before its result landed: discard
            self._results[seq] = (payload, flags)
            got = True
            block = False

    def _get_result(self, seq: int, timeout: Optional[float]) -> Any:
        if timeout is None:
            timeout = self._get_timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        t0 = time.perf_counter()
        last_liveness = 0.0
        while True:
            with self._lock:
                self._drain_abandoned()
                if seq in self._results:
                    payload, flags = self._results.pop(seq)
                    exec_ctx = self._trace_ctxs.get(seq)
                    self._mark_consumed(seq)
                    break
                if seq < self._fetched_below or seq in self._fetched:
                    raise CompiledGraphError(
                        f"execution {seq} was already consumed by get()")
                if self._torn_down:
                    raise CompiledGraphError("compiled DAG is torn down")
                if seq >= self._seq:
                    raise CompiledGraphError(
                        f"execution {seq} was never submitted")
                self._drain_output(block=True)
                broken = (self._broken if seq not in self._results else None)
            if broken:
                # actor death is the usual cause of a poisoned output
                # (stream EOF) — surface it as the typed ActorDiedError
                self._check_alive()
                raise CompiledGraphError(
                    f"compiled DAG is broken ({broken}); teardown() and "
                    f"recompile")
            now = time.monotonic()
            # liveness every 2s, not per poll: each check is a full actor-
            # table fetch from the head, and the compiled path exists to
            # keep steady-state serving OFF the control plane
            if now - last_liveness >= 2.0:
                last_liveness = now
                self._check_alive()
            if deadline is not None and now >= deadline:
                from ray_tpu_torch.exceptions import GetTimeoutError

                raise GetTimeoutError(
                    f"compiled DAG result {seq} not ready after {timeout}s")
        waited = time.perf_counter() - t0
        if waited >= _WAIT_SPAN_MIN_S:
            from ray_tpu_torch.util.tracing import span_fields

            _events.emit(_SOURCE, "result wait", severity="DEBUG",
                         entity_id=self._gid, span_dur=waited, seq=seq,
                         **span_fields(exec_ctx, "result_wait"))
        if flags & FLAG_ERROR:
            raise _deser_error(payload)
        value = _deser(payload)
        if isinstance(value, _Traced):  # traced execution: unwrap the output
            value = value.value
        return value

    def _authkey(self) -> bytes:
        node = self._w.node
        if node is not None:
            return node.authkey
        return bytes.fromhex(os.environ["RAY_TPU_TORCH_AUTHKEY"])

    def _actor_rows(self) -> List[dict]:
        """The head's state rows (``actor_id`` hex, ``class_name``,
        ``state``, ``num_restarts``, ``death_cause``) of this graph's
        actors."""
        return self._w.client.request(
            {"type": "actor_states", "actor_ids": sorted(self._actor_ids)},
            timeout=30)["value"]

    def _check_alive(self) -> None:
        """Raise a typed error if any participating actor died — the
        guarantee that a mid-graph SIGKILL can never hang the caller."""
        try:
            rows = self._actor_rows()
        except Exception:
            return  # control plane unreachable; channel timeouts still bound us
        # DEAD is death; so is RESTARTING or a bumped restart count — a
        # restarted incarnation has neither the loop thread nor the
        # channel attachments, so the compiled graph cannot recover (the
        # get would otherwise poll a healthy-looking ALIVE actor forever)
        dead = [r for r in rows
                if r.get("actor_id") in self._actor_ids
                and (r.get("state") in ("DEAD", "RESTARTING")
                     or (r.get("num_restarts") or 0)
                     > self._baseline_restarts.get(r.get("actor_id"), 0))]
        if dead:
            names = ", ".join(f"{r.get('class_name')}"
                              f"({r.get('actor_id', '')[:8]})" for r in dead)
            raise ActorDiedError(
                f"compiled DAG actor(s) died or restarted mid-execution "
                f"(compiled graphs do not survive actor restarts): {names} "
                f"({dead[0].get('death_cause') or dead[0].get('state')})")

    # -- teardown ------------------------------------------------------
    def teardown(self) -> None:
        """Release loops, channels, and segments.  Idempotent; never
        raises on a dead actor (its loop died with it)."""
        with self._lock:
            if self._torn_down:
                return
            self._torn_down = True
        import ray_tpu_torch

        # getattr-guarded throughout: a compile that failed partway (a
        # locality/prepare round trip erroring) leaves later attributes
        # unset, and teardown must still release whatever DID get built
        # (actors, prepared loops, listeners, segments)
        my_channels = list(getattr(self, "_writers", {}).values())
        reader = getattr(self, "_reader", None)
        if reader is not None:
            my_channels.append(reader)
        # poison the driver's ends first: wakes every loop blocked on an
        # edge that touches the driver
        for ch in my_channels:
            try:
                ch.poison()
            except Exception:
                pass
        # poison every same-namespace shm edge by name — covers edges
        # between two actors whose writer died and can't poison for itself
        for e in getattr(self, "_edges", []):
            if e.get("kind") == "shm":
                try:
                    ch = ShmChannel.attach(e["name"])
                    ch.poison()
                    ch.close()
                except Exception:
                    pass
        refs = []
        for h in getattr(self, "actors", []):
            try:
                refs.append(h._submit_compiled_task(
                    _cdag_rpc, ("teardown", self._gid.encode()),
                    name="cdag.teardown"))
            except Exception:
                pass
        for r in refs:
            try:
                ray_tpu_torch.get(r, timeout=10)
            except Exception:
                pass  # dead actor / torn control plane: loop died with it
        for ch in my_channels:
            try:
                ch.close()
            except Exception:
                pass
        from ray_tpu_torch._private.shm import ShmSegment

        for e in getattr(self, "_edges", []):
            if e.get("kind") == "shm" and e["writer"] == DRIVER:
                ShmSegment.unlink(e["name"])
        _events.emit(_SOURCE, "graph torn down", entity_id=self._gid)

    def __del__(self):
        try:
            if not getattr(self, "_torn_down", True):
                self.teardown()
        except Exception:
            pass


def _contains_node(v) -> bool:
    from ray_tpu_torch.dag.dag_node import DAGNode

    if isinstance(v, DAGNode):
        return True
    if isinstance(v, (list, tuple)):
        return any(_contains_node(x) for x in v)
    if isinstance(v, dict):
        return any(_contains_node(x) for x in v.values())
    return False
