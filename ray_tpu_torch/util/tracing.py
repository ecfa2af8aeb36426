"""Distributed trace-context propagation across task/actor boundaries.

Analog of the reference's ``python/ray/util/tracing/tracing_helper.py``
(monkey-patched remote calls inject OpenTelemetry span contexts into task
metadata; workers resume the trace).  Here propagation is first-class
instead of patched on: when tracing is enabled, every task spec carries the
submitter's trace context, the executing worker adopts it for the duration
of the task (so nested submissions chain), and the head records it on
TaskInfo — ``ray_tpu_torch timeline`` then emits chrome-trace flow arrows linking
parents to children.  If the OpenTelemetry SDK is importable, real spans
are started as well (the reference's lazy-import pattern).

Beyond task specs, the context crosses every runtime boundary: serve HTTP
ingress opens a root trace per request, the router's admission wait becomes
a child span the replica task chains under, compiled-graph ``execute()``
rides the channel payloads (``dag/compiled.py`` ``_Traced``) so per-node
loop spans join the caller's trace, the streaming pump adopts its
consumer's context, and long ``ray_tpu_torch.get`` waits emit ``get_wait``
spans.  Timed spans land in the flight recorder (``_private/events.py``)
under the ``trace`` source, so shipping to the head, crash-dump JSONL, and
the chrome-trace merge all come for free; the head folds them into a
per-trace :class:`~ray_tpu_torch._private.events.TraceTable` served by
``experimental.state.api.get_trace`` / ``ray_tpu_torch trace <id>``.

Presence of a context IS the enable signal: outside any ``trace()`` block
nothing is recorded and task specs stay clean, so the disabled path costs
one contextvar read per submission.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from typing import Any, Dict, Iterator, Optional

from ray_tpu_torch._private import events as _events
from ray_tpu_torch._private import log_plane as _log_plane

# flight-recorder source for span events (one row per closed span)
TRACE_SOURCE = "trace"

_current: contextvars.ContextVar[Optional[Dict[str, str]]] = contextvars.ContextVar(
    "ray_tpu_trace", default=None
)


def _ctx_set(ctx):
    """``_current.set`` + log-plane stamp-cache invalidation: every line
    a thread prints while a context is active must carry its trace id."""
    token = _current.set(ctx)
    _log_plane.bump_context_epoch()
    return token


def _ctx_reset(token):
    _current.reset(token)
    _log_plane.bump_context_epoch()

# --- id generation --------------------------------------------------------
# NOT uuid4 per span: uuid4 reads os.urandom every call, and on this
# kernel one urandom read costs ~200us — per-task span ids at that price
# ate ~30% of task throughput.  Instead: one urandom read per PROCESS
# (22 hex chars of prefix + a random-start counter).  Forked children
# (the forkserver's warm template) re-seed via the at-fork hook instead
# of a per-call getpid() — this kernel charges ~16us per getpid too.
_id_lock = threading.Lock()
_id_prefix = ""
_id_n = 0


def _reseed_ids() -> None:
    # fresh lock too: the fork may have happened while another thread of
    # the parent held _id_lock — the child inherits it locked forever
    global _id_lock, _id_prefix, _id_n
    _id_lock = threading.Lock()
    _id_prefix = ""
    _id_n = 0


os.register_at_fork(after_in_child=_reseed_ids)


def _next_id() -> int:
    global _id_prefix, _id_n
    with _id_lock:
        if not _id_prefix:
            _id_prefix = os.urandom(11).hex()  # raylint: disable=R3 (one-shot, off the per-task path)
            _id_n = int.from_bytes(os.urandom(5), "big")  # raylint: disable=R3 (one-shot, off the per-task path)
        _id_n += 1
        return _id_n


def new_trace_id() -> str:
    """32 hex chars, globally unique (22-hex process prefix + counter)."""
    n = _next_id()  # first: seeds the prefix for this process
    return _id_prefix + format(n & 0xFFFFFFFFFF, "010x")


def new_span_id() -> str:
    """16 hex chars, unique in-process by counter and cross-process by
    the random prefix + random counter start."""
    n = _next_id()
    return _id_prefix[:6] + format(n & 0xFFFFFFFFFF, "010x")


def current_context() -> Optional[Dict[str, str]]:
    """The active trace context, or None (outside any trace).  Presence of
    a context IS the enable signal — specs stay clean when tracing is
    unused, and workers propagate whenever a spec carries one."""
    return _current.get()


@contextlib.contextmanager
def trace(name: str, attributes: Optional[dict] = None,
          phase: str = "span") -> Iterator[Dict[str, str]]:
    """Open a span.  Tasks submitted inside the block carry its context;
    their workers continue the same trace.  On exit the timed span is
    emitted into the flight recorder (``trace`` source), which is what
    the head's TraceTable assembles per-trace span trees from."""
    parent = _current.get()
    ctx = {
        "trace_id": parent["trace_id"] if parent else new_trace_id(),
        "span_id": new_span_id(),
        "parent_span_id": parent["span_id"] if parent else "",
        "name": name,
    }
    job = parent.get("job") if parent else _current_job()
    if job:
        # tenant identity rides the context: every span of the trace can
        # be attributed to the submitting job (multi-tenant trace audit)
        ctx["job"] = job
    token = _ctx_set(ctx)
    otel_cm = _otel_span(name, attributes)
    t0 = time.perf_counter()
    try:
        with otel_cm:
            yield ctx
    finally:
        _ctx_reset(token)
        emit_span(name, time.perf_counter() - t0, ctx, phase=phase,
                  attributes=attributes)


def _current_job() -> Optional[str]:
    """The running process's tenant job id (driver identity or the
    executing task's), for root-span attribution.  Lazy import: tracing
    must stay importable before the worker runtime is."""
    try:
        from ray_tpu_torch._private.worker import global_worker
    except ImportError:
        return None
    return global_worker.current_job_id or global_worker.job_id


def _otel_span(name: str, attributes: Optional[dict]):
    """A real OpenTelemetry span when the SDK is importable, else a no-op
    (``tracing_helper.py:53-59`` lazy import)."""
    try:
        from opentelemetry import trace as otel  # type: ignore
    except ImportError:
        return contextlib.nullcontext()
    tracer = otel.get_tracer("ray_tpu_torch")
    return tracer.start_as_current_span(name, attributes=attributes or {})


def child_context(name: str) -> Optional[Dict[str, str]]:
    """A fresh span context chained under the caller's (None when tracing
    is off).  Used for outgoing task specs, router admissions, compiled
    ``execute()`` payloads — anything that continues the trace in another
    process."""
    parent = current_context()
    if parent is None:
        return None
    ctx = {
        "trace_id": parent["trace_id"],
        "span_id": new_span_id(),
        "parent_span_id": parent["span_id"],
        "name": name,
    }
    if parent.get("job"):
        ctx["job"] = parent["job"]
    return ctx


# outgoing-task alias kept for the original call sites (worker.py)
def child_context_for_task(task_name: str) -> Optional[Dict[str, str]]:
    """Context to embed in an outgoing task spec: a fresh span chained
    under the caller's (None when tracing is off — specs stay clean)."""
    return child_context(task_name)


def adopt(ctx: Optional[Dict[str, str]]) -> Any:
    """Make ``ctx`` the current context on this thread (the executing
    worker resuming a submitter's trace).  Returns a token for
    :func:`restore`; pass None to clear (a pooled worker must not leak
    the previous task's context)."""
    return _ctx_set(ctx)


def restore(token: Any) -> None:
    """Undo a matching :func:`adopt` (public inverse — callers must not
    reach into the module's contextvar)."""
    _ctx_reset(token)


# attribute keys that would collide with emit parameters or span lineage;
# user attributes with these names are prefixed, never dropped or crashed on
_RESERVED_KEYS = frozenset((
    "source", "message", "severity", "entity_id", "span_dur",
    "trace_id", "span_id", "parent_span_id", "phase", "name",
))


def span_fields(ctx: Optional[Dict[str, str]], phase: str,
                span_id: Optional[str] = None) -> Dict[str, str]:
    """Span-lineage kwargs for a raw ``events.emit``: a fresh child span
    of ``ctx`` (or the explicit ``span_id``).  {} without a context, so
    call sites can splat it unconditionally."""
    if ctx is None:
        return {}
    return {"trace_id": ctx["trace_id"],
            "span_id": span_id or new_span_id(),
            "parent_span_id": ctx["span_id"], "phase": phase}


def emit_span(name: str, dur_s: float, ctx: Optional[Dict[str, str]],
              phase: str = "span", severity: str = "DEBUG",
              attributes: Optional[dict] = None, **data) -> None:
    """Record one closed span [now - dur_s, now] in the flight recorder,
    tagged with its trace lineage so the head's TraceTable can assemble
    the tree.  No-op without a context or with the observability layer
    disabled — callers can invoke it unconditionally.  User attribute
    keys shadowing span/emit fields are prefixed ``attr_`` instead of
    crashing or clobbering the lineage."""
    if ctx is None or not _events.ENABLED:
        return
    merged = dict(attributes or ())
    merged.update(data)
    if ctx.get("job"):
        merged.setdefault("job", ctx["job"])
    safe = {(f"attr_{k}" if k in _RESERVED_KEYS else k): v
            for k, v in merged.items()}
    _events.emit(
        TRACE_SOURCE, name, severity=severity, entity_id=ctx["trace_id"],
        span_dur=dur_s, trace_id=ctx["trace_id"], span_id=ctx["span_id"],
        parent_span_id=ctx.get("parent_span_id", ""), phase=phase, **safe)


@contextlib.contextmanager
def span(name: str, phase: str = "span", **data) -> Iterator[Optional[dict]]:
    """Child-span context manager: times the block and emits it as a child
    of the current context.  Unlike :func:`trace` it never STARTS a trace
    — outside any context it is a pure no-op (no uuid, no event)."""
    ctx = child_context(name)
    if ctx is None:
        yield None
        return
    token = _ctx_set(ctx)
    t0 = time.perf_counter()
    try:
        yield ctx
    finally:
        _ctx_reset(token)
        emit_span(name, time.perf_counter() - t0, ctx, phase=phase, **data)
