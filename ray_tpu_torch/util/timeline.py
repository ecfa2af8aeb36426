"""Chrome-trace timeline of task execution — ``ray timeline`` analog.

The reference batches per-task profile events to the GCS and dumps
chrome-trace JSON (``python/ray/_private/state.py:414``
``chrome_tracing_dump``, ``:829 timeline``; worker-side ``Profiler``
``src/ray/core_worker/profiling.h:30``).  Here the head's task table
carries begin/end/node for every task; this renders it in the trace-event
format that chrome://tracing / Perfetto load directly.
"""

from __future__ import annotations

import json
import time
from typing import List, Optional


def timeline_events() -> List[dict]:
    from ray_tpu_torch._private.worker import global_worker

    tasks = global_worker.client.request(
        {"type": "list_state", "what": "tasks", "limit": 100_000}
    )["value"]
    try:
        recorder = global_worker.client.request(
            {"type": "list_state", "what": "events", "limit": 100_000}
        )["value"]
    except Exception:
        recorder = []  # older head without an event table
    return merged_timeline(tasks, recorder)


def merged_timeline(tasks: List[dict], recorder_rows: List[dict]) -> List[dict]:
    """One trace: task/queue slices (+ flow arrows) interleaved with
    flight-recorder spans — streaming-operator, collective, and
    serve-admission slices land on per-source rows next to the tasks
    that caused them.  Perfetto/chrome load the merged list directly."""
    events = events_from_task_rows(tasks)
    events.extend(events_from_recorder_rows(recorder_rows))
    events.extend(_trace_flow_events(recorder_rows))
    events.extend(_metadata_events(events))
    return events


def events_from_recorder_rows(rows: List[dict]) -> List[dict]:
    """Flight-recorder events as chrome-trace events: span events
    (``span_dur`` covers [ts - dur, ts]) become "X" slices; point events
    become instants.

    The ``compiled_dag`` source (``dag/compiled.py``) is keyed by
    entity_id (``<graph>:<node>``) rather than origin, so each graph node
    gets its own timeline row — the pipeline bubble structure (exec spans
    interleaved with channel-wait spans) reads directly off the trace,
    next to the task slices.  The ``trace`` source is keyed the same way
    (entity_id = trace_id): each request trace renders as one row whose
    spans are linked by flow arrows (:func:`_trace_flow_events`)."""
    out: List[dict] = []
    for r in rows:
        ts = r.get("ts")
        source = r.get("source")
        if ts is None or source is None:
            continue
        pid, tid = _recorder_row_key(r)
        args = {"severity": r.get("severity")}
        if r.get("entity_id"):
            args["entity_id"] = r["entity_id"]
        if r.get("data"):
            args.update(r["data"])
        dur = r.get("span_dur")
        if dur:
            out.append({
                "name": r.get("message", source), "cat": source, "ph": "X",
                "ts": (ts - dur) * 1e6, "dur": dur * 1e6,
                "pid": pid, "tid": tid, "args": args,
            })
        else:
            out.append({
                "name": r.get("message", source), "cat": source, "ph": "i",
                "s": "t", "ts": ts * 1e6, "pid": pid, "tid": tid,
                "args": args,
            })
    return out


def _recorder_row_key(r: dict):
    """(pid, tid) for a recorder event: per-source process rows, keyed by
    origin — except compiled_dag (per graph node) and trace (per trace
    id), whose slices AND flow arrows must land on the same row."""
    source = r.get("source")
    pid = f"recorder:{source}"
    if source in ("compiled_dag", "trace"):
        tid = str(r.get("entity_id") or r.get("origin") or "events")
    else:
        tid = str(r.get("origin") or r.get("entity_id") or "events")
    return pid, tid


def _trace_flow_events(rows: List[dict]) -> List[dict]:
    """Per-trace flow arrows: recorder span events carrying trace lineage
    (``data.span_id``/``parent_span_id`` — trace-source spans AND traced
    compiled-graph spans) get chrome flow "s"/"f" pairs parent -> child,
    so a request's causal chain reads as arrows across the merged rows."""
    spans: List[dict] = []
    by_id: dict = {}
    for r in rows:
        d = r.get("data") or {}
        if r.get("ts") is None or not d.get("span_id"):
            continue
        spans.append(r)
        by_id.setdefault(d["span_id"], r)

    out: List[dict] = []
    for r in spans:
        d = r["data"]
        parent = by_id.get(d.get("parent_span_id"))
        if parent is None or parent is r:
            continue
        p_pid, p_tid = _recorder_row_key(parent)
        c_pid, c_tid = _recorder_row_key(r)
        p_start = (parent["ts"] - (parent.get("span_dur") or 0.0)) * 1e6
        c_start = (r["ts"] - (r.get("span_dur") or 0.0)) * 1e6
        out.append({"name": r.get("message", "span"), "cat": "trace_flow",
                    "ph": "s", "id": d["span_id"], "ts": p_start,
                    "pid": p_pid, "tid": p_tid})
        out.append({"name": r.get("message", "span"), "cat": "trace_flow",
                    "ph": "f", "bp": "e", "id": d["span_id"],
                    "ts": max(c_start, p_start), "pid": c_pid,
                    "tid": c_tid})
    return out


def _metadata_events(events: List[dict]) -> List[dict]:
    """Chrome-trace ``M`` metadata so Perfetto labels rows with node ids
    and worker pids instead of raw hex/ints."""
    by_pid: dict = {}
    for e in events:
        pid = e.get("pid")
        if pid is None:
            continue
        tids = by_pid.setdefault(pid, set())
        if e.get("tid") is not None:
            tids.add(e["tid"])
    out: List[dict] = []
    for pid, tids in by_pid.items():
        if isinstance(pid, str) and pid.startswith("recorder:"):
            pname = f"flight recorder · {pid[len('recorder:'):]}"
        else:
            pname = f"node {pid}"
        out.append({"name": "process_name", "ph": "M", "ts": 0, "pid": pid,
                    "args": {"name": pname}})
        for tid in tids:
            tname = f"worker pid {tid}" if isinstance(tid, int) else str(tid)
            out.append({"name": "thread_name", "ph": "M", "ts": 0, "pid": pid,
                        "tid": tid, "args": {"name": tname}})
    return out


def events_from_task_rows(tasks: List[dict]) -> List[dict]:
    """Render task-table rows as chrome-trace events.  Shared by the
    driver CLI path above and the dashboard's ``/api/timeline`` (which
    reads the head's table directly — no driver client there)."""
    events: List[dict] = []
    now = time.time()
    for t in tasks:
        start = t.get("start_time")
        if start is None:
            continue
        end = t.get("end_time") or now
        pid = t.get("node_id") or "pending"
        tid = t.get("worker_pid") or (t.get("task_id") or "")[:8]
        exec_start, exec_end = t.get("exec_start"), t.get("exec_end")
        if exec_start:
            # queue slice (submission -> worker pickup) + exec slice,
            # keyed to the actual worker pid like the reference timeline
            events.append({
                "name": f"{t.get('name', 'task')} (queued)", "cat": "queue",
                "ph": "X", "ts": start * 1e6,
                "dur": max(0.0, (exec_start - start) * 1e6),
                "pid": pid, "tid": tid,
                "args": {"task_id": t.get("task_id")},
            })
            start, end = exec_start, exec_end or now
        args = {"state": t.get("state"), "task_id": t.get("task_id")}
        tc = t.get("trace_ctx")
        if tc:
            args.update(trace_id=tc.get("trace_id"), span_id=tc.get("span_id"),
                        parent_span_id=tc.get("parent_span_id"))
        events.append({
            "name": t.get("name", "task"),
            "cat": "task",
            "ph": "X",  # complete event
            "ts": start * 1e6,
            "dur": max(0.0, (end - start) * 1e6),
            "pid": pid,
            "tid": tid,
            "args": args,
        })
        if tc:
            # flow arrows: submitter span -> this task (chrome flow events
            # bind on matching id; the parent task emits the "s" below)
            events.append({
                "name": tc.get("name", "submit"), "cat": "trace", "ph": "f",
                "bp": "e", "id": tc.get("span_id"),
                "ts": start * 1e6, "pid": pid, "tid": tid,
            })
    # emit flow starts from each parent task's exec window
    by_span = {
        (t.get("trace_ctx") or {}).get("span_id"): t
        for t in tasks if t.get("trace_ctx")
    }
    for t in tasks:
        tc = t.get("trace_ctx")
        if not tc:
            continue
        parent = by_span.get(tc.get("parent_span_id"))
        if parent is None or parent.get("start_time") is None:
            continue
        ts = (parent.get("exec_start") or parent["start_time"]) * 1e6
        events.append({
            "name": tc.get("name", "submit"), "cat": "trace", "ph": "s",
            "id": tc.get("span_id"), "ts": ts,
            "pid": parent.get("node_id") or "pending",
            "tid": parent.get("worker_pid") or (parent.get("task_id") or "")[:8],
        })
    return events


def timeline_dump(path: Optional[str] = None) -> str:
    import os

    from ray_tpu_torch._private.config import session_root

    path = path or os.path.join(session_root(), f"timeline-{int(time.time())}.json")

    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        # default=repr: recorder-event args can carry arbitrary app
        # payloads (numpy scalars) and the dump must still be valid JSON
        json.dump(timeline_events(), f, default=repr)
    return path
