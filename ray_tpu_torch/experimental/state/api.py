"""Cluster state API — ``ray.experimental.state.api`` analog.

``list_actors``/``list_tasks``/``list_objects``/``summarize_*``
(reference ``python/ray/experimental/state/api.py:729,952,996,1269-1333``,
aggregated by ``dashboard/state_aggregator.py``): live introspection of
the control plane, served by the head's ``list_state`` RPC.

``summarize_*`` aggregate HEAD-SIDE via the ``summarize_state`` RPC
(``state_aggregator.py`` summary path): the head counts over its full
tables and ships the counts, instead of this client pulling up to 100k
rows to count locally.  ``list_traces``/``get_trace``/``summarize_traces``
expose the request-trace plane (``util/tracing.py`` spans assembled by the
head's TraceTable).

``list_metrics``/``query_metric`` read the head's time-series store
(``util/tsdb.py``, fed by every worker's and node agent's metrics push
and the head's own sampler); ``memory_summary``, ``top_snapshot``,
``perf_summary`` and ``doctor_report`` are the head-side aggregates
behind ``python -m ray_tpu_torch memory``/``top``/``perf``/``doctor``.

``list_logs``/``get_log``/``tail_log`` read the head's log store,
``list_profiles``/``get_profile``/``profile_diff``/``profile_ledger`` its
profile store, and ``list_incidents``/``list_slos``/``get_incident``/
``ack_incident``/``debug_dump`` its watchdog.  ``list_tenants`` reads
the head's driver directory (direct, thin and proxied drivers).

A table the head does not keep raises ``ValueError``.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional


def _client():
    from ray_tpu_torch._private.worker import global_worker

    if not global_worker.connected:
        raise RuntimeError("ray_tpu_torch.init() must run before the state API")
    return global_worker.client


def list_state_page(what: str, limit: int = 1000,
                    filters: Optional[dict] = None) -> dict:
    """One page of a state table WITH its truncation marker:
    ``{"rows", "total", "truncated"}``.  The plain ``list_*`` helpers
    return bare rows for compatibility — use this when completeness
    matters (the CLI prints the marker from it)."""
    msg = {"type": "list_state", "what": what, "limit": limit}
    if filters:
        msg["filters"] = filters
    reply = _client().request(msg)
    rows = reply["value"]
    if isinstance(rows, dict) and "__state_error__" in rows:
        raise ValueError(rows["__state_error__"])
    total = reply.get("total", len(rows))
    return {"rows": rows, "total": total, "truncated": total > len(rows)}


def _list(what: str, limit: int, filters: Optional[dict] = None) -> List[dict]:
    page = list_state_page(what, limit, filters)
    if page["truncated"]:
        # a silent cap reads as "this is everything" on a large cluster —
        # make the partial view loud without changing the return shape
        warnings.warn(
            f"list_{what} truncated: showing {len(page['rows'])} of "
            f"{page['total']} rows (raise limit= to see the rest)",
            stacklevel=3)
    return page["rows"]


def list_actors(limit: int = 1000) -> List[dict]:
    return _list("actors", limit)


def list_nodes(limit: int = 1000) -> List[dict]:
    """One row per node: its total ``resources`` and, while it is alive,
    its ``available`` ones (``"GPU"`` among both on a node with cards)."""
    return _list("nodes", limit)


def list_slices(limit: int = 1000) -> List[dict]:
    """One row per slice (failure domain): members, alive/dead
    counts, draining flag, and whether it is currently degraded (dead
    member, not draining — what doctor's ``slice_degraded`` watches)."""
    return _list("slices", limit)


def list_tasks(limit: int = 1000) -> List[dict]:
    return _list("tasks", limit)


def list_objects(limit: int = 1000) -> List[dict]:
    return _list("objects", limit)


def list_placement_groups(limit: int = 1000) -> List[dict]:
    return _list("placement_groups", limit)


def list_workers(limit: int = 1000) -> List[dict]:
    return _list("workers", limit)


def list_jobs(limit: int = 1000) -> List[dict]:
    """Submitted jobs (the head's JobManager): id, entrypoint, status,
    return code, times, metadata, log path."""
    return _list("jobs", limit)


def list_tenants(limit: int = 1000) -> List[dict]:
    """Driver jobs (tenants) with namespace, driver pid, proxied flag,
    liveness, and live actor counts — the multi-tenancy directory (what
    ``ray_tpu_torch list tenants`` renders and the tenant-kill chaos op
    resolves pids from)."""
    return _list("tenants", limit)


def list_events(limit: int = 1000, source: Optional[str] = None,
                severity: Optional[str] = None) -> List[dict]:
    """Flight-recorder events from the head's cluster-wide event table
    (scheduler dispatches, spills, OOM kills, backpressure stalls, slot
    admissions...), oldest-first.  ``source``/``severity`` filter
    HEAD-SIDE, before the limit — a rare WARNING stays findable behind
    thousands of newer sampled DEBUG rows."""
    filters = {}
    if source is not None:
        filters["source"] = source
    if severity is not None:
        filters["severity"] = severity
    return _list("events", limit, filters or None)


def summarize_state(what: str) -> dict:
    """Head-side aggregation RPC: the head counts over its full tables
    and ships only the counts (the client never pulls row dumps)."""
    value = _client().request(
        {"type": "summarize_state", "what": what})["value"]
    if isinstance(value, dict) and "__state_error__" in value:
        raise ValueError(value["__state_error__"])
    return value


def summarize_events() -> Dict[str, Dict[str, int]]:
    """Event counts grouped by source and severity (head-side)."""
    return summarize_state("events")


def summarize_tasks() -> Dict[str, Dict[str, int]]:
    """Task counts grouped by name and state (summarize_tasks analog,
    aggregated head-side)."""
    return summarize_state("tasks")


def summarize_actors() -> Dict[str, Dict[str, int]]:
    return summarize_state("actors")


def summarize_traces() -> dict:
    """Trace counts + duration percentiles from the head's TraceTable."""
    return summarize_state("traces")


def list_traces(limit: int = 100) -> List[dict]:
    """Summaries of recently updated traces (id, root span name, span
    count, start, duration)."""
    return _list("traces", limit)


def get_trace(trace_id: str) -> Optional[dict]:
    """One assembled trace: recorder spans (router admission, channel
    waits, compiled-graph node executions, get waits...) merged with
    task-table spans (queue + execution attribution), sorted by start,
    plus ``logs`` — the trace's stamped log records joined onto the
    span tree.  None if the id is unknown."""
    return _client().request(
        {"type": "get_trace", "trace_id": trace_id})["value"]


# ---------------------------------------------------------------------------
# log plane (head LogStore — `ray_tpu_torch logs` backend)
# ---------------------------------------------------------------------------

def list_logs(limit: int = 1000) -> List[dict]:
    """One row per captured log stream in the head's LogStore (worker /
    job-driver / head files the per-node monitors tail):
    stream name, node, pid, retained lines/bytes, and whether the
    stream's process already died (``retired`` — its death tail stays
    queryable until the retirement horizon)."""
    return _list("logs", limit)


def get_log(stream: Optional[str] = None, job: Optional[str] = None,
            task: Optional[str] = None, actor: Optional[str] = None,
            node: Optional[str] = None, pid: Optional[int] = None,
            trace: Optional[str] = None, grep: Optional[str] = None,
            errors: bool = False, since_seq: int = 0,
            limit: int = 1000) -> dict:
    """Filtered log records from the head's store — the ``ray_tpu_torch logs``
    backend.  Every filter matches the per-line context stamps (so
    ``task=``/``actor=``/``trace=`` find a plain ``print()`` from inside
    that execution).  Returns ``{"records", "cursor"}``; pass ``cursor``
    back as ``since_seq`` to follow the stream incrementally.
    ``stream="job-<id>"`` falls back to the job driver's complete
    on-disk log when the ring has nothing."""
    return _client().request(
        {"type": "get_log", "stream": stream, "job": job, "task": task,
         "actor": actor, "node": node, "pid": pid, "trace": trace,
         "grep": grep, "errors": errors, "since_seq": since_seq,
         "limit": limit})["value"]


def tail_log(stream: str, n: int = 100, errors: bool = False) -> List[str]:
    """The last ``n`` raw lines of one stream (``errors=True`` keeps only
    stderr/traceback lines) — works for retired streams too, which is how
    a SIGKILL'd worker's final stderr is read back after death."""
    return _client().request(
        {"type": "tail_log", "stream": stream, "n": n,
         "errors": errors})["value"]



# ---------------------------------------------------------------------------
# resource accounting over time (head TSDB + ownership audit)
# ---------------------------------------------------------------------------

def list_metrics() -> List[dict]:
    """Every metric with retained history in the head's TSDB: name, type,
    number of label series, origins, freshest sample time."""
    return _client().request({"type": "list_metrics"})["value"]


def query_metric(name: str, window_s: float = 3600.0, step_s: float = 0.0,
                 tags: Optional[Dict[str, str]] = None,
                 agg: Optional[str] = None) -> dict:
    """Aligned time series for one metric over the trailing window,
    served from the head's staged-downsampling TSDB — the data behind
    sparklines, trend doctor rules, and capacity questions a snapshot
    can't answer.  ``step_s <= 0`` uses the sample interval; ``agg`` is
    one of last/max/min/sum/avg/count (default: the metric's natural
    aggregation)."""
    msg = {"type": "query_metric", "name": name, "window_s": window_s,
           "step_s": step_s}
    if tags:
        msg["tags"] = tags
    if agg:
        msg["agg"] = agg
    value = _client().request(msg)["value"]
    if isinstance(value, dict) and "__state_error__" in value:
        raise ValueError(value["__state_error__"])
    return value


# ---------------------------------------------------------------------------
# continuous profiling (head ProfileStore)
# ---------------------------------------------------------------------------

def list_profiles() -> List[dict]:
    """One row per origin with retained continuous-profile history in
    the head's ProfileStore: bucket counts (fine + decayed coarse),
    bytes, total samples, GIL-pressure estimate, push age, and the
    origin's current sampling cadence."""
    return _client().request({"type": "list_profiles"})["value"]


def get_profile(window_s: float = 300.0,
                origin: Optional[str] = None) -> dict:
    """Merged folded stacks over the trailing window (cluster-wide, or
    one origin's) from the always-on profiler — ``folded`` maps
    ``|``-joined root→leaf stacks to sample counts, plus the duty-cycle
    denominators (``ticks``/``busy_ticks``) the cost ledger divides by."""
    return _client().request(
        {"type": "get_profile", "window_s": window_s,
         "origin": origin})["value"]


def profile_diff(window_a: float = 600.0, window_b: float = 60.0,
                 origin: Optional[str] = None) -> dict:
    """Differential profile: the trailing ``window_b`` seconds against
    the ``window_a``-long baseline before it, counts scaled to the same
    span.  ``collapsed`` holds flamegraph.pl ``difffolded`` lines
    (``stack countA countB``); ``delta`` the per-stack change."""
    return _client().request(
        {"type": "profile_diff", "window_a": window_a,
         "window_b": window_b, "origin": origin})["value"]


def profile_ledger(window_s: float = 300.0,
                   tasks: Optional[int] = None) -> dict:
    """The per-task CPU cost ledger: sampled stacks joined with the task
    lane into driver-submit / head-dispatch / worker-exec / serialize /
    lock-wait / GIL-wait microsecond columns that sum to the measured
    per-task wall (``tasks`` overrides the TSDB-derived task count when
    the caller counted exactly)."""
    msg = {"type": "profile_ledger", "window_s": window_s}
    if tasks is not None:
        msg["tasks"] = tasks
    return _client().request(msg)["value"]


def memory_summary(limit: int = 200) -> dict:
    """Object-ownership audit (``ray memory`` analog): sealed object-store
    bytes attributed per owner (driver/worker/actor), pin-reason
    breakdown, per-object rows sorted by size, and orphan flags for
    objects whose owner process is gone."""
    return _client().request(
        {"type": "memory_audit", "limit": limit})["value"]


def top_snapshot() -> dict:
    """One frame of ``ray_tpu_torch top``: nodes with host stats, workers
    with sampled RSS/CPU/fds and pinned bytes, task-state and store
    summaries, and device-memory watermark rows (each GPU process's
    ``torch.cuda`` allocator gauges, pushed by its metrics pusher)."""
    return _client().request({"type": "top_snapshot"})["value"]


# ---------------------------------------------------------------------------
# watchdog plane (incidents, SLOs, head-side doctor, debug dumps)
# ---------------------------------------------------------------------------

def list_incidents(limit: int = 1000) -> List[dict]:
    """The watchdog's tracked incident set — open, acked, and resolved
    rows with stable ids keyed on (rule, entity), severity, re-open
    counts, the transition history, and the post-mortem bundle path
    captured at open.  Empty when the watchdog is disabled."""
    return _list("incidents", limit)


def list_slos(limit: int = 1000) -> List[dict]:
    """Declared SLOs (defaults + ``slos.json`` + ``add_slo``) with the
    latest multi-window burn-rate evaluation folded in: per-window
    value/coverage/breach and the overall ``burning`` verdict."""
    return _list("slos", limit)


def get_incident(incident_id: str) -> dict:
    """One incident's full record, including its evidence rows and
    transition history; raises ValueError on an unknown id."""
    value = _client().request(
        {"type": "get_incident", "incident_id": incident_id})["value"]
    if isinstance(value, dict) and "__state_error__" in value:
        raise ValueError(value["__state_error__"])
    return value


def ack_incident(incident_id: str) -> dict:
    """Acknowledge an open incident (open → ack): it stops alerting on
    refresh but still auto-resolves once clear.  Returns the updated
    record; raises ValueError if the id is unknown or not open."""
    value = _client().request(
        {"type": "ack_incident", "incident_id": incident_id})["value"]
    if isinstance(value, dict) and "__state_error__" in value:
        raise ValueError(value["__state_error__"])
    return value


def doctor_report(trend_window_s: float = 1800.0) -> List[dict]:
    """Doctor findings computed HEAD-SIDE over the head's own event /
    task / TSDB tables — the ``ray_tpu_torch doctor`` backend.  The client
    receives only the findings, never the 100k-row tables they were
    diagnosed from."""
    value = _client().request(
        {"type": "doctor_report",
         "trend_window_s": trend_window_s})["value"]
    if isinstance(value, dict) and "__state_error__" in value:
        raise ValueError(value["__state_error__"])
    return value


def debug_dump(label: Optional[str] = None) -> str:
    """One-shot whole-cluster post-mortem bundle written head-side under
    ``<session>/incidents/`` (log tails, event excerpt, TSDB slices,
    collapsed profile, memory audit); returns the bundle directory."""
    value = _client().request(
        {"type": "debug_dump", "label": label})["value"]
    if isinstance(value, dict) and "__state_error__" in value:
        raise ValueError(value["__state_error__"])
    return value["path"]


def perf_summary(window_s: float = 1800.0) -> dict:
    """Performance-observability aggregate (``ray_tpu_torch perf``
    backend): the step-phase breakdown (phases sum exactly to profiled
    step wall), per-rank live MFU + the TSDB MFU trend over the trailing
    window, the compile-cache table per shape signature, device-memory
    watermarks, and the decode attribution block (TTFT/ITL histograms,
    per-engine prefill-interference meters)."""
    return _client().request(
        {"type": "perf_summary", "window_s": window_s})["value"]
