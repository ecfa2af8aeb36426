"""Cluster flight recorder: bounded structured-event ring per process.

Analog of the reference's event framework (``dashboard/modules/event/`` +
``src/ray/util/event.h``): every process keeps a small ring buffer of
structured events (ts, severity, source, entity id, message, data) that
subsystems emit on their hot paths — dispatch decisions, spills, OOM
kills, backpressure stalls, slot admissions.  Dapper's rules apply:
always-on, bounded memory (O(capacity), never O(events)), and cheap
enough to leave enabled (<3% of task throughput, gated by the
``observability_overhead`` bench row).

Transport: workers batch-ship new events to the head over the control
connection (the ``metrics_report`` path) via :class:`EventsPusher`; the
head folds them into a capped per-source :class:`EventTable` served by
``ray_tpu_torch events`` / ``experimental.state.api.list_events`` / the
dashboard's ``/api/events``.  The pusher also rewrites a crash-dump file
under the session log dir each cycle, so even a SIGKILL'd process leaves
its last-flushed ring on disk.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

SEVERITIES = ("DEBUG", "INFO", "WARNING", "ERROR")

# Well-known event sources (informational — the table accepts any source).
# Kept current so `ray_tpu_torch events --source X` is discoverable; matches the
# emit sites and the cli.py --source help.  compiled_dag (dag/compiled.py)
# carries per-node exec spans + channel-wait spans of compiled execution
# graphs.
KNOWN_SOURCES = (
    "scheduler", "node", "actor", "worker_pool", "object_store",
    "streaming", "serve", "serve_llm", "train", "collective",
    "compiled_dag", "trace", "rllib",
    # "serve" carries the ingress fault-tolerance signal set doctor's
    # ingress_shedding / drain_stuck rules read: `ingress shedding
    # started`/`stopped` (router watermark + proxy in-flight cap, with
    # hysteresis so an episode is two events, not one per refused
    # request), `replica draining`/`drained`/`drain timeout`, `request
    # retried after replica death`, `routing refresh failed`, and
    # `deployment scaled`; shed/retry volume rides the
    # ray_tpu_serve_shed_total counter and ingress_stats()
    # slice failure domain: P2P mesh observations (_private/syncer.py),
    # fault injections (devtools/chaos), scale/replace decisions
    # (autoscaler/policy.py) — doctor and the timeline correlate cause
    # (chaos) with symptom (syncer/node) and remedy (autoscaler)
    "syncer", "chaos", "autoscaler",
    # device-time performance attribution (util/perf.py + serve/llm.py):
    # step-phase spans, jit compile events, prefill-interference meters
    # — what `ray_tpu_torch perf` and the doctor's perf rules read
    "perf",
    # multi-tenancy lifecycle (util/client proxier + node.py tenant reap):
    # tenant registered/driver spawned/driver died/reaped — what doctor's
    # tenant_killed rule and the tenant-kill chaos scenario read
    "client_proxy",
    # RL sample/train/inference spans (rllib/rollout_worker.py,
    # algorithm.py train_one_step, policy_server.py): per-fragment
    # env/inference/connector/postprocess attribution — what the
    # rl_env_steps_scaling knee attribution and the timeline read
    "rllib",
    # continuous-profiling lifecycle (_private/sampling_profiler.py +
    # node.py ProfileStore retirement): profiler started/stopped, interval
    # backoff/reset, profile ship failures, dead-origin retirement — the
    # audit trail for why a window has thin (backed-off) or missing
    # (retired origin) flamegraph coverage
    "profile",
    # log plane (_private/log_plane.py + util/log_store.py + node.py):
    # error/traceback bursts from a single stream, worker-died-with-
    # uncollected-stderr crash explanations, dead-stream retirement —
    # what doctor's log_error_burst / worker_stderr_at_death rules read
    "log",
    # watchdog incident lifecycle (util/watchdog.py + util/incidents.py):
    # every open/ack/escalate/resolve transition of a tracked incident,
    # carrying the incident id, rule, and entity — the flight-recorder
    # audit trail `ray_tpu_torch incidents --history` and post-mortem bundles
    # cross-reference
    "incident",
)

# Kill switch for the whole observability layer (events + hot-path metric
# observations).  Initialized from the env, but MUTABLE module state read
# per-emit: the observability_overhead bench flips it at runtime in a live
# cluster (head + workers), so new instrumentation must not cache it.
ENABLED = os.environ.get("RAY_TPU_TORCH_EVENTS", "1") not in ("0", "false", "no")


def _int_env(name: str, default: int) -> int:
    """Shared env-int parse-with-fallback (util/tsdb.py imports these two
    rather than growing a third copy)."""
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _float_env(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


DEFAULT_CAPACITY = _int_env("RAY_TPU_TORCH_EVENTS_CAPACITY", 4096)
# per-source cap at the head (one cluster-wide table, bounded per source)
DEFAULT_TABLE_CAPACITY = _int_env("RAY_TPU_TORCH_EVENTS_TABLE_CAPACITY", 10_000)
DEFAULT_FLUSH_S = _float_env("RAY_TPU_TORCH_EVENTS_FLUSH_S", 2.0)


class EventBuffer:
    """Bounded ring of event records; memory stays O(capacity) forever
    (deque maxlen eviction).

    The hot half is :meth:`emit`: it appends one TUPLE (no dict build, no
    string formatting) so the per-event cost on instrumented paths like
    task dispatch stays ~1-2us; records materialize as dicts only when
    read (snapshot/ship), which happens at the pusher's cadence, not the
    workload's."""

    # tuple layout: (seq, ts, severity, source, message, entity_id,
    #               span_dur, data)
    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = max(1, int(capacity))
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0  # monotone id; lets the pusher ship only new events

    def emit(self, source: str, message: str, severity: str = "INFO",
             entity_id: Optional[str] = None, span_dur: Optional[float] = None,
             ts: Optional[float] = None, **data) -> None:
        # ts override: for span events recorded AFTER the fact (e.g. a
        # node loop emitting several input-edge waits once their trace
        # lineage is known), the caller passes the span's true end time
        if ts is None:
            ts = time.time()
        with self._lock:
            self._seq += 1
            self._ring.append((self._seq, ts, severity, source, message,
                               entity_id, span_dur, data or None))

    @staticmethod
    def _to_dict(rec) -> dict:
        seq, ts, severity, source, message, entity_id, span_dur, data = rec
        out = {"ts": ts, "severity": severity, "source": source,
               "message": message, "pid": os.getpid(), "seq": seq}
        if entity_id is not None:
            out["entity_id"] = entity_id
        if span_dur is not None:
            # span events: [ts - span_dur, ts] renders as a timeline slice
            out["span_dur"] = span_dur
        if data:
            out["data"] = data
        return out

    def snapshot(self, limit: Optional[int] = None) -> List[dict]:
        with self._lock:
            rows = list(self._ring)
        if limit:
            rows = rows[-limit:]
        return [self._to_dict(r) for r in rows]

    def since(self, seq: int) -> List[dict]:
        """Events with seq > ``seq`` (the pusher's incremental cursor)."""
        with self._lock:
            rows = [r for r in self._ring if r[0] > seq]
        return [self._to_dict(r) for r in rows]

    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


_BUFFER = EventBuffer()


def buffer() -> EventBuffer:
    return _BUFFER


def emit(source: str, message: str, severity: str = "INFO",
         entity_id: Optional[str] = None, span_dur: Optional[float] = None,
         ts: Optional[float] = None, **data) -> None:
    """Record one structured event in this process's ring (no-op when the
    observability layer is disabled)."""
    if not ENABLED:
        return
    _BUFFER.emit(source, message, severity, entity_id, span_dur, ts, **data)


def enabled() -> bool:
    return ENABLED


def local_events(limit: Optional[int] = None) -> List[dict]:
    return _BUFFER.snapshot(limit)


# Crash-dump files rotate (path -> path.1) past this size so a long-lived
# process's trail stays bounded on disk.
_DUMP_ROTATE_BYTES = 4 << 20


def append_dump(path: str, rows: List[dict]) -> Optional[str]:
    """Append events to the JSONL crash-dump file (one event per line).

    Incremental by design: rewriting the whole ring as one JSON blob every
    flush cycle held the GIL for tens of ms per rewrite and cost ~4% of
    task throughput on the head — appending only the NEW events is
    O(new), which is what makes the always-on crash dump affordable.

    Never raises: emit(**data) accepts arbitrary app payloads (numpy
    scalars included — hence ``default=repr``), and a dump failure must
    not kill the calling thread (the head's gcs-flush loop, a worker's
    pusher)."""
    if not rows:
        return None
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        try:
            if os.path.getsize(path) > _DUMP_ROTATE_BYTES:
                os.replace(path, path + ".1")
        except OSError:
            pass  # no file yet
        with open(path, "a") as f:
            f.write("\n".join(json.dumps(r, default=repr) for r in rows)
                    + "\n")
        return path
    except Exception:
        return None


def load_dump(path: str) -> List[dict]:
    """Read a JSONL crash-dump file back (skipping any torn final line a
    SIGKILL mid-write may have left)."""
    rows: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except ValueError:
                continue
    return rows


def dump_now(path: str) -> Optional[str]:
    """One-shot append of the WHOLE current ring (debug path — the
    periodic pushers use the incremental cursor instead)."""
    return append_dump(path, _BUFFER.snapshot())


class EventTable:
    """Head-side capped event directory: one ring per source so a chatty
    subsystem can never evict another's history."""

    def __init__(self, capacity_per_source: int = DEFAULT_TABLE_CAPACITY):
        self._cap = max(1, int(capacity_per_source))
        self._by_source: Dict[str, deque] = {}
        self._lock = threading.Lock()
        # monotonically increasing per-row counter + a ring of recent
        # (version, row) pairs: the watchdog's incremental cursor.  A
        # reader remembers the version it last saw and `since()` hands it
        # only the delta — no full-table pull per tick.
        self._version = 0
        self._recent: deque = deque(maxlen=self._cap)

    def add(self, origin: str, rows: List[dict]) -> None:
        with self._lock:
            for r in rows:
                if not isinstance(r, dict) or "source" not in r:
                    continue
                r = dict(r)
                r["origin"] = origin
                q = self._by_source.get(r["source"])
                if q is None:
                    q = self._by_source[r["source"]] = deque(maxlen=self._cap)
                q.append(r)
                self._version += 1
                self._recent.append((self._version, r))

    def version(self) -> int:
        """Monotonic ingest counter — unchanged version means no new rows
        since the caller's last look (the watchdog's cheap no-op check)."""
        with self._lock:
            return self._version

    def since(self, cursor: int) -> Tuple[List[dict], int]:
        """(rows ingested after ``cursor``, new cursor).  Bounded by the
        recent ring: a reader that falls further behind than the ring
        keeps only what is still resident (same contract as the per-source
        rings themselves — old rows are gone either way)."""
        with self._lock:
            rows = [r for v, r in self._recent if v > cursor]
            return rows, self._version

    def list(self, limit: int = 1000, source: Optional[str] = None,
             severity: Optional[str] = None) -> List[dict]:
        return self.list_with_total(limit, source, severity)[0]

    def list_with_total(self, limit: int = 1000, source: Optional[str] = None,
                        severity: Optional[str] = None,
                        ) -> Tuple[List[dict], int]:
        """(newest ``limit`` filtered rows, filtered total) in one pass —
        the state API's truncation marker needs the total, and computing
        it by listing the whole table a second time doubled the sort on
        every dashboard poll."""
        with self._lock:
            if source is not None:
                rows = list(self._by_source.get(source, ()))
            else:
                rows = [r for q in self._by_source.values() for r in q]
        if severity is not None:
            rows = [r for r in rows if r.get("severity") == severity]
        total = len(rows)
        rows.sort(key=lambda r: r.get("ts", 0.0))
        return rows[-limit:], total

    def sources(self) -> List[str]:
        with self._lock:
            return sorted(self._by_source)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {s: len(q) for s, q in self._by_source.items()}


DEFAULT_TRACE_CAPACITY = _int_env("RAY_TPU_TORCH_TRACE_CAPACITY", 512)
DEFAULT_TRACE_SPANS = _int_env("RAY_TPU_TORCH_TRACE_SPANS", 2048)

# event-data keys that are span LINEAGE (hoisted onto the span record);
# everything else in data stays as span attributes
_SPAN_KEYS = ("trace_id", "span_id", "parent_span_id", "phase")


class TraceTable:
    """Head-side per-trace span directory (``dashboard/state_aggregator``
    + OpenTelemetry-collector analog): any shipped event whose data
    carries a ``trace_id`` — ``trace``-source spans, traced compiled-graph
    node/channel spans — is folded into its trace's span list.

    Bounded both ways: at most ``max_traces`` traces (least-recently
    UPDATED evicted first, so a long-running trace stays resident while
    one-shot traces age out) and ``max_spans`` spans per trace, keeping
    the LAST N: spans are emitted when they CLOSE, so parents always
    arrive after their children and the root/ingress span arrives last
    of all — keep-last preserves the root and upper tree (what the span
    tree and wall-time attribution hang off), shedding the oldest leaf
    spans first.  ``dropped`` counts what was shed."""

    def __init__(self, max_traces: int = DEFAULT_TRACE_CAPACITY,
                 max_spans: int = DEFAULT_TRACE_SPANS):
        from collections import OrderedDict

        self._max_traces = max(1, int(max_traces))
        self._max_spans = max(1, int(max_spans))
        self._traces: "OrderedDict[str, dict]" = OrderedDict()
        self._lock = threading.Lock()

    @staticmethod
    def span_from_event(row: dict, origin: str) -> Optional[dict]:
        """Normalize one event row into a span record (None if the row
        carries no trace lineage)."""
        data = row.get("data") or {}
        tid = data.get("trace_id")
        ts = row.get("ts")
        if not tid or ts is None:
            return None
        dur = row.get("span_dur") or 0.0
        attrs = {k: v for k, v in data.items() if k not in _SPAN_KEYS}
        span = {
            "name": row.get("message", ""),
            "trace_id": tid,
            "span_id": data.get("span_id", ""),
            "parent_span_id": data.get("parent_span_id", ""),
            "phase": data.get("phase") or row.get("source", "span"),
            "source": row.get("source"),
            "origin": origin,
            "start": ts - dur,
            "end": ts,
        }
        if attrs:
            span["data"] = attrs
        return span

    def add(self, origin: str, rows: List[dict]) -> None:
        spans = []
        for r in rows:
            if isinstance(r, dict):
                span = self.span_from_event(r, origin)
                if span is not None:
                    spans.append(span)
        if not spans:
            return
        with self._lock:  # once per shipped batch, not per row
            for span in spans:
                tid = span["trace_id"]
                t = self._traces.get(tid)
                if t is None:
                    t = self._traces[tid] = {
                        "spans": deque(maxlen=self._max_spans),
                        "dropped": 0,
                        "first_ts": span["start"], "last_ts": span["end"],
                    }
                    while len(self._traces) > self._max_traces:
                        self._traces.popitem(last=False)
                else:
                    self._traces.move_to_end(tid)
                t["first_ts"] = min(t["first_ts"], span["start"])
                t["last_ts"] = max(t["last_ts"], span["end"])
                if len(t["spans"]) == self._max_spans:
                    t["dropped"] += 1  # maxlen evicts the oldest
                t["spans"].append(span)

    def get(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            t = self._traces.get(trace_id)
            if t is None:
                return None
            spans = sorted(t["spans"], key=lambda s: s["start"])
            return {"trace_id": trace_id, "spans": spans,
                    "dropped_spans": t["dropped"],
                    "first_ts": t["first_ts"], "last_ts": t["last_ts"]}

    def list(self, limit: int = 100) -> List[dict]:
        """Trace summaries, most recently updated last (the CLI shows the
        tail)."""
        with self._lock:
            items = list(self._traces.items())[-limit:]
            out = []
            for tid, t in items:
                roots = [s for s in t["spans"] if not s.get("parent_span_id")]
                root_name = roots[0]["name"] if roots else (
                    t["spans"][0]["name"] if t["spans"] else "")
                out.append({
                    "trace_id": tid, "name": root_name,
                    "num_spans": len(t["spans"]) + t["dropped"],
                    "start": t["first_ts"],
                    "duration_s": round(t["last_ts"] - t["first_ts"], 6),
                })
            return out

    def summarize(self) -> dict:
        with self._lock:
            durs = sorted(t["last_ts"] - t["first_ts"]
                          for t in self._traces.values())
            n = len(durs)
            if not n:
                return {"num_traces": 0}
            return {
                "num_traces": n,
                "num_spans": sum(len(t["spans"]) + t["dropped"]
                                 for t in self._traces.values()),
                "duration_p50_s": round(durs[n // 2], 6),
                "duration_p99_s": round(
                    durs[min(n - 1, int(n * 0.99))], 6),
                "duration_max_s": round(durs[-1], 6),
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)


class EventsPusher:
    """Background thread shipping this process's new events to the head
    (same control-connection path as ``metrics_report``) and rewriting the
    crash-dump file each cycle.  Send failures back off and retry; the
    loop only exits when stopped or the client is closed for good."""

    def __init__(self, send_fn, origin: str, interval_s: float = DEFAULT_FLUSH_S,
                 dump_path: Optional[str] = None, closed_fn=None):
        self._send = send_fn
        self._origin = origin
        self._interval = interval_s
        self._dump_path = dump_path
        self._closed = closed_fn
        self._stop = threading.Event()
        self._cursor = 0  # last seq shipped to the head
        self._dump_cursor = 0  # last seq appended to the crash dump
        # serializes flush() (exit path) against an in-flight loop cycle:
        # both read-modify-write the cursors, and an unsynchronized race
        # would ship/append the same batch twice
        self._flush_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="events-pusher")

    def start(self) -> "EventsPusher":
        if ENABLED:
            self._thread.start()
        return self

    def _dump_new(self) -> None:
        """Append events since the dump cursor to the crash-dump file.
        Independent cursor from shipping: a head outage must not stop the
        on-disk trail (and a dump failure must not re-ship)."""
        if not self._dump_path:
            return
        rows = _BUFFER.since(self._dump_cursor)
        if rows and append_dump(self._dump_path, rows):
            self._dump_cursor = rows[-1]["seq"]

    def flush(self) -> bool:
        """Synchronous ship+dump of anything new (used at exit and by
        tests; safe to call concurrently with the loop — the flush lock
        keeps the cursors single-writer).  Returns send success."""
        with self._flush_lock:
            self._dump_new()
            return self._ship_locked()

    def _ship_locked(self) -> bool:
        rows = _BUFFER.since(self._cursor)
        if not rows:
            return True
        try:
            self._send({"type": "events_report", "origin": self._origin,
                        "events": rows})
            self._cursor = max(self._cursor, rows[-1]["seq"])
            return True
        except Exception:
            return False  # cursor kept; retried next cycle

    def _loop(self) -> None:
        # the crash dump writes at EVERY interval regardless of head
        # health — only the send backs off.  A head outage is exactly
        # when the on-disk trail matters most.
        send_backoff = 0.0
        next_send = 0.0
        while not self._stop.wait(self._interval):
            if self._closed is not None and self._closed():
                return
            with self._flush_lock:
                self._dump_new()
                if time.monotonic() < next_send:
                    continue
                ok = self._ship_locked()
            if ok:
                send_backoff = 0.0
                next_send = 0.0
            else:
                # transient head hiccup: keep the cursor, retry with
                # bounded exponential backoff instead of dying silently
                send_backoff = min(
                    30.0, max(self._interval, send_backoff * 2))
                next_send = time.monotonic() + send_backoff

    def stop(self) -> None:
        self._stop.set()
        try:
            self.flush()
        except Exception:
            pass
