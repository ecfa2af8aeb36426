"""Head-side bounded log store (the consume half of the log plane; the
port's copy of ``ray_tpu/util/log_store.py``).

The ProfileStore/TSDB pattern applied to log records: per-stream rings
under a global byte cap with LRU eviction and dead-stream retirement, so
an arbitrarily chatty cluster costs the head a fixed amount of memory.
Records arrive from :class:`~ray_tpu_torch._private.log_plane.LogMonitor`
batches (``log_report`` frames from node agents, direct ``ingest`` from
the head's own monitor) already parsed into
``(ts, stream, src, job, task, actor, trace, line)`` tuples; the store
adds a global monotone ``seq`` so ``ray_tpu_torch logs --follow`` and driver
streaming can cursor past data they have already seen.

Retired streams (their worker died) keep their ring until
:meth:`retire_stale`'s horizon passes — that is what makes a SIGKILL'd
worker's last stderr retrievable from the head after death.

Error bursts: the store watches error line rates per stream and emits
one ``log``-source flight-recorder event per burst (via the injected
``emit_fn`` — no import edge back into ``_private``), which the doctor's
``log_error_burst`` rule surfaces.  An error line is an ERROR/CRITICAL
logger record, a traceback's head, or a stderr line that carries a level
word (``ERROR``, ``CRITICAL``, ``FATAL``) or lies in a traceback: a
healthy process that merely writes to stderr opens no burst
(``burst_line``; the JAX store counts every stderr line).

Caps are constructor params so tests can force every stage cheaply;
their defaults are those of ``ray_tpu/util/log_store.py``: 32 MiB in all, 10,000 lines a
stream, 512 streams, and a burst of 50 error lines inside 30 s.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

# incoming record layout (log_plane wire tuples)
_TS, _STREAM, _SRC, _JOB, _TASK, _ACTOR, _TRACE, _LINE = range(8)

_ERR_SRCS = ("e", "E", "C")


def is_error_record(src: str, line: str) -> bool:
    """stderr output, ERROR/CRITICAL logger records, and traceback bodies
    count toward ``--errors`` and burst detection."""
    return src in _ERR_SRCS or line.startswith("Traceback (")


# a level word that marks a stderr line as an error report
_ERR_MARKER = re.compile(r"\b(?:ERROR|CRITICAL|FATAL)\b")
_TB_HEAD = "Traceback (most recent call last)"
# what a launcher puts before each line of a rank's output ("[rank0]: ")
_LINE_PREFIX = re.compile(r"\[[^\]]*\]:\s?")


def burst_line(src: str, line: str, in_traceback: bool = False) -> Tuple[bool, bool]:
    """Whether a record counts toward burst detection, and whether its
    stream is inside a traceback after it.  ERROR/CRITICAL logger records
    and traceback heads count, as ``is_error_record``.  A stderr line
    counts when it carries an error level word or lies in a traceback:
    its head (``Traceback (most recent call last)`` anywhere in the line,
    so behind a ``[rank0]: `` prefix too), its indented frames, and the
    first unindented line after them (the exception), which ends it.
    Counting every stderr line read a process that logs to stderr (a
    progress line a call) as an error burst."""
    if src != "e":
        return is_error_record(src, line), in_traceback
    if _TB_HEAD in line:
        return True, True
    if in_traceback:
        m = _LINE_PREFIX.match(line)
        body = line[m.end():] if m else line
        return True, not body or body[0].isspace()
    return bool(_ERR_MARKER.search(line)), False


class _Stream:
    __slots__ = ("ring", "bytes", "meta", "last_ingest", "retired",
                 "err_times", "burst_at", "total_lines", "in_traceback")

    def __init__(self, meta: dict, now: float):
        # stored tuples: (seq, ts, src, job, task, actor, trace, line)
        self.ring: deque = deque()
        self.bytes = 0
        self.meta = dict(meta or {})
        self.last_ingest = now
        self.retired = False
        self.err_times: deque = deque()
        self.burst_at = 0.0
        self.total_lines = 0
        self.in_traceback = False  # burst_line's state of the stream


class LogStore:
    def __init__(self,
                 max_lines_per_stream: Optional[int] = None,
                 max_total_bytes: Optional[int] = None,
                 max_streams: Optional[int] = None,
                 burst_n: Optional[int] = None,
                 burst_window_s: Optional[float] = None,
                 emit_fn: Optional[Callable] = None):
        self.max_lines_per_stream = (
            max_lines_per_stream if max_lines_per_stream is not None
            else 10_000)
        self.max_total_bytes = (
            max_total_bytes if max_total_bytes is not None else 32 << 20)
        self.max_streams = max_streams if max_streams is not None else 512
        self.burst_n = burst_n if burst_n is not None else 50
        self.burst_window_s = (burst_window_s if burst_window_s is not None
                               else 30.0)
        self.emit_fn = emit_fn
        self._streams: Dict[str, _Stream] = {}
        self._total_bytes = 0
        self._seq = 0
        # cumulative ship-pressure counters (never decremented): total
        # records absorbed and suppression markers among them — the
        # ray_tpu_log_records_total / _suppressed_total gauge sources
        self._ingested_total = 0
        self._suppressed_total = 0
        self._lock = threading.Lock()

    # -- ingest ---------------------------------------------------------
    def ingest(self, node: str, records: List[tuple],
               metas: Optional[Dict[str, dict]] = None,
               now: Optional[float] = None) -> Dict[str, List[tuple]]:
        """Absorb one shipped batch.  Returns records grouped by job —
        ``{job: [(seq, ts, stream, src, task, actor, trace, line), ...]}``
        — so the head can publish each job's slice to its subscribed
        drivers without a second pass."""
        if now is None:
            now = time.time()
        by_job: Dict[str, List[tuple]] = {}
        bursts: List[Tuple[str, int, dict]] = []
        with self._lock:
            for rec in records:
                name = rec[_STREAM]
                st = self._streams.get(name)
                if st is None:
                    meta = dict((metas or {}).get(name) or {})
                    meta.setdefault("node", node)
                    st = _Stream(meta, now)
                    self._streams[name] = st
                    self._evict_streams_locked()
                elif metas and name in metas:
                    st.meta.update(metas[name])
                    st.meta.setdefault("node", node)
                self._seq += 1
                self._ingested_total += 1
                if rec[_SRC] == "m":  # suppression marker record
                    self._suppressed_total += 1
                line = rec[_LINE]
                stored = (self._seq, rec[_TS], rec[_SRC], rec[_JOB],
                          rec[_TASK], rec[_ACTOR], rec[_TRACE], line)
                st.ring.append(stored)
                cost = len(line) + 64
                st.bytes += cost
                self._total_bytes += cost
                st.last_ingest = now
                st.total_lines += 1
                if len(st.ring) > self.max_lines_per_stream:
                    old = st.ring.popleft()
                    drop = len(old[7]) + 64
                    st.bytes -= drop
                    self._total_bytes -= drop
                if rec[_JOB]:
                    by_job.setdefault(rec[_JOB], []).append(
                        (self._seq, rec[_TS], name, rec[_SRC], rec[_TASK],
                         rec[_ACTOR], rec[_TRACE], line))
                counts, st.in_traceback = burst_line(rec[_SRC], line,
                                                     st.in_traceback)
                if counts:
                    st.err_times.append(rec[_TS])
                    horizon = now - self.burst_window_s
                    while st.err_times and st.err_times[0] < horizon:
                        st.err_times.popleft()
                    if (len(st.err_times) >= self.burst_n
                            and now - st.burst_at > self.burst_window_s):
                        st.burst_at = now
                        bursts.append((name, len(st.err_times),
                                       dict(st.meta)))
            self._enforce_locked()
        if self.emit_fn is not None:
            for name, n, meta in bursts:
                try:
                    self.emit_fn(
                        "log",
                        f"error burst: {n} error/traceback lines in "
                        f"{self.burst_window_s:.0f}s from {name}",
                        severity="WARNING", entity_id=name,
                        node=meta.get("node"), pid=meta.get("pid"))
                except Exception:
                    pass
        return by_job

    def _evict_streams_locked(self) -> None:
        while len(self._streams) > self.max_streams:
            victim = min(self._streams,
                         key=lambda k: self._streams[k].last_ingest)
            self._total_bytes -= self._streams[victim].bytes
            del self._streams[victim]

    def _enforce_locked(self) -> None:
        """Byte pressure: shed the oldest records of the least-recently
        active streams first — a quiet stream's history yields to a live
        one's present, the LRU shape every other head store uses."""
        if self._total_bytes <= self.max_total_bytes:
            return
        order = sorted(self._streams.values(), key=lambda s: s.last_ingest)
        for st in order:
            while st.ring and self._total_bytes > self.max_total_bytes:
                old = st.ring.popleft()
                drop = len(old[7]) + 64
                st.bytes -= drop
                self._total_bytes -= drop
            if self._total_bytes <= self.max_total_bytes:
                return

    # -- lifecycle ------------------------------------------------------
    def retire(self, stream: str) -> None:
        """Its process died: stop expecting ingest but KEEP the ring so
        the death tail stays queryable until retire_stale's horizon."""
        with self._lock:
            st = self._streams.get(stream)
            if st is not None:
                st.retired = True

    def retire_stale(self, max_age_s: float,
                     now: Optional[float] = None) -> List[str]:
        """Drop retired streams idle past ``max_age_s``.  Returns the
        dropped names so the caller can emit events."""
        if now is None:
            now = time.time()
        dropped = []
        with self._lock:
            for name in list(self._streams):
                st = self._streams[name]
                if st.retired and now - st.last_ingest > max_age_s:
                    self._total_bytes -= st.bytes
                    del self._streams[name]
                    dropped.append(name)
        return dropped

    # -- queries --------------------------------------------------------
    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def query(self, stream: Optional[str] = None, job: Optional[str] = None,
              task: Optional[str] = None, actor: Optional[str] = None,
              node: Optional[str] = None, pid: Optional[int] = None,
              trace: Optional[str] = None, grep: Optional[str] = None,
              errors: bool = False, since_seq: int = 0,
              limit: int = 1000) -> Tuple[List[dict], int]:
        """Filtered records as dicts, oldest-first, the LAST ``limit``
        matches.  Returns ``(rows, cursor)`` where ``cursor`` is the max
        seq in the store — pass it back as ``since_seq`` to follow."""
        needle = grep.lower() if grep else None
        out: List[dict] = []
        with self._lock:
            cursor = self._seq
            for name, st in self._streams.items():
                if stream is not None and name != stream:
                    continue
                if node is not None and st.meta.get("node") != node:
                    continue
                if pid is not None and st.meta.get("pid") != pid:
                    continue
                for (seq, ts, src, rjob, rtask, ractor, rtrace,
                     line) in st.ring:
                    if seq <= since_seq:
                        continue
                    if job is not None and rjob != job:
                        continue
                    if task is not None and rtask != task:
                        continue
                    if actor is not None and ractor != actor:
                        continue
                    if trace is not None and rtrace != trace:
                        continue
                    if errors and not is_error_record(src, line):
                        continue
                    if needle is not None and needle not in line.lower():
                        continue
                    out.append({"seq": seq, "ts": ts, "stream": name,
                                "src": src, "job": rjob, "task": rtask,
                                "actor": ractor, "trace": rtrace,
                                "line": line,
                                "node": st.meta.get("node"),
                                "pid": st.meta.get("pid")})
        out.sort(key=lambda r: r["seq"])
        if limit and len(out) > limit:
            out = out[-limit:]
        return out, cursor

    def tail_text(self, stream: str, n: int = 100,
                  errors_only: bool = False) -> List[str]:
        """The last ``n`` raw lines of one stream (death tails, CLI
        ``tail_log``)."""
        with self._lock:
            st = self._streams.get(stream)
            if st is None:
                return []
            recs = list(st.ring)
        if errors_only:
            recs = [r for r in recs if is_error_record(r[2], r[7])]
        return [r[7] for r in recs[-n:]]

    def __contains__(self, stream: str) -> bool:
        with self._lock:
            return stream in self._streams

    def stream_meta(self, stream: str) -> dict:
        with self._lock:
            st = self._streams.get(stream)
            return dict(st.meta) if st is not None else {}

    def counters(self) -> Dict[str, int]:
        """Cumulative ship-pressure counters: records absorbed since
        boot and suppression markers among them (each marker stands for
        a burst the source-side limiter dropped)."""
        with self._lock:
            return {"ingested_total": self._ingested_total,
                    "suppressed_total": self._suppressed_total}

    def stats(self) -> List[dict]:
        """One row per stream — the state API's ``logs`` table."""
        with self._lock:
            # linear snapshot only while held; the O(n log n) sort and
            # row assembly run after release
            snap = [(name, dict(st.meta),
                     st.ring[-1][1] if st.ring else None,
                     len(st.ring), st.total_lines, st.bytes, st.retired)
                    for name, st in self._streams.items()]
        snap.sort(key=lambda r: r[0])
        return [{"stream": name,
                 "node": meta.get("node"),
                 "pid": meta.get("pid"),
                 "job": meta.get("job"),
                 "lines": lines,
                 "total_lines": total_lines,
                 "bytes": nbytes,
                 "retired": retired,
                 "last_ts": last_ts}
                for name, meta, last_ts, lines, total_lines, nbytes,
                retired in snap]
