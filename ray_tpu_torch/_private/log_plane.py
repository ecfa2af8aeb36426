"""Cluster log plane: capture + ship (the consume side lives in
``util/log_store.py`` and the head).

Reference analog: ``python/ray/_private/log_monitor.py`` — a per-node
loop tails worker log files and publishes batched records so the driver
and ``ray logs`` see every process's output.  This module provides both
halves a *producing* process needs:

- **capture** (:func:`redirect_process_output`): dup2 fds 1/2 into a
  size-capped rotating per-process file under ``<session>/logs/`` and
  install :class:`ContextStampingStream` wrappers so every *line* written
  through Python (``print()`` included, not just the ``ray_tpu_torch`` logger)
  is prefixed with the writer's live context — job, task id, actor id,
  trace id — read from ``global_worker`` / ``tracing`` contextvars at
  write time.  C-level writes still land in the file (dup2), just
  unstamped.

- **ship** (:class:`LogMonitor`): tails registered files with
  rotation-safe offsets (inode change = rotated, size shrink = truncated;
  neither loses lines or re-ships old offsets), parses the stamps back
  into records, rate-limits each source to a counted ``(suppressed N
  lines)`` marker, and batch-ships over the existing control connection
  (``{"type": "log_report"}``, the ``metrics_report`` path) — or straight
  into the head's store via ``ingest_fn`` when it runs in-process.

Line-prefix protocol: ``\\x1frt1|<src>|<job>|<task>|<actor>|<trace>\\x1f``
before the text.  ``\\x1f`` (unit separator) never appears in normal
output; a line without the prefix is shipped as-is with empty context.
``src`` is one char: ``o`` stdout, ``e`` stderr, a level letter
(``D/I/W/E/C``) for logger records, ``m`` for suppression markers.

Knobs: ``RAY_TPU_TORCH_LOG_ROTATE_BYTES`` (per-file cap, default 16 MiB, one
``.1`` backup), ``RAY_TPU_TORCH_LOG_SHIP_S`` (tail/ship cadence, default 1s),
``RAY_TPU_TORCH_LOG_RATE_LPS`` (per-source lines/s before suppression,
default 2000), ``RAY_TPU_TORCH_LOG_TO_DRIVER=0`` (driver-side, stop
re-emitting job records).
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple


def enabled() -> bool:
    """RAY_TPU_TORCH_LOG_PLANE=0 turns the whole plane off: capture falls back
    to plain (unstamped) redirection and no monitor threads run."""
    return os.environ.get("RAY_TPU_TORCH_LOG_PLANE", "1") != "0"

STAMP = "\x1f"
_VER = "rt1"
_PREFIX = STAMP + _VER + "|"

# record tuple layout (wire + store):
# (ts, stream, src, job, task, actor, trace, line)
REC_TS, REC_STREAM, REC_SRC, REC_JOB, REC_TASK, REC_ACTOR, REC_TRACE, \
    REC_LINE = range(8)

_MAX_LINE = 4096  # clamp pathological lines; keeps rings and wire bounded


def _int_env(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _float_env(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


# Context-epoch cache: the full lookup below costs ~750ns, which at
# thousands of print()s per second is the plane's single biggest cost.
# The values only change when the worker enters/leaves a task or a trace
# context opens/closes — those sites call bump_context_epoch(), and each
# thread reuses its cached (fields, stamp body) until the epoch moves.
# The epoch is read BEFORE computing, so a concurrent bump can only mark
# fresh fields as stale (a spurious recompute), never serve stale ones.
_epoch = 0
_tls = threading.local()


def bump_context_epoch() -> None:
    """Called by worker/tracing wherever execution context changes."""
    global _epoch
    _epoch += 1


def context_fields() -> Tuple[str, str, str, str]:
    """(job, task, actor, trace) of the *calling thread*, as hex strings
    ("" when absent)."""
    cached = getattr(_tls, "ctx", None)
    if cached is not None and cached[0] == _epoch:
        return cached[1]
    e = _epoch
    fields = _context_fields_uncached()
    # [3] caches the fully formatted stamp per src for this context
    _tls.ctx = (e, fields, "|".join(fields), {})
    return fields


def _context_fields_uncached() -> Tuple[str, str, str, str]:
    """Lazy sys.modules lookups: this runs inside ``print()`` and must
    not import anything (import locks inside a write() re-entering an
    importing thread deadlocks)."""
    job = task = actor = trace = ""
    w = sys.modules.get("ray_tpu_torch._private.worker")
    if w is not None:
        gw = w.global_worker
        j = gw.current_job_id or gw.job_id
        if j:
            job = str(j)
        t = gw.current_task_id
        if t:
            task = t.hex() if isinstance(t, bytes) else str(t)
        a = gw.current_actor_id
        if a:
            actor = a.hex() if isinstance(a, bytes) else str(a)
    tr = sys.modules.get("ray_tpu_torch.util.tracing")
    if tr is not None:
        try:
            ctx = tr.current_context()
        except Exception:
            ctx = None
        if ctx:
            trace = str(ctx.get("trace_id") or "")
    return job, task, actor, trace


def format_stamp(src: str) -> str:
    """The line prefix for a record written NOW by this thread."""
    cached = getattr(_tls, "ctx", None)
    if cached is None or cached[0] != _epoch:
        context_fields()
        cached = _tls.ctx
    stamp = cached[3].get(src)
    if stamp is None:
        stamp = cached[3][src] = _PREFIX + src + "|" + cached[2] + STAMP
    return stamp


def parse_line(raw: str, default_src: str = "o"):
    """``(src, job, task, actor, trace, text)`` from one tailed line.
    Unstamped lines (C-level writes, pre-redirect output) come back with
    empty context and ``default_src``."""
    if raw.startswith(_PREFIX):
        end = raw.find(STAMP, len(_PREFIX))
        if end != -1:
            head = raw[len(_PREFIX):end]
            parts = head.split("|")
            if len(parts) == 5:
                src, job, task, actor, trace = parts
                return src or default_src, job, task, actor, trace, raw[end + 1:]
    return default_src, "", "", "", "", raw


class _RotatingFile:
    """Owns the capture file shared by fds 1 and 2: tracks size, and past
    the cap renames ``path`` -> ``path.1`` and re-dup2s a fresh file onto
    both fds.  One backup: a log-spamming process costs at most
    2x rotate_bytes of disk, matching the reference's capped worker
    logs."""

    def __init__(self, path: str, max_bytes: int, fds=(1, 2)):
        self.path = path
        self.max_bytes = max_bytes
        self.fds = tuple(fds)
        self.lock = threading.Lock()
        try:
            self.size = os.path.getsize(path)
        except OSError:
            self.size = 0

    def wrote(self, n: int) -> None:
        # unlocked add: += under the GIL can drop a race's worth of
        # bytes, which only delays an (approximate by design) rotation —
        # not worth a lock acquire inside every print()
        self.size += n
        if self.size < self.max_bytes:
            return
        with self.lock:
            if self.size < self.max_bytes:
                return  # another thread just rotated
            try:
                os.replace(self.path, self.path + ".1")
                fd = os.open(self.path,
                             os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
                for target in self.fds:
                    os.dup2(fd, target)
                os.close(fd)
                self.size = 0
            except OSError:
                # rotation is best-effort; keep writing to the old inode
                self.size = 0


class ContextStampingStream:
    """Line-buffered text stream over a redirected fd that prefixes every
    line with the live context stamp.  Installed as ``sys.stdout``/
    ``sys.stderr`` after dup2 so plain ``print()`` is correlated.

    Does its own line buffering with direct ``os.write`` at newline
    boundaries — one syscall per complete line, no TextIOWrapper newline
    scan — because this sits inside every ``print()`` the process makes
    and its cost over the disabled path is what the
    ``log_plane_overhead`` bench gates.  Never raises from ``write`` —
    logging must never kill the process it observes."""

    _rt_log_plane = True  # logging_utils checks this to pre-stamp records

    encoding = "utf-8"
    errors = "replace"
    newlines = None

    def __init__(self, fd: int, src: str, rot: Optional[_RotatingFile] = None):
        self._fd = fd
        self._src = src
        self._rot = rot
        self._lock = threading.Lock()
        self._at_start = True
        self._buf: List[str] = []  # pending partial line (already stamped)

    def _emit(self, data: str) -> None:
        """os.write the whole encoded chunk (lock held by caller)."""
        raw = data.encode("utf-8", "replace")
        n = os.write(self._fd, raw)
        while n < len(raw):  # short writes only on pipes/signals
            n += os.write(self._fd, raw[n:])
        if self._rot is not None:
            self._rot.wrote(n)

    def write(self, s) -> int:
        if not s:
            return 0
        if not isinstance(s, str):
            s = str(s)
        try:
            with self._lock:
                # fast path: at most one newline, at the end — the two
                # shapes print() emits (the joined text, then its
                # end="\n")
                nl = s.find("\n")
                if nl == -1 or nl == len(s) - 1:
                    if self._at_start and not s.startswith(STAMP):
                        s2 = format_stamp(self._src) + s
                    else:
                        s2 = s
                    if nl == -1:
                        self._buf.append(s2)
                        self._at_start = False
                    else:
                        if self._buf:
                            self._buf.append(s2)
                            s2 = "".join(self._buf)
                            self._buf.clear()
                        self._emit(s2)
                        self._at_start = True
                    return len(s)
                # slow path: several lines in one call
                parts = s.split("\n")
                tail = parts.pop()  # partial line ("" when s ends in \n)
                out = self._buf[:]
                self._buf.clear()
                for seg in parts:
                    if self._at_start and not seg.startswith(STAMP):
                        out.append(format_stamp(self._src))
                    out.append(seg)
                    out.append("\n")
                    self._at_start = True
                self._emit("".join(out))
                if tail:
                    if not tail.startswith(STAMP):
                        self._buf.append(format_stamp(self._src))
                    self._buf.append(tail)
                    self._at_start = False
        except (OSError, ValueError):
            pass
        return len(s)

    def writelines(self, lines) -> None:
        for ln in lines:
            self.write(ln)

    def write_record(self, src: str, text: str) -> None:
        """One pre-formatted record line with an explicit src (logger
        levels): stamps with ``src`` regardless of this stream's own.
        A pending partial print() line is terminated first — a logger
        record never glues onto someone else's line."""
        if not text.endswith("\n"):
            text += "\n"
        try:
            with self._lock:
                out = format_stamp(src) + text
                if self._buf:
                    self._buf.append("\n")
                    self._buf.append(out)
                    out = "".join(self._buf)
                    self._buf.clear()
                self._emit(out)
                self._at_start = True
        except (OSError, ValueError):
            pass

    def flush(self) -> None:
        try:
            with self._lock:
                if self._buf:
                    self._emit("".join(self._buf))
                    self._buf.clear()
                    # the partial line is on disk but still open; the
                    # next write continues it unstamped
        except (OSError, ValueError):
            pass

    def fileno(self) -> int:
        return self._fd

    def isatty(self) -> bool:
        return False

    def writable(self) -> bool:
        return True

    def readable(self) -> bool:
        return False

    def seekable(self) -> bool:
        return False

    def close(self) -> None:  # never close a process-level fd from here
        self.flush()


def redirect_process_output(path: str, fds=(1, 2)) -> bool:
    """dup2 this process's stdout/stderr into a rotating capture file at
    ``path`` and install stamping wrappers.  The worker-boot invariant
    holds: any failure leaves the process on its inherited fds.  With the
    plane disabled (``RAY_TPU_TORCH_LOG_PLANE=0``) the redirect still happens
    (the file is the crash trail) but lines go through plain unstamped
    streams — the bench's disabled-path baseline."""
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        for target in fds:
            os.dup2(fd, target)
        os.close(fd)
        if not enabled():
            if 1 in fds:
                sys.stdout = os.fdopen(1, "w", buffering=1, closefd=False)
            if 2 in fds:
                sys.stderr = os.fdopen(2, "w", buffering=1, closefd=False)
            return True
        rot = _RotatingFile(
            path, _int_env("RAY_TPU_TORCH_LOG_ROTATE_BYTES", 16 << 20), fds)
        if 1 in fds:
            sys.stdout = ContextStampingStream(1, "o", rot)
        if 2 in fds:
            sys.stderr = ContextStampingStream(2, "e", rot)
        return True
    except OSError:
        return False


class StampedFileHandler(logging.Handler):
    """Mirror a process's ``ray_tpu_torch.*`` logger records into a stamped,
    size-capped capture file.  For processes that must NOT dup2 their
    fds away (the head shares the driver's tty): the user keeps their
    terminal output, the log plane still gets a tailable per-process
    file."""

    def __init__(self, path: str, max_bytes: Optional[int] = None):
        super().__init__()
        self.path = path
        self.max_bytes = (max_bytes if max_bytes is not None
                          else _int_env("RAY_TPU_TORCH_LOG_ROTATE_BYTES", 16 << 20))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._f = open(path, "a", errors="replace")
        try:
            self._size = os.path.getsize(path)
        except OSError:
            self._size = 0

    _LEVEL_SRC = {"DEBUG": "D", "INFO": "I", "WARNING": "W",
                  "ERROR": "E", "CRITICAL": "C"}

    def emit(self, record: logging.LogRecord) -> None:
        try:
            src = self._LEVEL_SRC.get(record.levelname, "I")
            line = format_stamp(src) + self.format(record) + "\n"
            # no inner locking: logging.Handler.handle() already holds
            # self.lock around emit(), so writes and the rotation swap
            # are serialized by the framework
            self._f.write(line)
            self._f.flush()
            self._size += len(line)
            if self._size >= self.max_bytes:
                self._f.close()
                os.replace(self.path, self.path + ".1")
                self._f = open(self.path, "a", errors="replace")
                self._size = 0
        except Exception:
            self.handleError(record)

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:
            pass
        super().close()


def attach_logger_capture(path: str) -> Optional[StampedFileHandler]:
    """Attach a StampedFileHandler for every ``ray_tpu_torch.*`` logger record
    in this process (head self-capture).  Returns the handler so the
    caller can detach it at shutdown."""
    try:
        h = StampedFileHandler(path)
    except OSError:
        return None
    h.setFormatter(logging.Formatter(
        "[ray_tpu_torch %(levelname)s %(name)s] %(message)s"))
    logging.getLogger("ray_tpu_torch").addHandler(h)
    return h


def make_driver_log_callback(out_fn: Optional[Callable[[str], None]] = None):
    """Pubsub callback re-emitting a job's shipped log records on the
    driver, prefixed ``(name pid=… node=…)`` like the reference's
    print_to_stdstream.  Error-ish records go to the driver's stderr,
    the rest to stdout."""

    def _cb(data) -> None:
        for r in (data or {}).get("records") or []:
            try:
                name = r.get("name") or r.get("stream") or "?"
                prefix = f"({name} pid={r.get('pid')}, node={r.get('node')})"
                text = f"{prefix} {r.get('line', '')}"
                if out_fn is not None:
                    out_fn(text)
                    continue
                src = r.get("src", "o")
                stream = (sys.stderr if src in ("e", "E", "C", "W")
                          else sys.stdout)
                print(text, file=stream)
            except Exception:
                return  # a broken sink must not kill the pubsub thread

    return _cb


class _Tail:
    __slots__ = ("stream", "path", "meta", "fd", "carry", "tokens",
                 "tok_t", "suppressed", "default_src")

    def __init__(self, stream: str, path: str, meta: dict, now: float):
        self.stream = stream
        self.path = path
        self.meta = meta
        self.fd: Optional[int] = None
        self.carry = b""
        self.tokens: float = 0.0
        self.tok_t = now
        self.suppressed = 0
        self.default_src = "o"


class LogMonitor:
    """Rotation-safe multi-file tailer (reference ``LogMonitor``).

    Files are *registered* (not dir-scanned) so ownership is explicit: on
    an emulated multi-node host the head and an agent may share one
    session dir, and each must ship only its own workers' files or every
    line arrives twice.  ``send_fn`` ships ``log_report`` frames over a
    control connection (node agent); ``ingest_fn`` feeds the head's store
    directly when the monitor runs inside the head process.

    Offsets live in the open fd. Per poll: drain the fd to EOF, then
    compare ``stat(path)`` to ``fstat(fd)`` — a different inode means the
    file rotated under us (the drained fd already holds every old line;
    reopen at 0), a shrunken same-inode file means truncation (seek 0).
    Old offsets are never re-shipped because the old inode's fd is the
    only cursor that ever read it."""

    def __init__(self, origin: str,
                 send_fn: Optional[Callable[[dict], None]] = None,
                 ingest_fn: Optional[Callable] = None,
                 interval_s: Optional[float] = None,
                 rate_lps: Optional[float] = None,
                 max_batch_lines: int = 2000,
                 max_read_bytes: int = 1 << 20,
                 closed_fn: Callable[[], bool] = lambda: False):
        self.origin = origin
        # named `send`, not `_send_fn`: this IS the monitor's wire-send
        # call, and raylint R1 pairs its log_report frames with the
        # head's dispatch arm through that name
        self.send = send_fn
        self._ingest_fn = ingest_fn
        self.interval_s = (interval_s if interval_s is not None
                           else _float_env("RAY_TPU_TORCH_LOG_SHIP_S", 1.0))
        self.rate_lps = (rate_lps if rate_lps is not None
                         else _float_env("RAY_TPU_TORCH_LOG_RATE_LPS", 2000.0))
        self.max_batch_lines = max_batch_lines
        self.max_read_bytes = max_read_bytes
        self._closed_fn = closed_fn
        self._tails: Dict[str, _Tail] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- registration ---------------------------------------------------
    def register(self, stream: str, path: str, **meta) -> None:
        now = time.time()
        with self._lock:
            if stream in self._tails:
                return
            t = _Tail(stream, path, meta, now)
            t.tokens = self.rate_lps  # full bucket at birth
            if meta.get("src"):
                t.default_src = meta["src"]
            self._tails[stream] = t

    def unregister(self, stream: str, final_drain: bool = True) -> None:
        """Drop a stream, shipping whatever the file gained since the
        last poll first — this is how a SIGKILL'd worker's final stderr
        reaches the head after death."""
        with self._lock:
            t = self._tails.pop(stream, None)
        if t is None:
            return
        if final_drain:
            recs = self._drain(t, time.time(), final=True)
            if recs:
                self._ship(recs, {t.stream: t.meta})
        if t.fd is not None:
            try:
                os.close(t.fd)
            except OSError:
                pass

    def streams(self) -> List[str]:
        with self._lock:
            return list(self._tails)

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "LogMonitor":
        t = threading.Thread(target=self._loop, name="log-monitor",
                             daemon=True)
        t.start()
        self._thread = t
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self.poll_once()  # final ship while the connection is still live

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            if self._closed_fn():
                return
            try:
                self.poll_once()
            except Exception:
                # the tail loop must outlive any single bad file
                pass

    # -- tailing --------------------------------------------------------
    def poll_once(self, now: Optional[float] = None) -> int:
        """Tail every registered file once; ship complete lines.  Returns
        the number of records shipped (tests drive this directly)."""
        if now is None:
            now = time.time()
        with self._lock:
            tails = list(self._tails.values())
        records: List[tuple] = []
        metas: Dict[str, dict] = {}
        for t in tails:
            recs = self._drain(t, now)
            if recs:
                records.extend(recs)
                metas[t.stream] = t.meta
        if records:
            self._ship(records, metas)
        return len(records)

    def _drain(self, t: _Tail, now: float, final: bool = False) -> List[tuple]:
        if t.fd is None:
            try:
                t.fd = os.open(t.path, os.O_RDONLY)
            except OSError:
                return []
        chunks = []
        budget = self.max_read_bytes
        eof = False
        try:
            while budget > 0:
                chunk = os.read(t.fd, min(65536, budget))
                if not chunk:
                    eof = True
                    break
                chunks.append(chunk)
                budget -= len(chunk)
            # rotation/truncation checks only once the old fd is fully
            # drained: closing it with bytes still unread would lose them
            if eof:
                try:
                    st = os.stat(t.path)
                except OSError:
                    st = None  # mid-rotation rename; next poll reopens
                fst = os.fstat(t.fd)
                if st is None or st.st_ino != fst.st_ino:
                    # rotated: the drained fd held the complete old file —
                    # terminate any carried partial as its final line, then
                    # follow the new inode from offset 0
                    last_data = chunks[-1] if chunks else t.carry
                    if last_data and not last_data.endswith(b"\n"):
                        chunks.append(b"\n")
                    os.close(t.fd)
                    t.fd = None
                    if st is not None:
                        try:
                            t.fd = os.open(t.path, os.O_RDONLY)
                        except OSError:
                            t.fd = None
                elif st.st_size < os.lseek(t.fd, 0, os.SEEK_CUR):
                    # truncated in place: restart from the top
                    os.lseek(t.fd, 0, os.SEEK_SET)
                    t.carry = b""
        except OSError:
            return []
        data = t.carry + b"".join(chunks)
        if not data:
            return []
        lines = data.split(b"\n")
        t.carry = lines.pop()  # trailing partial (b"" when data ends in \n)
        if final and t.carry:
            lines.append(t.carry)
            t.carry = b""
        # refill the token bucket, then spend it; overflow becomes one
        # counted marker instead of a head-melting flood
        t.tokens = min(self.rate_lps * 2,
                       t.tokens + (now - t.tok_t) * self.rate_lps)
        t.tok_t = now
        out: List[tuple] = []
        stream, dsrc, plen = t.stream, t.default_src, len(_PREFIX)
        for idx, raw in enumerate(lines):
            if t.tokens < 1.0:
                # everything past here is over budget: count, don't parse
                t.suppressed += len(lines) - idx
                break
            t.tokens -= 1.0
            if t.suppressed:
                out.append((now, stream, "m", "", "", "", "",
                            f"(suppressed {t.suppressed} lines)"))
                t.suppressed = 0
            line = raw[:_MAX_LINE].decode("utf-8", "replace")
            # parse_line, inlined: this loop is the head/agent-side cost
            # of a log flood (the bench's tail_ship number)
            if line.startswith(_PREFIX):
                end = line.find(STAMP, plen)
                if end != -1:
                    parts = line[plen:end].split("|")
                    if len(parts) == 5:
                        out.append((now, stream, parts[0] or dsrc, parts[1],
                                    parts[2], parts[3], parts[4],
                                    line[end + 1:]))
                        continue
            out.append((now, stream, dsrc, "", "", "", "", line))
        if final and t.suppressed:
            out.append((now, t.stream, "m", "", "", "", "",
                        f"(suppressed {t.suppressed} lines)"))
            t.suppressed = 0
        return out

    def _ship(self, records: List[tuple], metas: Dict[str, dict]) -> None:
        for i in range(0, len(records), self.max_batch_lines):
            batch = records[i:i + self.max_batch_lines]
            if self._ingest_fn is not None:
                try:
                    self._ingest_fn(self.origin, batch, metas)
                except Exception:
                    pass
            if self.send is not None:
                try:
                    self.send({"type": "log_report",
                               "origin": self.origin,
                               "records": batch, "streams": metas})
                except (OSError, ValueError):
                    return  # connection gone; the closed_fn ends the loop
