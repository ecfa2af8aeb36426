"""In-process sampling profilers — the py-spy analog of the reference's
``dashboard/modules/reporter/profile_manager.py`` (the port's copy of
``ray_tpu/_private/sampling_profiler.py``), in two duty cycles:

- :class:`SamplingProfiler`: dense sampling of one process for a bounded
  window (:func:`profile_for`).  ~1-2% overhead at the default 2 ms
  period.
- :class:`ContinuousProfiler`: the always-on mode.  Short sample bursts
  (~50 ms) every couple of seconds, with the inter-burst interval backing
  off while the process's stacks stay static, keep the duty cycle (and
  therefore the overhead) in the 0.1% range.  Folded stacks are
  time-bucketed and batch-shipped over the control connection to the
  head's :class:`~ray_tpu_torch.util.profile_store.ProfileStore`, so every
  process in the cluster has a queryable flamegraph history by default.

Both sample ``sys._current_frames()`` on a timer thread, aggregating
``file:function`` call stacks across all threads of the process.  Pure
Python and dependency-free (py-spy is not in the image).
"""

from __future__ import annotations

import collections
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

# absolute frame-walk ceiling: stacks deeper than this are pathological
# (runaway recursion) and sampling them whole would make the sampler the
# hot spot the profile reports
_HARD_DEPTH = 128

# mid-stack truncation marker: deep stacks keep their root-most AND
# leaf-most frames around it, so collapsed output still merges at the
# real roots (main/_loop) instead of at fabricated mid-call roots
TRUNCATION_MARKER = "..."


def fold_frame(frame, max_depth: int) -> str:
    """One thread's stack as a ``|``-joined root→leaf frame string.

    ``max_depth`` bounds the OUTPUT, not the walk: the walk always
    reaches the root (up to ``_HARD_DEPTH``), and an over-deep stack is
    truncated in the MIDDLE — root-most frames kept (they name the call
    tree), leaf-most frames kept (they name the hot spot), a ``...``
    marker between.  Truncating leaf→root (the old behaviour) dropped
    the roots of deep stacks, merging unrelated call trees at whatever
    mid-call frame happened to land at the cut."""
    stack: List[str] = []
    f = frame
    while f is not None and len(stack) < _HARD_DEPTH:
        code = f.f_code
        stack.append(f"{code.co_filename.rsplit('/', 1)[-1]}:{code.co_name}")
        f = f.f_back
    stack.reverse()  # walked leaf→root; folded form reads root→leaf
    if len(stack) > max_depth:
        head = max(1, max_depth // 2)
        tail = max(1, max_depth - head - 1)
        stack = stack[:head] + [TRUNCATION_MARKER] + stack[-tail:]
    return "|".join(stack)


def is_idle_leaf(frame) -> bool:
    """True when the frame is parked in a blocking wait (consuming no
    core) — the sampler-side twin of the store's idle classification."""
    from ray_tpu_torch.util.profile_store import _IDLE_LEAF_FILES, _IDLE_LEAF_FUNCS

    code = frame.f_code
    return (code.co_name in _IDLE_LEAF_FUNCS
            or code.co_filename.rsplit("/", 1)[-1] in _IDLE_LEAF_FILES)


def sample_stacks(exclude: frozenset, max_depth: int,
                  counter: "collections.Counter[str]") -> int:
    """One sampling tick: fold every thread's current stack (except the
    excluded sampler threads) into ``counter``.  Returns the number of
    threads caught OFF a blocking wait — the per-tick core-occupancy
    signal behind the duty-cycle ledger's utilization estimate."""
    busy = 0
    for tid, frame in sys._current_frames().items():
        if tid in exclude:
            continue
        if not is_idle_leaf(frame):
            busy += 1
        counter[fold_frame(frame, max_depth)] += 1
    return busy


class SamplingProfiler:
    def __init__(self, period_s: float = 0.002, max_depth: int = 16):
        self.period_s = period_s
        self.max_depth = max_depth
        self.samples: "collections.Counter[str]" = collections.Counter()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "SamplingProfiler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="sampling-profiler"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None

    def _loop(self) -> None:
        me = frozenset((threading.get_ident(),))
        while not self._stop.wait(self.period_s):
            sample_stacks(me, self.max_depth, self.samples)

    def report(self, top: int = 40) -> List[Dict]:
        total = sum(self.samples.values()) or 1
        return [
            {"stack": stack, "samples": n, "pct": round(100.0 * n / total, 2)}
            for stack, n in self.samples.most_common(top)
        ]

    def report_text(self, top: int = 40) -> str:
        lines = [f"{r['samples']:6d} {r['pct']:5.1f}%  {r['stack']}"
                 for r in self.report(top)]
        return "\n".join(lines)

    def report_collapsed(self) -> str:
        """Folded-stack lines (``frame;frame;frame N``) — the format
        speedscope and Brendan Gregg's flamegraph.pl consume directly."""
        return collapsed_from_report(
            [{"stack": stack, "samples": n}
             for stack, n in self.samples.most_common()])


def collapsed_from_report(report: List[Dict]) -> str:
    """Convert ``report()``-shaped rows (``{stack, samples, ...}`` —
    what workers ship back over the control connection) into
    folded-stack lines.  The single formatting site for the collapsed
    format."""
    return "\n".join(
        f"{r['stack'].replace('|', ';')} {r['samples']}" for r in report)


def profile_for(duration_s: float, period_s: float = 0.002,
                top: int = 40) -> List[Dict]:
    """Blocking one-shot profile of this process."""
    p = SamplingProfiler(period_s=period_s).start()
    time.sleep(duration_s)
    p.stop()
    return p.report(top)


# ---------------------------------------------------------------------------
# always-on continuous mode
# ---------------------------------------------------------------------------

def _env_float(name: str, default: float) -> float:
    import os

    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


def gil_lateness_frac(elapsed_s: float, expected_s: float, own_cpu_s: float,
                      process_cpu_s: float) -> float:
    """The share of a burst's wall this sampler thread waited for the GIL.

    The wall past the ticks' schedule less the sampler's own CPU (its
    sample bodies) is time it sat runnable; only another thread of this
    process running Python can have held it off the GIL, so the wait is
    bounded by the CPU the process's other threads used in the burst.  A
    process that used none (an idle worker on a host whose run queue is
    long) reads 0, where the JAX package's reading (elapsed less the
    schedule, over elapsed) calls its late wake-ups GIL wait."""
    late = max(0.0, elapsed_s - expected_s - own_cpu_s)
    others = max(0.0, process_cpu_s - own_cpu_s)
    return max(0.0, min(1.0, min(late, others) / max(elapsed_s, 1e-9)))


def continuous_enabled() -> bool:
    """Continuous profiling is ON by default; RAY_TPU_TORCH_CONT_PROFILE=0
    disables it cluster-wide (the env is inherited by spawned workers)."""
    import os

    return os.environ.get("RAY_TPU_TORCH_CONT_PROFILE", "1") not in (
        "0", "false", "no")


_current: Optional["ContinuousProfiler"] = None


def current() -> Optional["ContinuousProfiler"]:
    """The continuous profiler this process started last (stopped or not),
    so a caller in the process can pause and resume it."""
    return _current


class ContinuousProfiler:
    """Low-duty-cycle burst sampler with adaptive backoff.

    Every ``interval_s`` it samples for ``burst_s`` at ``period_s``
    (default duty cycle 50ms / 2s = 2.5%, at a 5 ms period — ~0.05% CPU
    given the per-tick cost is ~20-40 us).  When consecutive bursts see
    an identical stack fingerprint (an idle process parked on the same
    waits), the interval doubles up to ``max_interval_s``; any change
    snaps it back — a process that starts working is re-sampled at full
    cadence within one backed-off interval.

    Samples fold into per-``bucket_s`` time buckets; ``ship()`` (called
    from the burst loop every ``ship_every_s``) drains finished buckets
    to ``send_fn`` as a ``profile_report`` control frame, or hands them
    to ``ingest_fn`` directly (the head profiles itself without a
    loopback connection).

    The sampler doubles as the process's GIL-pressure probe: each burst
    compares the wall time its ticks actually took against the schedule
    they asked for.  Tick lateness beyond the timer period and the
    sampler's own CPU means this thread sat runnable-but-unscheduled — GIL
    wait as far as the process's other threads used CPU meanwhile
    (:func:`gil_lateness_frac`), the host's run queue past that — and the
    published ``ray_tpu_gil_lateness_frac`` gauge is the "core-bound"
    number the doctor's ``gil_saturation`` rule reads.
    """

    def __init__(self, origin: str,
                 send_fn: Optional[Callable[[dict], None]] = None,
                 ingest_fn: Optional[Callable] = None, *,
                 burst_s: float = 0.05, interval_s: float = 2.0,
                 period_s: float = 0.005, max_depth: int = 24,
                 bucket_s: float = 60.0, ship_every_s: Optional[float] = None,
                 max_interval_s: Optional[float] = None,
                 closed_fn: Optional[Callable[[], bool]] = None):
        self.origin = origin
        self._send = send_fn
        self._ingest = ingest_fn
        self.burst_s = burst_s
        self.interval_s = _env_float("RAY_TPU_TORCH_CONT_PROFILE_INTERVAL_S",
                                     interval_s)
        self.period_s = period_s
        self.max_depth = max_depth
        self.bucket_s = bucket_s
        if ship_every_s is None:
            from ray_tpu_torch.util.metrics import push_interval_s

            ship_every_s = push_interval_s()
        self.ship_every_s = ship_every_s
        self.max_interval_s = (max_interval_s if max_interval_s is not None
                               else 8 * self.interval_s)
        self._closed = closed_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # bucket start ts -> Counter[folded stack]
        self._buckets: Dict[float, "collections.Counter[str]"] = {}
        # bucket start ts -> [ticks, busy_ticks]: the per-bucket duty
        # denominators the ledger divides by (a tick is "busy" when at
        # least one thread was caught off a blocking wait — process
        # core-occupancy, immune to GIL-inflated thread counts)
        self._bucket_ticks: Dict[float, List[float]] = {}
        self._ticks = 0          # sampling ticks taken (duty accounting)
        self._cur_interval = self.interval_s
        self._last_fingerprint: Optional[frozenset] = None
        self._static_bursts = 0
        self._last_ship = 0.0
        self._ship_failures = 0
        self.lateness_frac = 0.0  # last burst's GIL-pressure estimate

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ContinuousProfiler":
        global _current
        if self._thread is not None:
            return self
        _current = self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="cont-profiler")
        self._thread.start()
        # the lock-timing metronome runs where its gauges are published
        from ray_tpu_torch._private import events, locks

        locks._ensure_metronome()

        events.emit("profile", "continuous profiler started",
                    severity="DEBUG", entity_id=self.origin,
                    burst_s=self.burst_s, interval_s=self.interval_s,
                    period_s=self.period_s)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self.ship(final=True)
        from ray_tpu_torch._private import events

        events.emit("profile", "continuous profiler stopped",
                    severity="DEBUG", entity_id=self.origin)

    # -- sampling ----------------------------------------------------------
    def _burst(self) -> None:
        """One sampling burst; also refreshes the GIL-lateness estimate."""
        exclude = frozenset((threading.get_ident(),))
        counter: "collections.Counter[str]" = collections.Counter()
        t0 = time.perf_counter()
        deadline = t0 + self.burst_s
        ticks = 0
        busy_ticks = 0
        cpu0, own0 = time.process_time(), time.thread_time()
        while time.perf_counter() < deadline and not self._stop.is_set():
            if sample_stacks(exclude, self.max_depth, counter):
                busy_ticks += 1
            ticks += 1
            self._stop.wait(self.period_s)
        elapsed = time.perf_counter() - t0
        if ticks:
            self.lateness_frac = gil_lateness_frac(
                elapsed, ticks * self.period_s, time.thread_time() - own0,
                time.process_time() - cpu0)
        if not counter:
            return
        bucket = (time.time() // self.bucket_s) * self.bucket_s
        with self._lock:
            cur = self._buckets.setdefault(bucket, collections.Counter())
            cur.update(counter)
            bt = self._bucket_ticks.setdefault(bucket, [0.0, 0.0])
            bt[0] += ticks
            bt[1] += busy_ticks
            self._ticks += ticks
        self._adapt(counter)
        self._publish_gauges()

    def _adapt(self, counter) -> None:
        """Interval backoff: static stacks across bursts double the
        interval (idle process); any change resets it."""
        fp = frozenset(counter)
        if fp == self._last_fingerprint:
            self._static_bursts += 1
            if (self._static_bursts >= 2
                    and self._cur_interval < self.max_interval_s):
                self._cur_interval = min(self.max_interval_s,
                                         self._cur_interval * 2)
                from ray_tpu_torch._private import events

                events.emit("profile", "profiler backoff",
                            severity="DEBUG", entity_id=self.origin,
                            interval_s=self._cur_interval)
        else:
            if self._cur_interval != self.interval_s:
                from ray_tpu_torch._private import events

                events.emit("profile", "profiler backoff reset",
                            severity="DEBUG", entity_id=self.origin)
            self._cur_interval = self.interval_s
            self._static_bursts = 0
        self._last_fingerprint = fp

    def _publish_gauges(self) -> None:
        from ray_tpu_torch.util.metrics import Gauge

        Gauge("ray_tpu_gil_lateness_frac",
              "fraction of the profiler burst wall spent waiting for the "
              "GIL/scheduler (off-GIL pressure estimate)").set(
            round(self.lateness_frac, 4))
        # duty cycle: what share of wall the profiler spends sampling at
        # its CURRENT (backed-off) interval — the overhead meter the
        # grafana profiling row charts
        Gauge("ray_tpu_profiler_duty_frac",
              "profiler sampling duty cycle (burst wall / interval)").set(
            round(self.burst_s / max(self._cur_interval, 1e-9), 5))
        # named-lock wait/hold gauges ride the same publish tick so the
        # lock-timing plane needs no thread of its own
        from ray_tpu_torch._private import locks

        locks.publish_lock_metrics()

    def _loop(self) -> None:
        while not self._stop.wait(self._cur_interval):
            if self._closed is not None and self._closed():
                return
            try:
                self._burst()
                now = time.monotonic()
                if now - self._last_ship >= self.ship_every_s:
                    self._last_ship = now
                    self.ship()
            except Exception:
                # the profiler must never take its host process down
                pass

    # -- shipping ----------------------------------------------------------
    def drain(self) -> tuple:
        """Take the accumulated buckets + duty meta (resets the rings)."""
        with self._lock:
            buckets_map, self._buckets = self._buckets, {}
            ticks_map, self._bucket_ticks = self._bucket_ticks, {}
            ticks, self._ticks = self._ticks, 0
        buckets = [
            {"ts": ts, "folded": dict(c),
             "ticks": ticks_map.get(ts, [0.0, 0.0])[0],
             "busy_ticks": ticks_map.get(ts, [0.0, 0.0])[1]}
            for ts, c in sorted(buckets_map.items())]
        meta = {"period_s": self.period_s, "burst_s": self.burst_s,
                "interval_s": self._cur_interval, "ticks": ticks,
                "lateness_frac": round(self.lateness_frac, 4)}
        return buckets, meta

    def ship(self, final: bool = False) -> None:
        """Drain buckets to the head (send_fn) or straight into a local
        ProfileStore (ingest_fn).  A failed send drops this batch — the
        next burst re-fills; profiles are advisory, never worth a
        backlog on the control connection."""
        buckets, meta = self.drain()
        if not buckets:
            return
        try:
            if self._ingest is not None:
                self._ingest(self.origin, buckets, meta)
            elif self._send is not None:
                self._send({"type": "profile_report", "origin": self.origin,
                            "buckets": buckets, "meta": meta})
        except Exception:
            self._ship_failures += 1
            if not final:
                from ray_tpu_torch._private import events

                events.emit("profile", "profile ship failed",
                            severity="DEBUG", entity_id=self.origin,
                            failures=self._ship_failures)
