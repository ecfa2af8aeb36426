"""Named locks with wait/hold attribution (the port's copy of
``ray_tpu/_private/locks.py``).

``make_lock("node.registry")`` returns a :class:`_TimedLock` — a thin
proxy whose common path is a bare delegation to the C lock (one slot
load + one branch).  Timing runs on a DUTY CYCLE: a module metronome
arms every proxy for ``_ARM_BURST_S`` out of every ``_ARM_INTERVAL_S``
(~2.4% duty), and only armed acquires pay the non-blocking probe +
``perf_counter`` pairs that time a contended wait and every hold.  A
wait or a hold counts only the part of it that lies in the armed window
it began in, and :func:`lock_stats` scales those raw aggregates by the
measured wall/armed ratio, so the rows estimate the process-wide armed
share of waiting and holding — the metronome's phase is uncorrelated
with lock traffic, which is what makes sampled-window totals
extrapolate.  Both sides are the lock's own: a window opens on the
locks already held, whose holds count from its open, and a wait ends
at the release it waited for, not when the waiter next gets the GIL.
(The JAX package counts a wait whole, however long after its window it
ends and whatever the GIL adds, and times holds only behind contended
acquires: a few long waits that began in 50 ms windows, scaled ~40x,
read as a convoy behind a millisecond of hold.)

The head's dispatch path acquires these locks ~14x per task, so the
DISARMED path cost is what the 1%-of-throughput budget for the whole
profiling plane is spent on; that is why ``__enter__``/``__exit__`` are
hand-leaned (zero-arg C acquire, no ``*exc`` tuple, no nested Python
call) rather than aliases of ``acquire``/``release``.

Aggregates live in a module registry (:func:`lock_stats`) and are
published as per-lock gauges by the continuous profiler's ship tick, so
a hot lock's wait/hold ratio is a TSDB trend the doctor's
``lock_contention`` rule can read — measured wait time, not a guess,
behind "transport" and "core-bound" labels.  The metronome is started by
that profiler (:func:`_ensure_metronome`), not by ``make_lock``: a
process that runs no profiler publishes no lock gauges, and importing a
module that makes a lock at import time starts no thread.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from typing import Dict, Optional

# Locks acquired many times per TASK (not per control message) sit under
# the 1%-of-throughput overhead budget for the whole profiling plane;
# the metrics-registry lock guards nanosecond-scale dict writes under
# every Counter.inc/Gauge.set and can never reveal a dispatch stall —
# timing it costs more than its signal is worth.
_UNTIMED = frozenset(("metrics.registry",))

# Duty cycle of the timing window.  50ms every 2s keeps the armed
# fraction at ~2.4% — the probe+perf_counter cost only ever applies to
# that slice, and the wall/armed scale in lock_stats() undoes the
# sampling.
_ARM_BURST_S = 0.05
_ARM_INTERVAL_S = 2.0

# name -> aggregate timing row.  Plain dict guarded by a RAW lock (the
# stats lock itself must never be a timed lock).
_stats_lock = threading.Lock()
_stats: Dict[str, dict] = {}

# Every live default-mode proxy, so the metronome can flip their _armed
# flag without the proxies polling a clock on the hot path.
_instances: "weakref.WeakSet[_TimedLock]" = weakref.WeakSet()

_armed_total_s = 0.0           # completed armed time this epoch
_armed_since: Optional[float] = None  # perf_counter of the open armed window
_win_seq = 0                   # number of the open (or last) armed window
_win_closed: Dict[int, float] = {}    # window number -> perf_counter at close
_WIN_KEEP = 64                 # closed windows remembered for clipping
_timing_t0: Optional[float] = None    # epoch start (metronome start / reset)
_manual_armed: Optional[bool] = None  # arm_timing() pin; None = metronome
_metronome: Optional[threading.Thread] = None
_metronome_pid: Optional[int] = None


def _stat_row(name: str) -> dict:
    with _stats_lock:
        row = _stats.get(name)
        if row is None:
            row = _stats[name] = {
                "acquires": 0, "contended": 0,
                "wait_s": 0.0, "hold_s": 0.0,
                "max_wait_s": 0.0, "max_hold_s": 0.0,
            }
        return row


def _arm(on: bool) -> None:
    global _armed_since, _armed_total_s, _win_seq
    now = time.perf_counter()
    with _stats_lock:
        if on and _armed_since is None:
            _armed_since = now
            _win_seq += 1
        elif not on and _armed_since is not None:
            _armed_total_s += now - _armed_since
            _armed_since = None
            _win_closed[_win_seq] = now
            _win_closed.pop(_win_seq - _WIN_KEEP, None)
        proxies = list(_instances)
        seq = _win_seq
    for lk in proxies:
        lk._armed = on
    if on:
        for lk in proxies:
            lk._mark_open_hold(seq, now)


def arm_timing(on: Optional[bool]) -> None:
    """Pin the timing window open (``True``) or shut (``False``) — the
    metronome leaves a pinned state alone, so a test can hold timing on
    while it hammers a lock.  ``None`` disarms and hands control back to
    the metronome."""
    global _manual_armed
    _manual_armed = None if on is None else bool(on)
    _arm(bool(on) if on is not None else False)


def _in_window(seq: int, t0: float, t1: float) -> float:
    """The part of ``[t0, t1]`` that lies in armed window ``seq``, the
    one it began in: all of it while that window is open, else up to its
    close (a window closed too long ago to be remembered ends one burst
    after ``t0``)."""
    if seq == _win_seq and _armed_since is not None:
        return t1 - t0
    end = _win_closed.get(seq, t0 + _ARM_BURST_S)
    return max(0.0, min(t1, end) - t0)


def timing_scale() -> float:
    """wall-time / armed-time since the epoch began — the factor that
    turns armed-window raw aggregates into process-wide estimates."""
    with _stats_lock:
        armed = _armed_total_s
        if _armed_since is not None:
            armed += time.perf_counter() - _armed_since
        t0 = _timing_t0
    if t0 is None or armed <= 0.0:
        return 1.0
    return max(1.0, (time.perf_counter() - t0) / armed)


# The metronome waits on an event that is never set, not in time.sleep:
# the sampling profiler sees only Python frames, and a thread parked in
# time.sleep shows this module's loop as its leaf, which the profile
# store files as busy lock_wait; Event.wait's leaf reads as idle.
_METRONOME_PAUSE = threading.Event()


def _metronome_loop(pid: int) -> None:
    while pid == os.getpid():
        _METRONOME_PAUSE.wait(_ARM_INTERVAL_S)
        if _manual_armed is None:
            _arm(True)
        _METRONOME_PAUSE.wait(_ARM_BURST_S)
        if _manual_armed is None:
            _arm(False)


def _ensure_metronome() -> None:
    """Start (or restart after fork — forked children inherit the module
    state but not the thread) the arming metronome.  Called when a
    continuous profiler starts, never on a hot path."""
    global _metronome, _metronome_pid, _timing_t0
    global _armed_total_s, _armed_since
    pid = os.getpid()
    with _stats_lock:
        if (_metronome is not None and _metronome_pid == pid
                and _metronome.is_alive()):
            return
        if _timing_t0 is None or _metronome_pid != pid:
            # fresh epoch: a forked child must not inherit the parent's
            # armed-time accounting, it never observed those windows
            _timing_t0 = time.perf_counter()
            _armed_total_s = 0.0
            _armed_since = None
        _metronome_pid = pid
        _metronome = threading.Thread(
            target=_metronome_loop, args=(pid,), daemon=True,
            name="ray_tpu_torch-lock-metronome")
        _metronome.start()


def lock_stats() -> Dict[str, dict]:
    """Aggregate wait/hold rows per named lock since process start.

    The rows are duty-cycle ESTIMATES: raw armed-window aggregates scaled
    by the measured wall/armed ratio (``max_*`` stay raw and whole — an
    observed extreme is a fact, not a rate)."""
    scale = timing_scale()
    with _stats_lock:
        rows = {name: dict(row) for name, row in _stats.items()}
    if scale != 1.0:
        for row in rows.values():
            row["acquires"] = int(row["acquires"] * scale)
            row["contended"] = int(row["contended"] * scale)
            row["wait_s"] *= scale
            row["hold_s"] *= scale
    return rows


def reset_lock_stats() -> None:
    """Clear the rows AND restart the scaling epoch, so post-reset rows
    estimate post-reset traffic only (proxies created before the reset
    keep their orphaned rows — create locks after resetting)."""
    global _armed_total_s, _armed_since, _timing_t0
    with _stats_lock:
        _stats.clear()
        now = time.perf_counter()
        _timing_t0 = now
        _armed_total_s = 0.0
        if _armed_since is not None:
            _armed_since = now


def publish_lock_metrics() -> None:
    """Fold the aggregates into per-lock gauges (rides the continuous
    profiler's publish tick; workers' copies reach the head — and the
    TSDB — over the ordinary metrics_report path)."""
    rows = lock_stats()
    if not rows:
        return
    from ray_tpu_torch.util.metrics import Gauge

    wait = Gauge("ray_tpu_lock_wait_s",
                 "cumulative measured wait on a named lock")
    hold = Gauge("ray_tpu_lock_hold_s",
                 "cumulative measured hold of a named lock")
    contended = Gauge("ray_tpu_lock_contended_total",
                      "contended acquires of a named lock")
    for name, row in rows.items():
        tags = {"lock": name}
        wait.set(round(row["wait_s"], 6), tags=tags)
        hold.set(round(row["hold_s"], 6), tags=tags)
        contended.set(row["contended"], tags=tags)


class _TimedLock:
    """Duty-cycled wait/hold timing proxy.  Disarmed (the ~97.6%
    common case): ``__enter__`` is one slot load, one branch, and a
    ZERO-arg call into the C acquire; ``__exit__`` takes the exc triple
    positionally (no tuple packing) and calls the bound C release
    directly.  Armed: a ``perf_counter`` and a non-blocking probe, a
    second ``perf_counter`` after the blocking acquire when the lock
    turns out contended, and the hold timed to its release — each clipped
    to the armed window it began in."""

    __slots__ = ("_inner", "_inner_acquire", "_inner_release", "_row",
                 "_t0", "_win", "_armed", "_rel", "__weakref__")

    def __init__(self, lock, name: str):
        self._inner = lock
        self._inner_acquire = lock.acquire
        self._inner_release = lock.release
        self._row = _stat_row(name)
        self._t0 = None  # hold-start of the acquire being timed
        self._win = 0  # the armed window that hold began in
        self._armed = False
        self._rel = None  # perf_counter of the last timed hold's release
        with _stats_lock:
            _instances.add(self)

    def __enter__(self):
        if self._armed:
            return self._timed_acquire(True, -1)
        return self._inner_acquire()

    def __exit__(self, t, v, tb):
        if self._t0 is not None:
            self._finish_hold()
        self._inner_release()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._armed:
            return self._timed_acquire(blocking, timeout)
        return self._inner_acquire(blocking, timeout)

    def release(self) -> None:
        if self._t0 is not None:
            self._finish_hold()
        self._inner_release()

    def _timed_acquire(self, blocking: bool, timeout: float) -> bool:
        row = self._row
        row["acquires"] += 1
        seq = _win_seq
        t1 = time.perf_counter()
        if not self._inner_acquire(False):
            if not blocking:
                return False
            t0 = t1
            got = self._inner_acquire(True, timeout)
            t1 = time.perf_counter()
            if not got:
                return False
            # the wait ends at the release that let this thread in; the
            # time it then spent getting the GIL back is not the lock's
            rel = self._rel
            end = rel if rel is not None and t0 <= rel <= t1 else t1
            wait = end - t0
            row["contended"] += 1
            row["wait_s"] += _in_window(seq, t0, end)
            if wait > row["max_wait_s"]:
                row["max_wait_s"] = wait
        if self._t0 is None:  # outermost timed acquire (RLock reentry)
            self._t0, self._win = t1, seq
        return True

    def _finish_hold(self) -> None:
        t0 = self._t0
        if t0 is None:
            return
        self._t0 = None
        t1 = time.perf_counter()
        self._rel = t1
        held = t1 - t0
        row = self._row
        row["hold_s"] += _in_window(self._win, t0, t1)
        if held > row["max_hold_s"]:
            row["max_hold_s"] = held

    def _mark_open_hold(self, seq: int, t: float) -> None:
        """At window ``seq``'s open (``t``): a hold taken before it, while
        timing was off, is timed from ``t`` on, so the waits behind it in
        the window have a hold to be read against.  ``_t0`` is set before
        the probe: a holder that releases in between finishes the hold
        from ``t``; a free lock is taken and given back at once (an
        RLock this thread holds counts as held)."""
        if self._t0 is not None:
            return
        self._t0, self._win = t, seq
        owned = getattr(self._inner, "_is_owned", None)
        if owned is not None and owned():
            return
        if self._inner_acquire(False):
            self._t0 = None
            self._inner_release()

    def locked(self) -> bool:
        # parity with threading.Lock.locked (RLocks lack it; mirror that)
        if self._inner_acquire(False):
            self._inner_release()
            return False
        return True

    # --- threading.Condition protocol -----------------------------------
    # Condition(make_lock(..., rlock=True)) must see the C RLock's owner
    # tracking; its nonblocking-probe fallback reads a held REENTRANT
    # lock as "not owned" and cond.wait() then refuses to wait.  The
    # cond-wait release/reacquire pair is deliberately untimed: the gap
    # is dominated by waiting for the notify, not by lock contention.

    def _is_owned(self):
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def _release_save(self):
        if self._t0 is not None:
            self._finish_hold()
        inner = self._inner
        if hasattr(inner, "_release_save"):
            return inner._release_save()
        inner.release()
        return None

    def _acquire_restore(self, state):
        inner = self._inner
        if hasattr(inner, "_acquire_restore"):
            inner._acquire_restore(state)
        else:
            inner.acquire()


def make_lock(name: str, *, rlock: bool = False):
    """A named Lock/RLock behind the duty-cycled timing proxy (see the
    module docstring); the locks in ``_UNTIMED`` come back bare.

    With ``RAY_TPU_TORCH_LOCKWITNESS`` set, every named lock (the
    ``_UNTIMED`` ones too) is instead a raylint ``WitnessLock`` over the
    bare lock, and goes untimed: the witness replaces the timing, as in
    the JAX package.  The timing's window bookkeeping (``_mark_open_hold``,
    the ``_rel`` stamps) would otherwise run inside the witnessed
    acquires, and a witnessed run is read for lock order, never for
    wait/hold.  The flag is read per call, so it must be in the
    environment before the first import for module-level locks (the
    metrics registry, ``object_store``'s attached and arena-map locks)."""
    lock = threading.RLock() if rlock else threading.Lock()
    if os.environ.get("RAY_TPU_TORCH_LOCKWITNESS"):
        from ray_tpu_torch.devtools.raylint.lockwitness import wrap_lock

        return wrap_lock(name, lock)
    if name in _UNTIMED:
        return lock
    return _TimedLock(lock, name)
