"""The device trace of a steady stretch, read in the process that holds
the card.

``torch.profiler`` records, for the device alone, every operation that
ran on it (its kernels, copies and sets: CUPTI sees the whole process)
and the CUDA runtime calls of every thread.  Host operations are not
recorded: their recording costs a Python-bound step a large share of its
time, which shows as idle device.  From that the stretch gives: the
seconds in which some operation ran (the union of their intervals, so
overlaps count once), its length, the time by kernel name, and the idle
gaps by the runtime call the host was in.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Any, Dict, List, Tuple

import torch

TOP = 10
# the stretch, as a host range on the trace's own clock
MARK = "portbench.stretch"
# idle gaps attributed to a host operation: the longest this many
ATTRIBUTED_GAPS = 4000


class DeviceTrace:
    """``start()``, ``stop()``, then ``summary()``: one stretch, started and
    stopped on one thread.  The summary is worked out apart from ``stop``
    because it holds the interpreter for a while; the caller leaves it
    until its window has closed."""

    def __init__(self):
        self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self._t0 = None

    def start(self) -> None:
        torch.cuda.synchronize()
        self._prof.__enter__()
        self._mark = torch.profiler.record_function(MARK)
        self._mark.__enter__()
        self._lo = time.time_ns()  # the trace's clock is the epoch's

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._hi = time.time_ns()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    def summary(self) -> Dict[str, Any]:
        return summarize(self._prof.profiler.kineto_results.events(), self._lo, self._hi)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(events, lo: int, hi: int) -> Dict[str, Any]:
    """``busy_s``, ``window_s``, ``kernels`` (name -> [count, seconds]),
    and the breakdown: the device operations that took most time and the
    idle seconds by the host operation they fell in.  The stretch is
    ``[lo, hi]`` in epoch nanoseconds, the trace's clock, or the ``MARK``
    range where the trace holds it; the device's intervals are cut to it
    (an operation in flight when the profiler started counts only from the
    stretch's start)."""
    dev, host = [], []
    for e in events:
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation() and e.name() != MARK:  # a host range drawn on the device
                dev.append((start, start + dur, e.name()))
        elif e.name() == MARK:
            lo, hi = start, start + dur
        elif dur > 0:
            host.append((start, start + dur, e.name()))
    window_s = (hi - lo) / 1e9
    whole = [(s, e, n) for s, e, n in dev if s >= lo and e <= hi]
    dev = [(max(s, lo), min(e, hi), n) for s, e, n in dev if e > lo and s < hi]
    kernels: Dict[str, List[float]] = {}  # the launches wholly inside the stretch
    for s, e, name in whole:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) / 1e9
    busy = _union([(s, e) for s, e, _ in dev])
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
                   for i in range(len(busy) - 1)), reverse=True)
    host.sort()
    starts = [s for s, _, _ in host]
    idle_by_host: Dict[str, float] = {}
    for length, s, e in gaps[:ATTRIBUTED_GAPS]:
        mid = (s + e) // 2
        name = "no host operation recorded"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 400, -1), -1):  # the innermost op around mid
            if host[j][1] >= mid:
                name = host[j][2]
                break
        idle_by_host[name] = idle_by_host.get(name, 0.0) + length / 1e9
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "kernels": kernels,
        "device_ops": [[n[:160], k[1]] for n, k in top_ops],
        "idle_gaps": [[n[:160], s] for n, s in
                      sorted(idle_by_host.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def kernel_seconds(summary: Dict[str, Any], needle: str) -> Tuple[int, float]:
    """Launches and device seconds of the kernels whose name holds
    ``needle``."""
    n, s = 0, 0.0
    for name, (count, secs) in summary["kernels"].items():
        if needle in name:
            n += count
            s += secs
    return n, s


class BackgroundTrace:
    """A :class:`DeviceTrace` of ``seconds`` on a thread of its own, for a
    process whose work runs on other threads (a replica).  The profiler
    takes a second or two to start, so the stretch begins once it runs:
    ``start()`` returns at once, ``summary()`` waits for the stretch's end
    and works the summary out."""

    def __init__(self, seconds: float):
        self._trace = DeviceTrace()
        self._seconds = seconds
        self._thread = threading.Thread(target=self._run, daemon=True, name="portbench-trace")

    def _run(self) -> None:
        self._trace.start()
        time.sleep(self._seconds)
        self._trace.stop()

    def start(self) -> None:
        self._thread.start()

    def summary(self) -> Dict[str, Any]:
        self._thread.join()
        return self._trace.summary()
