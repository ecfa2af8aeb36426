"""Profiling helpers: device traces and timed scopes.

Counterpart of ``ray_tpu/util/profiling.py``.  :func:`profile_trace`
captures a ``torch.profiler`` trace of the enclosed block (CPU activity,
and the card's kernels when CUDA is present) and exports it as a Chrome
trace, viewable in Perfetto or ``chrome://tracing``.  Spans are
``util/tracing.py``'s (its ``trace`` opens the OpenTelemetry span where
the SDK imports).  :func:`profile_step`
arms a one-step trace on the process's active ``StepProfiler``
(``util/perf.py``), and :class:`timed` records a scope's wall time into
``util/metrics``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Iterator

import torch

# one trace at a time per process: a nested profile scope degrades to a
# no-op instead of failing the step (torch.profiler refuses a second
# concurrent profiler)
_trace_lock = threading.Lock()
_trace_active = False


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``logdir/trace_<pid>.json`` (Chrome trace format)::

        with profiling.profile_trace("/tmp/trace"):
            train_step(...)

    Re-entrant by degrading: when a trace is already running in this
    process the inner scope is a no-op (the outer trace covers it), and a
    profiler that fails to start leaves the block to run untraced."""
    global _trace_active
    with _trace_lock:
        if _trace_active:
            started = False
        else:
            _trace_active = started = True
    if not started:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    try:
        prof.start()
    except Exception:
        # a start failure (another profiler owns the process) must not
        # take the step down with it
        with _trace_lock:
            _trace_active = False
        yield
        return
    try:
        yield
    finally:
        try:
            prof.stop()
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))
        finally:
            with _trace_lock:
                _trace_active = False


def profile_step(logdir: str) -> bool:
    """Arm a ONE-STEP trace on the process's active
    :class:`~ray_tpu_torch.util.perf.StepProfiler`: the next
    ``prof.step()`` scope runs inside :func:`profile_trace` and the trace
    lands under ``logdir``, and the step after it runs untraced.  The
    on-demand hook for device detail of exactly one step without paying
    trace overhead steadily.  Returns whether a profiler was armed (False:
    no active profiler in this process)."""
    from ray_tpu_torch.util import perf as _perf

    prof = _perf.active_profiler()
    if prof is None:
        return False
    prof.arm_trace(logdir)
    return True


class timed:
    """Tiny wall-clock scope, recorded into ``ray_tpu_torch.util.metrics``
    as the histogram ``ray_tpu_torch_timed_<name>_seconds``::

        with profiling.timed("ingest_batch"):
            ...
    """

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from ray_tpu_torch.util.metrics import Histogram

        Histogram(f"ray_tpu_torch_timed_{self.name}_seconds",
                  f"wall time of {self.name} scopes").observe(
            time.perf_counter() - self._t0)
        return False
