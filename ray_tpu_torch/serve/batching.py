"""@serve.batch — transparent request batching inside a replica.

Analog of the reference's ``python/ray/serve/batching.py``: concurrent
calls to the decorated method are collected into one list and executed by
a single underlying call; each caller gets its own element back.  On a GPU
this is the difference between N single-row model invocations and one
batched forward that fills the tensor cores.

Replicas whose callable uses ``@serve.batch`` are created with
``max_concurrency = max_concurrent_queries`` (the controller detects the
decorator), so requests arrive on concurrent executor threads.  A
dedicated batcher thread per decorated callable collects them: callers
enqueue and park; the batcher waits up to ``batch_wait_timeout_s`` from
the first queued item (returning early at ``max_batch_size``), runs the
wrapped function once on the list, and distributes results.  With the
default ``max_concurrent_batches=1`` all user code runs on the single
batcher thread, so deployment state needs no locking; raising it runs up
to K batches on concurrent executor threads — the decorated function
must then be thread-safe (pure jit-apply functions are).
"""

from __future__ import annotations

import functools
import inspect
import threading
import time
from typing import Callable, List, Optional

BATCH_ATTR = "_ray_tpu_serve_batch"


class _Slot:
    __slots__ = ("item", "event", "result", "error", "enqueued_at")

    def __init__(self, item):
        self.item = item
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.enqueued_at = time.monotonic()


class _Batcher:
    """One collector thread per decorated callable (replica-side only —
    never pickled; built lazily on first call).

    ``max_concurrent_batches > 1`` lets the collector hand batch N+1 to a
    worker thread while batch N is still executing.  Where the host's
    share of a batch (padding, launches, the result's read-back) is
    comparable to the device's, overlapping batches lets one batch's host
    work run beside another's kernels — the device serializes the actual
    compute either way."""

    def __init__(self, run_fn: Callable[[List], List], max_batch_size: int,
                 timeout_s: float, max_concurrent_batches: int = 1):
        self._run_fn = run_fn
        self._max = max_batch_size
        self._timeout = timeout_s
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._queue: List[_Slot] = []
        self._thread_started = False
        self._inflight_sem = threading.Semaphore(max(1, max_concurrent_batches))
        # K>1: daemon executor threads over a queue (not ThreadPoolExecutor,
        # whose non-daemon threads would leak per deploy and whose atexit
        # join wedges worker shutdown if a batch ever hangs)
        self._exec_queue = None
        self._n_exec_threads = max(1, max_concurrent_batches)

    def submit(self, item):
        slot = _Slot(item)
        with self._nonempty:
            if not self._thread_started:
                # lazily here, not in __init__: racing first callers may
                # each construct a _Batcher and only setdefault's winner
                # survives — an eagerly-started loser thread would park on
                # its empty queue forever
                self._thread_started = True
                threading.Thread(
                    target=self._loop, daemon=True, name="serve-batcher"
                ).start()
            self._queue.append(slot)
            self._nonempty.notify()
        slot.event.wait()
        if slot.error is not None:
            raise slot.error
        return slot.result

    def _loop(self) -> None:
        while True:
            with self._nonempty:
                while not self._queue:
                    self._nonempty.wait()
                # the batch window opens when the OLDEST item was enqueued
                # (items that aged while the previous batch executed don't
                # pay a fresh full wait); predicate loop guards against
                # spurious wakeups forming tiny batches
                deadline = self._queue[0].enqueued_at + self._timeout
                while len(self._queue) < self._max:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._nonempty.wait(remaining)
                batch = self._queue[: self._max]
                del self._queue[: len(batch)]
            # bounds in-flight batches; with K=1 this serializes execution
            # on this collector thread exactly as before
            self._inflight_sem.acquire()
            if self._n_exec_threads == 1:
                self._execute(batch)
            else:
                if self._exec_queue is None:
                    import queue as queue_mod

                    self._exec_queue = queue_mod.Queue()
                    for i in range(self._n_exec_threads):
                        threading.Thread(
                            target=self._exec_loop, daemon=True,
                            name=f"serve-batch-exec-{i}",
                        ).start()
                self._exec_queue.put(batch)

    def _exec_loop(self) -> None:
        while True:
            self._execute(self._exec_queue.get())

    def _execute(self, batch: List[_Slot]) -> None:
        try:
            results = self._run_fn([s.item for s in batch])
            if len(results) != len(batch):
                # caught by the BaseException arm on purpose: the error
                # rides s.error to every waiting caller and re-raises there
                # raylint: disable=R2
                raise ValueError(
                    f"@serve.batch function returned {len(results)} "
                    f"results for a batch of {len(batch)}"
                )
            for s, r in zip(batch, results):
                s.result = r
        except BaseException as e:  # noqa: BLE001 — every caller must wake
            for s in batch:
                s.error = e
        finally:
            self._inflight_sem.release()
            for s in batch:
                s.event.set()


def uses_batching(func_or_class) -> bool:
    """True if the deployment callable (class or function) carries any
    @serve.batch-decorated entry point — the controller keys replica
    concurrency on this."""
    if getattr(func_or_class, BATCH_ATTR, False):
        return True
    if isinstance(func_or_class, type):
        # dir() walks the MRO — inherited @serve.batch methods count too
        return any(
            getattr(getattr(func_or_class, name, None), BATCH_ATTR, False)
            for name in dir(func_or_class)
        )
    return False


def batch(_func: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01, max_concurrent_batches: int = 1):
    """Decorate a replica method (or function deployment) taking a LIST of
    requests::

        @serve.deployment(max_concurrent_queries=32)
        class Model:
            @serve.batch(max_batch_size=16, batch_wait_timeout_s=0.005)
            def __call__(self, requests):           # list in ...
                return self.model(np.stack(requests)).tolist()  # list out

    ``max_concurrent_batches=K`` (default 1) overlaps up to K batch
    executions on concurrent threads — use when per-batch latency is
    dominated by host work and read-backs rather than device compute, and
    only if the decorated function is thread-safe.
    """
    if max_batch_size < 1:
        raise ValueError("max_batch_size must be >= 1")

    def deco(fn: Callable):
        # the batcher holds a lock + thread, so it must be created lazily
        # replica-side (cloudpickle ships the decorated def before any call)
        params = list(inspect.signature(fn).parameters)
        is_method = bool(params) and params[0] == "self"
        attr = f"__serve_batcher_{fn.__name__}"

        if is_method:

            @functools.wraps(fn)
            def wrapper(self, request):
                b = self.__dict__.get(attr)
                if b is None:
                    # dict.setdefault is atomic: racing first calls keep one
                    b = self.__dict__.setdefault(
                        attr,
                        _Batcher(lambda items: fn(self, items),
                                 max_batch_size, batch_wait_timeout_s,
                                 max_concurrent_batches),
                    )
                return b.submit(request)
        else:

            @functools.wraps(fn)
            def wrapper(request):
                b = wrapper.__dict__.get(attr)
                if b is None:
                    b = wrapper.__dict__.setdefault(
                        attr,
                        _Batcher(fn, max_batch_size, batch_wait_timeout_s,
                                 max_concurrent_batches),
                    )
                return b.submit(request)

        setattr(wrapper, BATCH_ATTR, True)
        return wrapper

    if _func is not None:
        return deco(_func)
    return deco
