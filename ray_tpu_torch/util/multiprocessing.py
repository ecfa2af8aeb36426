"""``multiprocessing.Pool`` API over cluster actors.

Reference: ``python/ray/util/multiprocessing/pool.py`` (a drop-in
``Pool`` whose workers are actors, so pool jobs ride the scheduler and
can span nodes).  Covers the surface programs actually use: ``apply``,
``apply_async``, ``map``, ``map_async``, ``starmap``, ``starmap_async``,
``imap``, ``imap_unordered``, ``close``/``terminate``/``join``, context
manager, chunking.

Chunks ship as single actor calls (one control-plane message per chunk,
not per item) and fan out round-robin across the pool's actors.
"""

from __future__ import annotations

import itertools
import threading
import warnings
import weakref
from multiprocessing import TimeoutError  # the Pool-API timeout type
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch

_CHUNK_TARGET = 4  # chunks per worker per map, the stdlib heuristic


@ray_tpu_torch.remote
class _PoolWorker:
    """One pool seat: runs pickled callables over item chunks."""

    def __init__(self, initializer=None, initargs=()):
        if initializer is not None:
            initializer(*initargs)

    def run_chunk(self, func, chunk, star: bool) -> List[Any]:
        if star:
            return [func(*args) for args in chunk]
        return [func(arg) for arg in chunk]

    def run_one(self, func, args, kwargs) -> Any:
        return func(*args, **(kwargs or {}))


class AsyncResult:
    """``multiprocessing.pool.AsyncResult`` semantics over ObjectRefs."""

    def __init__(self, refs: List, combine: Callable[[List[Any]], Any],
                 callback=None, error_callback=None):
        self._refs = refs
        self._combine = combine
        self._value = None
        self._error: Optional[BaseException] = None
        self._done = threading.Event()
        # resolve on a side thread so callbacks fire without the caller
        # blocking (the stdlib's result-handler thread)
        t = threading.Thread(target=self._resolve,
                             args=(callback, error_callback), daemon=True)
        t.start()

    def _resolve(self, callback, error_callback) -> None:
        try:
            self._value = self._combine(ray_tpu_torch.get(self._refs))
        except BaseException as e:  # noqa: BLE001 — surfaced via .get()
            self._error = e
        self._done.set()
        try:
            if self._error is None and callback is not None:
                callback(self._value)
            elif self._error is not None and error_callback is not None:
                error_callback(self._error)
        except Exception:
            pass

    def wait(self, timeout: Optional[float] = None) -> None:
        self._done.wait(timeout)

    def ready(self) -> bool:
        return self._done.is_set()

    def successful(self) -> bool:
        if not self._done.is_set():
            raise ValueError("result is not ready")
        return self._error is None

    def get(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            # multiprocessing.TimeoutError, NOT the builtin: ported code
            # catches the Pool API's exception type
            raise TimeoutError("result not ready")
        if self._error is not None:
            raise self._error
        return self._value


class Pool:
    def __init__(self, processes: Optional[int] = None, initializer=None,
                 initargs: tuple = (), maxtasksperchild: Optional[int] = None,
                 ray_remote_args: Optional[dict] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        if processes is None:
            processes = max(1, int(
                ray_tpu_torch.cluster_resources().get("CPU", 1)))
        if processes < 1:
            raise ValueError(f"processes must be >= 1, got {processes}")
        if maxtasksperchild is not None:
            # actor seats are long-lived by design (no per-N-tasks worker
            # recycling); a silent no-op would hide that from code that
            # relies on recycling to bound leaks
            warnings.warn(
                "ray_tpu_torch.util.multiprocessing.Pool ignores maxtasksperchild:"
                " pool workers are long-lived actors and are not recycled",
                UserWarning, stacklevel=2)
        self._size = processes
        cls = _PoolWorker
        if ray_remote_args:
            cls = cls.options(**ray_remote_args)
        self._actors = [cls.remote(initializer, initargs)
                        for _ in range(processes)]
        self._rr = itertools.count()
        self._closed = False
        # outstanding async results, so join() can actually wait
        self._inflight = weakref.WeakSet()

    # -- plumbing ------------------------------------------------------
    def _actor(self):
        return self._actors[next(self._rr) % self._size]

    def _check_running(self) -> None:
        if self._closed:
            raise ValueError("Pool not running")

    def _chunks(self, iterable: Iterable, chunksize: Optional[int]):
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, len(items) // (self._size * _CHUNK_TARGET) or 1)
        return [items[i:i + chunksize]
                for i in range(0, len(items), chunksize)], chunksize

    def _map_refs(self, func, iterable, chunksize, star: bool):
        chunks, _ = self._chunks(iterable, chunksize)
        return [self._actor().run_chunk.remote(func, c, star)
                for c in chunks]

    @staticmethod
    def _flatten(chunked: List[List[Any]]) -> List[Any]:
        return [x for chunk in chunked for x in chunk]

    # -- the Pool API --------------------------------------------------
    def apply(self, func, args: tuple = (), kwds: Optional[dict] = None):
        return self.apply_async(func, args, kwds).get()

    def apply_async(self, func, args: tuple = (), kwds: Optional[dict] = None,
                    callback=None, error_callback=None) -> AsyncResult:
        self._check_running()
        ref = self._actor().run_one.remote(func, args, kwds)
        r = AsyncResult([ref], lambda vs: vs[0], callback, error_callback)
        self._inflight.add(r)
        return r

    def map(self, func, iterable, chunksize: Optional[int] = None):
        return self.map_async(func, iterable, chunksize).get()

    def map_async(self, func, iterable, chunksize: Optional[int] = None,
                  callback=None, error_callback=None) -> AsyncResult:
        self._check_running()
        refs = self._map_refs(func, iterable, chunksize, star=False)
        r = AsyncResult(refs, self._flatten, callback, error_callback)
        self._inflight.add(r)
        return r

    def starmap(self, func, iterable, chunksize: Optional[int] = None):
        return self.starmap_async(func, iterable, chunksize).get()

    def starmap_async(self, func, iterable, chunksize: Optional[int] = None,
                      callback=None, error_callback=None) -> AsyncResult:
        self._check_running()
        refs = self._map_refs(func, iterable, chunksize, star=True)
        r = AsyncResult(refs, self._flatten, callback, error_callback)
        self._inflight.add(r)
        return r

    def imap(self, func, iterable, chunksize: Optional[int] = None):
        """Ordered lazy iteration; chunks resolve as they complete.
        chunksize defaults to 1 (the stdlib's), so the first item yields
        after ONE call — not after a map()-sized chunk.

        Submission is EAGER, like the stdlib: every chunk is in flight
        when ``imap`` returns — workers compute while the caller is not
        yet (or slowly) iterating.  Only result consumption is lazy."""
        self._check_running()
        refs = self._map_refs(func, iterable, chunksize or 1, star=False)

        def drain_ordered():
            for ref in refs:
                yield from ray_tpu_torch.get(ref)

        return drain_ordered()

    def imap_unordered(self, func, iterable, chunksize: Optional[int] = None):
        self._check_running()
        # eager submission at call time (see imap)
        refs = self._map_refs(func, iterable, chunksize or 1, star=False)

        def drain_completed():
            pending = list(refs)
            while pending:
                ready, rest = ray_tpu_torch.wait(pending, num_returns=1)
                pending = rest
                yield from ray_tpu_torch.get(ready[0])

        return drain_completed()

    # -- lifecycle -----------------------------------------------------
    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        self._actors = []

    def join(self) -> None:
        """Block until all outstanding async work has resolved (the
        stdlib contract: close(); join() means every submitted task
        finished)."""
        if not self._closed:
            raise ValueError("Pool is still running")
        for r in list(self._inflight):
            r.wait()

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc) -> None:
        self.terminate()


__all__ = ["Pool", "AsyncResult"]
