"""Distributed FIFO queue backed by a named actor.

Role of the reference's ``python/ray/util/queue.py`` (``Queue`` over a
``_QueueActor``): a process-crossing queue any task/actor can put to and
get from, with maxsize back-pressure and batch operations.  The actor here
serves blocking gets without busy-waiting by parking callers on the
threaded-actor executor (``max_concurrency``), which round 2's async actor
work made safe.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    """Raised by non-blocking/timeout get on an empty queue."""


class Full(Exception):
    """Raised by non-blocking/timeout put on a full queue."""


@ray_tpu_torch.remote
class _QueueActor:
    def __init__(self, maxsize: int):
        import collections
        import threading

        self._maxsize = maxsize
        self._q = collections.deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)

    def qsize(self) -> int:
        with self._lock:
            return len(self._q)

    def put(self, item, block: bool, timeout: Optional[float]) -> bool:
        with self._not_full:
            if self._maxsize > 0:
                if not block and len(self._q) >= self._maxsize:
                    return False
                deadline = None if timeout is None else time.monotonic() + timeout
                while len(self._q) >= self._maxsize:
                    remaining = None if deadline is None else deadline - time.monotonic()
                    if remaining is not None and remaining <= 0:
                        return False
                    self._not_full.wait(remaining)
            self._q.append(item)
            self._not_empty.notify()
            return True

    def put_batch(self, items: List[Any]) -> bool:
        with self._not_empty:
            if self._maxsize > 0 and len(self._q) + len(items) > self._maxsize:
                return False
            self._q.extend(items)
            self._not_empty.notify_all()
            return True

    def get(self, block: bool, timeout: Optional[float]):
        with self._not_empty:
            if not block and not self._q:
                return False, None
            deadline = None if timeout is None else time.monotonic() + timeout
            while not self._q:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False, None
                self._not_empty.wait(remaining)
            item = self._q.popleft()
            self._not_full.notify()
            return True, item

    def get_batch(self, max_items: int):
        with self._lock:
            n = min(max_items, len(self._q))
            out = [self._q.popleft() for _ in range(n)]
            if n:
                self._not_full.notify_all()
            return out


class Queue:
    """Client handle; picklable, shareable across tasks and actors."""

    def __init__(self, maxsize: int = 0, *, actor_options: Optional[dict] = None,
                 _actor=None):
        if _actor is not None:
            self._actor = _actor
            return
        opts = dict(actor_options or {})
        # blocking put/get park a thread inside the actor until satisfied —
        # concurrency must exceed any realistic number of simultaneously
        # blocked callers or the queue deadlocks (reference uses an asyncio
        # actor with unbounded concurrency)
        opts.setdefault("max_concurrency", 1000)
        self._actor = _QueueActor.options(**opts).remote(maxsize)

    def __reduce__(self):
        return (_rebuild_queue, (self._actor,))

    def qsize(self) -> int:
        return ray_tpu_torch.get(self._actor.qsize.remote())

    def empty(self) -> bool:
        return self.qsize() == 0

    def put(self, item: Any, block: bool = True, timeout: Optional[float] = None) -> None:
        ok = ray_tpu_torch.get(self._actor.put.remote(item, block, timeout))
        if not ok:
            raise Full("queue full")

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def put_nowait_batch(self, items: List[Any]) -> None:
        if not ray_tpu_torch.get(self._actor.put_batch.remote(list(items))):
            raise Full("batch does not fit in queue")

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        ok, item = ray_tpu_torch.get(self._actor.get.remote(block, timeout))
        if not ok:
            raise Empty("queue empty")
        return item

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def get_nowait_batch(self, max_items: int) -> List[Any]:
        return ray_tpu_torch.get(self._actor.get_batch.remote(max_items))

    def shutdown(self) -> None:
        ray_tpu_torch.kill(self._actor)


def _rebuild_queue(actor):
    return Queue(_actor=actor)
