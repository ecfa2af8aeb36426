"""Actor pool: fan work out over a fixed set of actors.

Role of the reference's ``python/ray/util/actor_pool.py`` (``ActorPool``):
a driver-side load balancer that keeps every actor busy, yields results as
they complete (ordered or unordered), and lets actors be pushed/popped at
runtime.  Re-designed around ``ray_tpu_torch.wait`` — no polling.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, TYPE_CHECKING

import ray_tpu_torch

if TYPE_CHECKING:
    from ray_tpu_torch.actor import ActorHandle


class ActorPool:
    """Schedule tasks over a pool of actor handles.

    Example::

        pool = ActorPool([Worker.remote() for _ in range(4)])
        for out in pool.map(lambda a, x: a.double.remote(x), range(100)):
            ...
    """

    def __init__(self, actors: Iterable["ActorHandle"]):
        self._idle: List["ActorHandle"] = list(actors)
        # in-flight: ObjectRef -> (actor, submission index)
        self._inflight: dict = {}
        self._next_submit_idx = 0
        self._next_yield_idx = 0
        # completed-but-not-yet-yielded results for ordered iteration
        self._done: dict = {}

    # -- submission ------------------------------------------------------

    def submit(self, fn: Callable[["ActorHandle", Any], Any], value: Any) -> None:
        """Apply ``fn(actor, value)`` on an idle actor; blocks until one frees."""
        if not self._idle:
            self._wait_one()
        actor = self._idle.pop()
        ref = fn(actor, value)
        self._inflight[ref] = (actor, self._next_submit_idx)
        self._next_submit_idx += 1

    def has_next(self) -> bool:
        return bool(self._inflight) or bool(self._done)

    def has_free(self) -> bool:
        return bool(self._idle)

    def get_next(self, timeout: float = None) -> Any:
        """Next result in submission order."""
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        idx = self._next_yield_idx
        while idx not in self._done:
            if not self._inflight:
                raise StopIteration("no pending results")
            remaining = None if deadline is None else max(0.0, deadline - _time.monotonic())
            self._wait_one(timeout=remaining)
        self._next_yield_idx += 1
        return self._done.pop(idx)

    def get_next_unordered(self, timeout: float = None) -> Any:
        """Next result to complete, regardless of submission order."""
        if self._done:
            idx = next(iter(self._done))
            return self._done.pop(idx)
        if not self._inflight:
            raise StopIteration("no pending results")
        self._wait_one(timeout=timeout)
        idx = next(iter(self._done))
        return self._done.pop(idx)

    # -- iteration -------------------------------------------------------

    def map(self, fn: Callable, values: Iterable[Any]) -> Iterator[Any]:
        """Ordered map; keeps all actors busy, yields in input order."""
        for v in values:
            if not self._idle:
                yield self.get_next()
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[Any]) -> Iterator[Any]:
        """Unordered map; lower latency to first result."""
        for v in values:
            if not self._idle:
                yield self.get_next_unordered()
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # -- pool membership -------------------------------------------------

    def push(self, actor: "ActorHandle") -> None:
        """Add an idle actor to the pool."""
        self._idle.append(actor)

    def pop_idle(self) -> "ActorHandle":
        """Remove and return an idle actor (raises if none idle)."""
        if not self._idle:
            raise ValueError("no idle actor to pop")
        return self._idle.pop()

    # -- internals -------------------------------------------------------

    def _wait_one(self, timeout: float = None) -> None:
        refs = list(self._inflight)
        ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("ActorPool.get_next timed out")
        ref = ready[0]
        actor, idx = self._inflight.pop(ref)
        self._idle.append(actor)
        self._done[idx] = ray_tpu_torch.get(ref)
