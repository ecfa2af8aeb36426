"""Chaos-testing utilities (the port's copy of
``ray_tpu/_private/test_utils.py``).

Analog of the reference's fault-injection helpers — ``NodeKillerActor``
(``python/ray/_private/test_utils.py:1301``, ``_kill_raylet`` ``:1377``)
which SIGKILLs raylets on an interval to drive the chaos suite
(``python/ray/tests/test_chaos.py``).  Here the unit of failure on a
single host is the worker process: the killer SIGKILLs busy workers on an
interval and the runtime's retry/restart machinery must absorb it.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional


class WorkerKiller:
    """SIGKILLs a random busy worker every ``interval_s`` seconds.

    Usage::

        killer = WorkerKiller(interval_s=0.4)
        killer.start()
        ... run workload with retries enabled ...
        killer.stop()
        assert killer.kills > 0
    """

    def __init__(
        self,
        node=None,
        interval_s: float = 0.5,
        include_actor_workers: bool = True,
        seed: Optional[int] = None,
    ):
        if node is None:
            from ray_tpu_torch._private.worker import global_worker

            node = global_worker.node
        self.node = node
        self.interval_s = interval_s
        self.include_actor_workers = include_actor_workers
        self.kills = 0
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _candidates(self):
        with self.node.lock:
            return [
                w
                for w in self.node.workers.values()
                if w.state == "busy"
                and w.proc is not None
                and (self.include_actor_workers or not w.is_actor_worker)
            ]

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            cands = self._candidates()
            if not cands:
                continue
            victim = self._rng.choice(cands)
            try:
                victim.proc.kill()
                self.kills += 1
            except Exception:
                pass

    def start(self) -> "WorkerKiller":
        self._thread = threading.Thread(target=self._loop, daemon=True, name="worker-killer")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
