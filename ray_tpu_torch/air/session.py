"""Training session: the worker-side API inside train loops.

Analog of ``python/ray/air/session.py:41`` (``session.report``) and the
``_TrainSession`` it fronts (``python/ray/train/_internal/session.py:61``):
the user's ``train_loop_per_worker`` calls ``report(metrics, checkpoint=)``
and reads rank/world info; the hosting worker wires the queue back to the
driver.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint

# Thread-local primary + process-global fallback: a superseded runner thread
# (e.g. a PBT ``reset`` swapping trainables while the old fn drains) reads its
# *own* session and can only CAS-clear the global if it still owns it, while
# helper threads the user's train fn spawns (no TLS entry) still resolve the
# most recently installed session.
_tls = threading.local()
_global_lock = threading.Lock()
_global_session: Optional["_Session"] = None

_STEP_TIME_HIST = None


def _step_time_hist():
    global _STEP_TIME_HIST
    if _STEP_TIME_HIST is None:
        from ray_tpu_torch.util.metrics import Histogram

        _STEP_TIME_HIST = Histogram(
            "ray_tpu_train_step_time_s",
            "wall time between consecutive session.report calls (s)",
            boundaries=[0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 30, 120],
            tag_keys=("rank",))
    return _STEP_TIME_HIST


class _Session:
    def __init__(
        self, *, world_size: int = 1, world_rank: int = 0, local_rank: int = 0,
        trial_name: str = "", trial_id: str = "", checkpoint: Optional[Checkpoint] = None,
        dataset_shards: Optional[Dict[str, Any]] = None, report_fn=None,
        stop_event: Optional[threading.Event] = None,
    ):
        self.world_size = world_size
        self.world_rank = world_rank
        self.local_rank = local_rank
        self.trial_name = trial_name
        self.trial_id = trial_id
        self.loaded_checkpoint = checkpoint
        self.dataset_shards = dataset_shards or {}
        self._report_fn = report_fn  # callable(metrics, checkpoint)
        self.stop_event = stop_event
        self._last_report_t: Optional[float] = None

    def report(self, metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None):
        from ray_tpu_torch._private import events as _events

        if _events.ENABLED:
            # report() runs once per step in the canonical train loop, so
            # the inter-report gap IS the step time (ingest wait included;
            # the ingest-wait counter isolates that share)
            import time as _time

            now = _time.perf_counter()
            if self._last_report_t is not None:
                _step_time_hist().observe(
                    now - self._last_report_t,
                    tags={"rank": str(self.world_rank)})
            self._last_report_t = now
        if self._report_fn is not None:
            self._report_fn(metrics, checkpoint)


def _set_session(s: Optional[_Session]) -> None:
    global _global_session
    prev = getattr(_tls, "session", None)
    _tls.session = s
    with _global_lock:
        if s is not None:
            _global_session = s
        elif prev is not None and _global_session is prev:
            _global_session = None


def _get_session() -> Optional[_Session]:
    s = getattr(_tls, "session", None)
    return s if s is not None else _global_session


def is_stop_requested() -> bool:
    """True once the hosting trainable was told to stop (e.g. a PBT
    ``reset`` superseded this trial) — long-running library loops such as
    ``DataParallelTrainer.fit`` poll this to abort cooperatively."""
    s = _get_session()
    return bool(s is not None and s.stop_event is not None and s.stop_event.is_set())


def report(metrics: Dict[str, Any], *, checkpoint: Optional[Checkpoint] = None) -> None:
    """Send metrics (and optionally a checkpoint) back to the driver."""
    s = _get_session()
    if s is None:
        raise RuntimeError("session.report() called outside a train session")
    s.report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    s = _get_session()
    return s.loaded_checkpoint if s else None


def get_world_size() -> int:
    s = _get_session()
    return s.world_size if s else 1


def get_world_rank() -> int:
    s = _get_session()
    return s.world_rank if s else 0


def get_local_rank() -> int:
    s = _get_session()
    return s.local_rank if s else 0


def get_trial_name() -> str:
    s = _get_session()
    return s.trial_name if s else ""


def get_trial_id() -> str:
    s = _get_session()
    return s.trial_id if s else ""


def get_dataset_shard(name: str = "train"):
    """This worker's shard of the dataset passed to the Trainer
    (``air/session.py:345``)."""
    s = _get_session()
    if s is None:
        return None
    return s.dataset_shards.get(name)
