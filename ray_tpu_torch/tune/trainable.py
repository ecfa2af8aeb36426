"""Trainables: the unit of work a trial executes.

The port's own copy of ``ray_tpu/tune/trainable.py`` (the reference's
``python/ray/tune/trainable/trainable.py`` class API): ``setup`` /
``step`` / ``save_checkpoint`` / ``load_checkpoint`` / ``cleanup``, driven
by ``train``, ``save``, ``restore`` and ``stop``; checkpoints travel as
the port's ``air.Checkpoint``.  ``wrap_function`` turns a ``fn(config)``
that calls ``session.report`` into a Trainable whose ``step()`` yields one
reported result at a time (``tune/trainable/function_trainable.py``), and
``wrap_trainer`` runs a Train trainer's ``fit()`` as such a function.
"""

from __future__ import annotations

import queue
import threading
import traceback
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air import Checkpoint
from ray_tpu_torch.air import session as air_session

DONE = "done"
TRAINING_ITERATION = "training_iteration"

# how long ``FunctionTrainable.stop`` waits for its runner thread: a
# trainer's fit() notices the stop within one poll of its gang (5 s) and
# then shuts the gang down
STOP_JOIN_S = 30.0


class Trainable:
    def __init__(self, config: Optional[Dict] = None):
        self.config = config or {}
        self.iteration = 0
        self.setup(self.config)

    # -- subclass API --------------------------------------------------
    def setup(self, config: Dict) -> None:
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self) -> Optional[Dict]:
        return None

    def load_checkpoint(self, state: Dict) -> None:
        pass

    def cleanup(self) -> None:
        pass

    def reset_config(self, new_config: Dict) -> bool:
        """PBT exploit hook; return True if handled without re-setup."""
        return False

    # -- runner-facing -------------------------------------------------
    def train(self) -> Dict[str, Any]:
        result = self.step()
        self.iteration += 1
        result.setdefault(TRAINING_ITERATION, self.iteration)
        result.setdefault(DONE, False)
        return result

    def save(self) -> Optional[Checkpoint]:
        state = self.save_checkpoint()
        if state is None:
            return None
        state["_iteration"] = self.iteration
        return Checkpoint.from_dict(state)

    def restore(self, ckpt: Checkpoint) -> None:
        state = ckpt.to_dict()
        self.iteration = state.pop("_iteration", 0)
        self.load_checkpoint(state)

    def stop(self) -> None:
        self.cleanup()


class _SessionStopped(BaseException):
    """Raised inside a superseded runner thread at its next report."""


class FunctionTrainable(Trainable):
    """Runs ``fn(config)`` on a thread; each ``step()`` is the next
    ``session.report`` payload."""

    _fn: Callable = None  # set by wrap_function subclassing

    def setup(self, config: Dict) -> None:
        self._queue: "queue.Queue" = queue.Queue()
        self._latest_ckpt: Optional[Checkpoint] = None
        self._restored_ckpt: Optional[Checkpoint] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()

    def _ensure_started(self) -> None:
        if self._thread is not None:
            return
        stop_event = self._stop_event

        def report_fn(metrics, checkpoint):
            if stop_event.is_set():
                raise _SessionStopped
            self._queue.put(("report", metrics, checkpoint))

        sess = air_session._Session(
            checkpoint=self._restored_ckpt, report_fn=report_fn, stop_event=stop_event)

        def runner():
            air_session._set_session(sess)
            try:
                self._fn(self.config)
                self._queue.put(("finished", None, None))
            except _SessionStopped:
                pass
            except BaseException:  # noqa: BLE001
                self._queue.put(("error", traceback.format_exc(), None))
            finally:
                air_session._set_session(None)

        self._thread = threading.Thread(target=runner, daemon=True)
        self._thread.start()

    def step(self) -> Dict[str, Any]:
        self._ensure_started()
        kind, payload, ckpt = self._queue.get(timeout=600)
        if kind == "error":
            raise RuntimeError(f"trial function failed:\n{payload}")
        if kind == "finished":
            return {DONE: True}
        if ckpt is not None:
            self._latest_ckpt = ckpt
        result = dict(payload)
        result.setdefault(DONE, False)
        return result

    def save_checkpoint(self) -> Optional[Dict]:
        return self._latest_ckpt.to_dict() if self._latest_ckpt else None

    def load_checkpoint(self, state: Dict) -> None:
        self._restored_ckpt = Checkpoint.from_dict(state)

    def stop(self) -> None:
        """Signal the runner thread to die at its next report and join it,
        so a PBT ``reset`` never races a stale fn still training (a
        trainer's gang is shut down before its thread ends)."""
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=STOP_JOIN_S)
        super().stop()


def wrap_function(fn: Callable) -> type:
    """fn(config) -> Trainable subclass (``tune/trainable`` wrap_function)."""
    return type(f"Func_{getattr(fn, '__name__', 'trainable')}",
                (FunctionTrainable,), {"_fn": staticmethod(fn)})


def wrap_trainer(trainer) -> type:
    """BaseTrainer -> Trainable: each trial runs trainer.fit() with the
    trial config merged into train_loop_config (base_trainer.py:352-397)."""
    import copy
    import uuid

    def fn(config):
        t = copy.copy(trainer)
        # Each trial gets its own storage dir: a shared run_config would have
        # every trial's checkpoint bookkeeping writing/deleting the same
        # checkpoint_00000N paths and clobbering each other.
        rc = copy.copy(t.run_config)
        rc.name = f"{rc.name or 'train'}_{uuid.uuid4().hex[:8]}"
        t.run_config = rc
        # A restored/donor checkpoint (failure restore, PBT exploit) must
        # seed the trainer, or the trial silently retrains from step 0.
        restored = air_session.get_checkpoint()
        if restored is not None:
            t.resume_from_checkpoint = restored
        if getattr(t, "train_loop_config", None) is not None:
            merged = dict(t.train_loop_config)
            merged.update(config)
            t.train_loop_config = merged
        elif config:
            t.train_loop_config = dict(config)
        result = t.fit()
        if result.error is not None:
            raise result.error
        air_session.report(result.metrics or {DONE: True}, checkpoint=result.checkpoint)

    return wrap_function(fn)
