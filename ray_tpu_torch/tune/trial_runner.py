"""TrialRunner: the experiment event loop.

Analog of ``python/ray/tune/execution/trial_runner.py:320`` +
``ray_trial_executor.py:213``: each trial is a dedicated actor hosting its
Trainable; the loop starts trials up to the concurrency cap, waits on
in-flight ``train()`` futures, routes results through the scheduler, and
checkpoints/stops per its decisions.

The port's own copy of ``ray_tpu/tune/trial_runner.py``.  A trial host
asks for ``resources_per_trial["GPU"]`` as ``num_gpus`` (the JAX package
has ``"TPU"`` and ``num_tpus``), and the actor sees its grant as
``CUDA_VISIBLE_DEVICES``: with no ``"GPU"`` key it sees no card, so a
trainable that defaults to the card (an RLlib learner) raises there at
once.  A trial asking for more of a resource than the cluster has fails
the experiment before any trial starts, where it would wait forever.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.tune import experiment as T
from ray_tpu_torch.tune.schedulers import CONTINUE, FIFOScheduler, STOP
from ray_tpu_torch.tune.trainable import DONE

logger = logging.getLogger(__name__)


class _TrialHost:
    """Actor hosting one trial's Trainable instance."""

    def __init__(self, trainable_blob: bytes, config: Dict[str, Any]):
        cls = cloudpickle.loads(trainable_blob)
        self.trainable = cls(config)

    def train(self) -> Dict[str, Any]:
        return self.trainable.train()

    def save(self):
        return self.trainable.save()

    def restore(self, ckpt) -> bool:
        self.trainable.restore(ckpt)
        return True

    def reset(self, trainable_blob: bytes, config: Dict[str, Any], ckpt) -> bool:
        """PBT exploit: new config (+ donor checkpoint) in place."""
        if not self.trainable.reset_config(config):
            self.trainable.stop()
            cls = cloudpickle.loads(trainable_blob)
            self.trainable = cls(config)
        if ckpt is not None:
            self.trainable.restore(ckpt)
        return True

    def stop(self) -> bool:
        self.trainable.stop()
        return True


class TrialRunner:
    def __init__(
        self,
        trainable_cls: type,
        trials: List[T.Trial],
        scheduler: Optional[FIFOScheduler] = None,
        max_concurrent: int = 4,
        resources_per_trial: Optional[Dict[str, float]] = None,
        max_failures: int = 0,
        stop: Optional[Dict[str, Any]] = None,
        trial_timeout_s: Optional[float] = None,
        searcher: Optional[Any] = None,
        num_samples: Optional[int] = None,
        callbacks: Optional[List[Any]] = None,
    ):
        self.trainable_blob = cloudpickle.dumps(trainable_cls)
        self.trials = trials
        self.scheduler = scheduler or FIFOScheduler()
        self.max_concurrent = max_concurrent
        self.resources = resources_per_trial or {"CPU": 1.0}
        self.max_failures = max_failures
        self.stop_criteria = stop or {}
        # a train() iteration exceeding this is a failure (hung-trial
        # deadline — without it one wedged trial stalls the experiment)
        self.trial_timeout_s = trial_timeout_s
        # adaptive search: new trials are suggested as slots free up, so
        # later suggestions see earlier results (Searcher interface)
        self.searcher = searcher
        self.num_samples = num_samples or len(trials)
        self.callbacks = callbacks or []

    def _callback(self, hook: str, trial, *args) -> None:
        for cb in self.callbacks:
            try:
                getattr(cb, hook)(trial, *args)
            except Exception:  # noqa: BLE001 — a logger must not kill the loop
                logger.exception("callback %s.%s failed", cb, hook)

    # -- scheduler support services -----------------------------------
    def get_trial(self, trial_id: str) -> Optional[T.Trial]:
        for t in self.trials:
            if t.trial_id == trial_id:
                return t
        return None

    def exploit_trial(self, trial: T.Trial, donor: T.Trial, new_config: Dict) -> None:
        """Clone donor's weights into ``trial`` with an explored config."""
        if donor.actor is None or trial.actor is None:
            return
        ckpt = ray_tpu_torch.get(donor.actor.save.remote(), timeout=120)
        trial.config = new_config
        ray_tpu_torch.get(
            trial.actor.reset.remote(self.trainable_blob, new_config, ckpt),
            timeout=300,
        )

    # -- lifecycle -----------------------------------------------------
    def _start_trial(self, trial: T.Trial) -> None:
        Host = ray_tpu_torch.remote(_TrialHost)
        opts = {}
        if "CPU" in self.resources:
            opts["num_cpus"] = self.resources["CPU"]
        if "GPU" in self.resources:
            opts["num_gpus"] = self.resources["GPU"]
        trial.actor = Host.options(**opts).remote(self.trainable_blob, trial.config)
        if trial.checkpoint is not None:
            ray_tpu_torch.get(trial.actor.restore.remote(trial.checkpoint), timeout=300)
        trial.future = trial.actor.train.remote()
        trial.future_started = time.time()
        trial.status = T.RUNNING

    def _stop_trial(self, trial: T.Trial, status: str, save: bool = True,
                    graceful: bool = True) -> None:
        if trial.actor is not None:
            if graceful:  # a hung trial gets no goodbye round-trips
                try:
                    if save:
                        ckpt = ray_tpu_torch.get(trial.actor.save.remote(), timeout=120)
                        if ckpt is not None:
                            trial.checkpoint = ckpt
                    ray_tpu_torch.get(trial.actor.stop.remote(), timeout=60)
                except Exception:
                    pass
            elif trial.future is not None:
                # deadline kill: cancel the wedged train() call first (the
                # core cancellation primitive) so its future resolves with
                # TaskCancelledError instead of dangling until actor death
                try:
                    ray_tpu_torch.cancel(trial.future, recursive=True)
                except Exception:
                    pass
            try:
                ray_tpu_torch.kill(trial.actor)
            except Exception:
                pass
        trial.actor = None
        trial.future = None
        trial.future_started = None
        trial.status = status

    def _should_stop(self, result: Dict[str, Any]) -> bool:
        if result.get(DONE):
            return True
        for key, bound in self.stop_criteria.items():
            v = result.get(key)
            if v is not None and v >= bound:
                return True
        return False

    def step(self) -> bool:
        """One event-loop turn; returns False when the experiment is done."""
        running = [t for t in self.trials if t.status == T.RUNNING]
        pending = [t for t in self.trials if t.status == T.PENDING]
        if self.searcher is not None:
            # top up from the searcher: each suggestion sees all completed
            # results reported so far
            while (
                len(self.trials) < self.num_samples
                and len(running) + len(pending) < self.max_concurrent
            ):
                trial = T.Trial(config={})
                cfg = self.searcher.suggest(trial.trial_id)
                if cfg is None:
                    break
                trial.config = cfg
                self.trials.append(trial)
                pending.append(trial)
        if not running and not pending:
            return False
        for t in pending[: max(0, self.max_concurrent - len(running))]:
            self._start_trial(t)
            self._callback("on_trial_start", t)
            running.append(t)
        if not running:
            return False

        futures = {t.future: t for t in running if t.future is not None}
        wait_timeout = 120.0 if self.trial_timeout_s is None else min(
            120.0, max(1.0, self.trial_timeout_s / 4)
        )
        ready, _ = ray_tpu_torch.wait(list(futures), num_returns=1, timeout=wait_timeout)
        if self.trial_timeout_s is not None:
            # enforce the per-iteration deadline EVERY turn — a wedged
            # trial must not survive behind other trials' progress
            now = time.time()
            for trial in running:
                if trial.future in ready or trial.future is None:
                    continue
                if (trial.future_started is not None
                        and now - trial.future_started > self.trial_timeout_s):
                    trial.num_failures += 1
                    logger.warning("trial %s exceeded trial_timeout_s=%.0f; killing",
                                   trial.trial_id, self.trial_timeout_s)
                    if trial.num_failures > self.max_failures:
                        trial.error = f"trial timed out after {self.trial_timeout_s}s"
                        self._stop_trial(trial, T.ERROR, save=False, graceful=False)
                        self._callback("on_trial_error", trial)
                        if self.searcher is not None:
                            self.searcher.on_trial_complete(trial.trial_id, None)
                    else:
                        self._stop_trial(trial, T.PENDING, save=False, graceful=False)
        for fut in ready:
            trial = futures[fut]
            try:
                result = ray_tpu_torch.get(fut)
            except Exception as e:  # noqa: BLE001
                trial.num_failures += 1
                if trial.num_failures > self.max_failures:
                    trial.error = str(e)
                    self._stop_trial(trial, T.ERROR, save=False)
                    self._callback("on_trial_error", trial)
                    if self.searcher is not None:
                        self.searcher.on_trial_complete(trial.trial_id, None)
                else:
                    self._stop_trial(trial, T.PENDING, save=False)
                continue
            # merge: the synthetic terminal {done: True} must not clobber the
            # last real metrics
            trial.last_result = {**(trial.last_result or {}), **result}
            self._callback("on_trial_result", trial, result)
            if self._should_stop(result):
                self.scheduler.on_trial_complete(self, trial, result)
                self._stop_trial(trial, T.TERMINATED)
                self._finish_trial(trial)
                continue
            decision = self.scheduler.on_trial_result(self, trial, result)
            if decision == STOP:
                self._stop_trial(trial, T.TERMINATED)
                self._finish_trial(trial)
            else:
                trial.future = trial.actor.train.remote()
                trial.future_started = time.time()
        return True

    def _finish_trial(self, trial: T.Trial) -> None:
        self._callback("on_trial_complete", trial)
        if self.searcher is not None:
            self.searcher.on_trial_complete(trial.trial_id, trial.last_result)

    def _check_cluster_fits(self) -> None:
        """Raise at once, naming the resource, when no trial could ever be
        placed (the Train gang's check, ``train/worker_group.py``)."""
        total = ray_tpu_torch.cluster_resources()
        for name in ("CPU", "GPU"):
            need = self.resources.get(name, 0.0)
            if total.get(name, 0.0) + 1e-9 < need:
                raise RuntimeError(
                    f"the cluster has {total.get(name, 0.0):g} {name} and each "
                    f"trial asks for {need:g} (resources_per_trial)")

    def run(self) -> List[T.Trial]:
        self._check_cluster_fits()
        while self.step():
            pass
        for cb in self.callbacks:
            try:
                cb.on_experiment_end(self.trials)
            except Exception:  # noqa: BLE001
                logger.exception("callback on_experiment_end failed")
        return self.trials
