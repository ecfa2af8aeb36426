"""Tuner + tune.run: the experiment entry points.

Analog of ``python/ray/tune/tuner.py:44`` / ``tune/tune.py:131``.  Also
persists experiment state so ``Tuner.restore`` resumes unfinished trials
from their latest checkpoints (``TrialRunner`` restore behavior).

The port's own copy of ``ray_tpu/tune/tuner.py``.  It keeps its results
under ``ray_tpu_torch_results`` in the temporary directory (the port's
Train does too).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import time
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air import RunConfig
from ray_tpu_torch.tune import experiment as T
from ray_tpu_torch.tune.result_grid import ResultGrid
from ray_tpu_torch.tune.schedulers import FIFOScheduler
from ray_tpu_torch.tune.search.basic_variant import BasicVariantGenerator
from ray_tpu_torch.tune.trainable import Trainable, wrap_function
from ray_tpu_torch.tune.trial_runner import TrialRunner

_STATE_FILE = "experiment_state.pkl"
_RESULTS_DIR = "ray_tpu_torch_results"


@dataclasses.dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "min"
    num_samples: int = 1
    max_concurrent_trials: int = 4
    scheduler: Optional[Any] = None
    search_alg: Optional[Any] = None
    resources_per_trial: Optional[Dict[str, float]] = None
    max_failures: int = 0
    stop: Optional[Dict[str, Any]] = None  # e.g. {"training_iteration": 10}
    # kill a trial whose single train() iteration exceeds this (a hung
    # trial must not stall the experiment); None = no deadline
    trial_timeout_s: Optional[float] = None


class Tuner:
    def __init__(
        self,
        trainable: Any,
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
        _trials: Optional[list] = None,
    ):
        self.trainable = self._resolve(trainable)
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self._preloaded_trials = _trials

    @staticmethod
    def _resolve(trainable) -> type:
        from ray_tpu_torch.train.trainer import BaseTrainer

        if isinstance(trainable, BaseTrainer):
            return trainable.as_trainable()
        if isinstance(trainable, type) and issubclass(trainable, Trainable):
            return trainable
        if callable(trainable):
            return wrap_function(trainable)
        raise TypeError(f"cannot make a trainable from {trainable!r}")

    def _exp_dir(self) -> str:
        from ray_tpu_torch.air import remote_storage

        base = self.run_config.storage_path or os.path.join(
            tempfile.gettempdir(), _RESULTS_DIR
        )
        name = self.run_config.name or f"tune_{int(time.time())}"
        if remote_storage.is_uri(base):
            # remote experiment storage (tune/syncer.py seam): run against
            # a local working dir, sync it to the URI on every state save
            self._sync_uri = base.rstrip("/") + "/" + name
            path = os.path.join(tempfile.gettempdir(), _RESULTS_DIR, name)
        else:
            self._sync_uri = None
            path = os.path.join(base, name)
        os.makedirs(path, exist_ok=True)
        return path

    def fit(self) -> ResultGrid:
        from ray_tpu_torch._private.usage import record_feature
        record_feature("tune")

        tc = self.tune_config
        exp_dir = self._exp_dir()
        searcher = None
        if self._preloaded_trials is not None:
            trials = self._preloaded_trials
        elif tc.search_alg is not None and hasattr(tc.search_alg, "suggest"):
            # adaptive Searcher (TPE etc.): trials are suggested as slots
            # free so later suggestions learn from earlier results
            searcher = tc.search_alg
            trials = []
        else:
            gen = tc.search_alg or BasicVariantGenerator()
            trials = [
                T.Trial(config=cfg)
                for cfg in gen.variants(self.param_space, tc.num_samples)
            ]
        callbacks = list(self.run_config.callbacks or [])
        callbacks = [cb(exp_dir) if isinstance(cb, type) else cb for cb in callbacks]
        runner = TrialRunner(
            self.trainable,
            trials,
            scheduler=tc.scheduler or FIFOScheduler(),
            max_concurrent=tc.max_concurrent_trials,
            resources_per_trial=tc.resources_per_trial,
            max_failures=tc.max_failures,
            stop=tc.stop,
            trial_timeout_s=tc.trial_timeout_s,
            searcher=searcher,
            num_samples=tc.num_samples,
            callbacks=callbacks,
        )
        try:
            runner.run()
        finally:
            self._save_state(exp_dir, trials)
        return ResultGrid(trials, metric=tc.metric, mode=tc.mode)

    def _save_state(self, exp_dir: str, trials) -> None:
        state = []
        for i, t in enumerate(trials):
            ckpt_dir = None
            if t.checkpoint is not None:
                # stored RELATIVE to exp_dir: a restore on another machine
                # (different tempdir) re-roots it under its own download
                ckpt_dir = f"trial_{t.trial_id}"
                t.checkpoint.to_directory(os.path.join(exp_dir, ckpt_dir))
            state.append({
                "trial_id": t.trial_id, "config": t.config, "status": t.status,
                "last_result": t.last_result, "error": t.error,
                "checkpoint_dir": ckpt_dir,
            })
        with open(os.path.join(exp_dir, _STATE_FILE), "wb") as f:
            pickle.dump({"trials": state, "param_space": self.param_space}, f)
        if getattr(self, "_sync_uri", None):
            from ray_tpu_torch.air import remote_storage

            remote_storage.upload_dir(exp_dir, self._sync_uri)

    @classmethod
    def restore(cls, path: str, trainable: Any,
                tune_config: Optional[TuneConfig] = None) -> "Tuner":
        """Resume: finished trials keep their results, unfinished ones
        restart from their latest checkpoints.  ``path`` may be a storage
        URI — the experiment is downloaded to a local working dir first."""
        from ray_tpu_torch.air import Checkpoint, remote_storage

        storage_path = os.path.dirname(path.rstrip("/"))
        exp_name = os.path.basename(path.rstrip("/"))
        if remote_storage.is_uri(path):
            local = os.path.join(
                tempfile.gettempdir(), _RESULTS_DIR, exp_name)
            remote_storage.download_dir(path, local)
            path = local
        with open(os.path.join(path, _STATE_FILE), "rb") as f:
            state = pickle.load(f)
        trials = []
        for s in state["trials"]:
            t = T.Trial(config=s["config"], trial_id=s["trial_id"])
            t.last_result = s["last_result"]
            t.error = s["error"]
            ckpt_dir = s["checkpoint_dir"]
            if ckpt_dir:
                if not os.path.isabs(ckpt_dir):  # re-root relative entries
                    ckpt_dir = os.path.join(path, ckpt_dir)
                if os.path.isdir(ckpt_dir):
                    t.checkpoint = Checkpoint.from_directory(ckpt_dir)
            t.status = s["status"] if s["status"] in (T.TERMINATED, T.ERROR) else T.PENDING
            trials.append(t)
        tuner = cls(
            trainable, param_space=state["param_space"],
            tune_config=tune_config,
            # keep the ORIGINAL storage_path (URI included): a resumed
            # fit() re-derives the sync target and uploads state back
            run_config=RunConfig(storage_path=storage_path, name=exp_name),
            _trials=trials,
        )
        return tuner


def run(
    trainable: Callable,
    *,
    config: Optional[Dict[str, Any]] = None,
    num_samples: int = 1,
    metric: Optional[str] = None,
    mode: str = "min",
    scheduler: Optional[Any] = None,
    stop: Optional[Dict[str, Any]] = None,
    max_concurrent_trials: int = 4,
    resources_per_trial: Optional[Dict[str, float]] = None,
    storage_path: Optional[str] = None,
    name: Optional[str] = None,
) -> ResultGrid:
    """Function-style entry point (``tune.run``, ``tune/tune.py:131``)."""
    tuner = Tuner(
        trainable,
        param_space=config,
        tune_config=TuneConfig(
            metric=metric, mode=mode, num_samples=num_samples,
            scheduler=scheduler, max_concurrent_trials=max_concurrent_trials,
            resources_per_trial=resources_per_trial, stop=stop,
        ),
        run_config=RunConfig(storage_path=storage_path, name=name),
    )
    return tuner.fit()
