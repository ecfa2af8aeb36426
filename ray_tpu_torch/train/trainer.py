"""Trainers: BaseTrainer / DataParallelTrainer / TorchTrainer.

``BaseTrainer.fit`` (reference ``train/base_trainer.py:339``) returns a
``Result``; ``DataParallelTrainer`` (``data_parallel_trainer.py:56``)
drives a BackendExecutor gang through ``train_loop_per_worker``, collecting
``session.report`` streams and keeping ranked checkpoints.  Fault
tolerance: on worker failure the whole gang restarts from the latest
checkpoint up to ``FailureConfig.max_failures`` times (the gang is one
failure domain).  ``TorchTrainer`` stands where the JAX package has
``JaxTrainer``.  ``datasets=`` are wired to the workers by the
BackendExecutor through ``dataset_config`` (``DataConfig``): each worker
reads its shard with ``session.get_dataset_shard(name)``.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch

from ray_tpu_torch.air import (
    Checkpoint,
    CheckpointConfig,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.air import session as air_session
from ray_tpu_torch.train.backend import BackendConfig, TorchConfig
from ray_tpu_torch.train.backend_executor import BackendExecutor, TrainingFailedError


class BaseTrainer:
    def __init__(
        self,
        *,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        datasets: Optional[Dict[str, Any]] = None,
        dataset_config: Optional["DataConfig"] = None,
    ):
        from ray_tpu_torch.train.data_config import DataConfig

        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint
        self.datasets = datasets or {}
        self.dataset_config = dataset_config or DataConfig()

    def fit(self) -> Result:
        raise NotImplementedError

    def as_trainable(self):
        """A Tune trainable (base_trainer.py:500 analog): each trial runs
        ``fit()`` with its config merged into ``train_loop_config``, under
        its own ``run_config.name``."""
        from ray_tpu_torch.tune.trainable import wrap_trainer

        return wrap_trainer(self)


class DataParallelTrainer(BaseTrainer):
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict] = None,
        backend_config: Optional[BackendConfig] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        datasets: Optional[Dict[str, Any]] = None,
        dataset_config=None,
    ):
        super().__init__(
            scaling_config=scaling_config, run_config=run_config,
            resume_from_checkpoint=resume_from_checkpoint, datasets=datasets,
            dataset_config=dataset_config,
        )
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.backend_config = backend_config or BackendConfig()

    def _storage_dir(self) -> str:
        base = self.run_config.storage_path or os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch_results"
        )
        name = self.run_config.name or f"train_{int(time.time())}"
        path = os.path.join(base, name)
        os.makedirs(path, exist_ok=True)
        return path

    def fit(self) -> Result:
        from ray_tpu_torch._private.usage import record_feature

        record_feature("train")
        failure_cfg = self.run_config.failure_config or FailureConfig()
        ckpt_cfg = self.run_config.checkpoint_config or CheckpointConfig()
        storage = self._storage_dir()
        latest_ckpt = self.resume_from_checkpoint
        failures = 0

        while True:
            executor = BackendExecutor(self.backend_config, self.scaling_config,
                                       prior_gang_starts=failures)
            try:
                executor.start()
                executor.start_training(
                    self.train_loop_per_worker,
                    config=self.train_loop_config,
                    checkpoint=latest_ckpt,
                    datasets=self.datasets or None,
                    data_config=self.dataset_config,
                    trial_info={"name": self.run_config.name or "train", "id": "0"},
                )
                manager = _CheckpointBook(storage, ckpt_cfg)
                last_metrics: Optional[Dict] = None
                while True:
                    if air_session.is_stop_requested():
                        break  # superseded: abort the gang
                    results = executor.get_next_results()
                    if results is None:
                        break
                    for kind, metrics, ckpt in results:
                        if kind != "report":
                            continue
                        # rank-0's stream defines the run's metrics
                        last_metrics = metrics
                        if ckpt is not None:
                            manager.add(ckpt, metrics)
                            latest_ckpt = ckpt
                return Result(
                    metrics=last_metrics,
                    checkpoint=manager.best() or latest_ckpt,
                    path=storage,
                    best_checkpoints=manager.ranked(),
                )
            except (TrainingFailedError, ray_tpu_torch.exceptions.RayActorError,
                    ray_tpu_torch.exceptions.WorkerCrashedError) as e:
                # worker DEATH during backend setup / rendezvous (before any
                # result flows) is the same gang failure as an in-loop one;
                # permanent failures (scheduling timeouts etc.) still raise
                failures += 1
                if failures > failure_cfg.max_failures:
                    return Result(metrics=None, checkpoint=latest_ckpt,
                                  error=e, path=storage)
                # whole-gang restart from the last checkpoint
            finally:
                executor.shutdown()


class TorchTrainer(DataParallelTrainer):
    """DataParallelTrainer with the torch backend (the reference's
    ``TorchTrainer``; the JAX package's ``JaxTrainer``, BASELINE configs
    2-3).  Each worker holds one card unless ``ScalingConfig(use_gpu=False)``
    (``train.torch_utils.get_device`` is its device)."""

    def __init__(self, train_loop_per_worker, *, torch_config: Optional[TorchConfig] = None,
                 **kwargs):
        kwargs.setdefault("backend_config", torch_config or TorchConfig())
        super().__init__(train_loop_per_worker, **kwargs)


class _CheckpointBook:
    """Rank + persist reported checkpoints (air CheckpointManager analog)."""

    def __init__(self, storage: str, cfg: CheckpointConfig):
        self.storage = storage
        self.cfg = cfg
        self.entries: List[tuple] = []  # (score, idx, Checkpoint)
        self._idx = 0

    def add(self, ckpt: Checkpoint, metrics: Optional[Dict]) -> None:
        attr = self.cfg.checkpoint_score_attribute
        score = (metrics or {}).get(attr) if attr else self._idx
        if score is None:
            score = self._idx
        if self.cfg.checkpoint_score_order == "min":
            score = -score
        path = os.path.join(self.storage, f"checkpoint_{self._idx:06d}")
        ckpt.to_directory(path)
        self.entries.append((score, self._idx, Checkpoint.from_directory(path)))
        self._idx += 1
        keep = self.cfg.num_to_keep
        if keep is not None and len(self.entries) > keep:
            self.entries.sort(key=lambda e: (-e[0], -e[1]))
            for _, idx, stale in self.entries[keep:]:
                import shutil

                shutil.rmtree(
                    os.path.join(self.storage, f"checkpoint_{idx:06d}"),
                    ignore_errors=True,
                )
            self.entries = self.entries[:keep]

    def best(self) -> Optional[Checkpoint]:
        if not self.entries:
            return None
        return max(self.entries, key=lambda e: (e[0], e[1]))[2]

    def ranked(self) -> List[Checkpoint]:
        return [e[2] for e in sorted(self.entries, key=lambda e: (-e[0], -e[1]))]
