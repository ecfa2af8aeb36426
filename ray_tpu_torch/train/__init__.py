"""The port's Train layer: ``TorchTrainer`` over the port's runtime
(``trainer.py``, ``backend.py`` ``TorchConfig``, ``worker_group.py``,
``backend_executor.py``, ``data_config.py`` for ``datasets=``), the helpers
a train loop calls (``torch_utils``), and ``Predictor`` /
``TorchPredictor`` / ``BatchPredictor`` (``predictor.py``), and the CPU
estimators' ``SklearnTrainer`` / ``SklearnPredictor``
(``sklearn_trainer.py``; scikit-learn is imported by neither)."""

from ray_tpu_torch.air import Checkpoint, Result, RunConfig, ScalingConfig
from ray_tpu_torch.train import torch_utils
from ray_tpu_torch.train.backend import Backend, BackendConfig, TorchConfig
from ray_tpu_torch.train.data_config import DataConfig
from ray_tpu_torch.train.predictor import BatchPredictor, Predictor, TorchPredictor
from ray_tpu_torch.train.sklearn_trainer import SklearnPredictor, SklearnTrainer
from ray_tpu_torch.train.trainer import BaseTrainer, DataParallelTrainer, TorchTrainer
from ray_tpu_torch.train.worker_group import WorkerGroup

__all__ = [
    "BatchPredictor",
    "DataConfig",
    "Predictor",
    "TorchPredictor",
    "SklearnTrainer",
    "SklearnPredictor",
    "Backend",
    "BackendConfig",
    "TorchConfig",
    "BaseTrainer",
    "DataParallelTrainer",
    "TorchTrainer",
    "WorkerGroup",
    "torch_utils",
    "Checkpoint",
    "Result",
    "RunConfig",
    "ScalingConfig",
]
