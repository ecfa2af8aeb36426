"""The port's AIR layer: ``Checkpoint`` (``air/checkpoint.py``), the run
and scaling configs (``air/config.py``; ``ScalingConfig(use_gpu=True)``
by default), ``session.report`` (``air/session.py``), ``Result``, and
the storage registry Tune syncs experiments through
(``air/remote_storage.py``)."""

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.air import remote_storage, session

__all__ = [
    "Checkpoint",
    "ScalingConfig",
    "RunConfig",
    "FailureConfig",
    "CheckpointConfig",
    "Result",
    "session",
    "remote_storage",
]
