"""The port's AIR layer: ``Checkpoint`` (``air/checkpoint.py``), the run
and scaling configs (``air/config.py``; ``ScalingConfig(use_gpu=True)``
by default), ``session.report`` (``air/session.py``) and ``Result``."""

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.air import session

__all__ = [
    "Checkpoint",
    "ScalingConfig",
    "RunConfig",
    "FailureConfig",
    "CheckpointConfig",
    "Result",
    "session",
]
