"""Run/scaling configuration dataclasses (``python/ray/air/config.py``).

``ScalingConfig`` speaks GPU: ``use_gpu`` and ``gpus_per_worker`` stand
where the JAX package has ``use_tpu`` and ``tpus_per_worker``.  ``use_gpu``
defaults to True, because the port runs on the card unless the caller asks
for the CPU (``use_gpu=False``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class ScalingConfig:
    num_workers: int = 1
    use_gpu: bool = True
    gpus_per_worker: int = 0  # cards each worker owns (1 when 0 and use_gpu)
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"

    @property
    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_gpu:
            res.setdefault("GPU", float(self.gpus_per_worker or 1))
        return res


@dataclasses.dataclass
class FailureConfig:
    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: Optional[FailureConfig] = None
    checkpoint_config: Optional[CheckpointConfig] = None
    verbose: int = 1
    # tune.Callback instances (loggers etc.); factories taking the
    # experiment dir (e.g. CSVLoggerCallback) are instantiated by Tuner
    callbacks: Optional[list] = None
