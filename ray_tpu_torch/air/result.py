"""Result: the terminal state of a training run (``python/ray/air/result.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint


@dataclasses.dataclass
class Result:
    metrics: Optional[Dict[str, Any]] = None
    checkpoint: Optional[Checkpoint] = None
    error: Optional[Exception] = None
    path: Optional[str] = None
    metrics_dataframe: Optional[Any] = None
    best_checkpoints: Optional[List] = None

    @property
    def config(self) -> Optional[Dict]:
        return (self.metrics or {}).get("config")
