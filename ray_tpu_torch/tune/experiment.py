"""Trial state (``python/ray/tune/experiment/trial.py:207`` analog).

The port's own copy of ``ray_tpu/tune/experiment.py``. Checkpoints are the
port's ``air.Checkpoint``.
"""

from __future__ import annotations

import dataclasses
import uuid
from typing import Any, Dict, Optional

from ray_tpu_torch.air import Checkpoint

PENDING = "PENDING"
RUNNING = "RUNNING"
PAUSED = "PAUSED"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


@dataclasses.dataclass
class Trial:
    config: Dict[str, Any]
    trial_id: str = dataclasses.field(default_factory=lambda: uuid.uuid4().hex[:8])
    status: str = PENDING
    last_result: Optional[Dict[str, Any]] = None
    checkpoint: Optional[Checkpoint] = None
    error: Optional[str] = None
    num_failures: int = 0
    # runtime handles (not persisted)
    actor: Any = None
    future: Any = None
    # wall time the in-flight train() future was armed (deadline tracking)
    future_started: Optional[float] = None

    @property
    def is_finished(self) -> bool:
        return self.status in (TERMINATED, ERROR)
