"""ResultGrid: terminal view of an experiment (``tune/result_grid.py``).

The port's own copy of ``ray_tpu/tune/result_grid.py``.
"""

from __future__ import annotations

from typing import List, Optional

from ray_tpu_torch.air import Result
from ray_tpu_torch.tune import experiment as T


class ResultGrid:
    def __init__(self, trials: List[T.Trial], metric: Optional[str] = None,
                 mode: str = "min"):
        self._trials = trials
        self._metric = metric
        self._mode = mode

    def __len__(self) -> int:
        return len(self._trials)

    def __getitem__(self, i: int) -> Result:
        t = self._trials[i]
        return Result(
            metrics={**(t.last_result or {}), "config": t.config},
            checkpoint=t.checkpoint,
            error=RuntimeError(t.error) if t.error else None,
        )

    @property
    def errors(self) -> List[str]:
        return [t.error for t in self._trials if t.error]

    def get_best_result(self, metric: Optional[str] = None, mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("metric required (none set on TuneConfig)")
        best, best_v = None, None
        for i, t in enumerate(self._trials):
            if not t.last_result or metric not in t.last_result:
                continue
            v = t.last_result[metric]
            better = (
                best_v is None
                or (mode == "min" and v < best_v)
                or (mode == "max" and v > best_v)
            )
            if better:
                best, best_v = i, v
        if best is None:
            raise ValueError(f"no trial reported metric {metric!r}")
        return self[best]

    def get_dataframe(self):
        import pandas as pd

        rows = []
        for t in self._trials:
            row = dict(t.last_result or {})
            row["trial_id"] = t.trial_id
            for k, v in t.config.items():
                row[f"config/{k}"] = v
            rows.append(row)
        return pd.DataFrame(rows)
