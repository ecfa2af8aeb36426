"""Experiment callbacks + logger callbacks.

Analog of the reference's ``python/ray/tune/callback.py`` (Callback hooks
driven by the TrialRunner loop) and ``tune/logger/`` (CSV/JSON per-trial
result logging).

The port's own copy of ``ray_tpu/tune/callback.py``.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, List, Optional


class Callback:
    """Hook points the TrialRunner invokes (``tune/callback.py`` analog)."""

    def on_trial_start(self, trial) -> None:
        pass

    def on_trial_result(self, trial, result: Dict[str, Any]) -> None:
        pass

    def on_trial_complete(self, trial) -> None:
        pass

    def on_trial_error(self, trial) -> None:
        pass

    def on_experiment_end(self, trials: List) -> None:
        pass


def _scalars(result: Dict[str, Any]) -> Dict[str, Any]:
    return {
        k: v for k, v in result.items()
        if isinstance(v, (int, float, str, bool)) or v is None
    }


class JSONLoggerCallback(Callback):
    """One ``result.json`` (JSON lines) per trial (``tune/logger/json.py``
    analog)."""

    def __init__(self, exp_dir: str):
        self._dir = exp_dir

    def _path(self, trial) -> str:
        d = os.path.join(self._dir, f"trial_{trial.trial_id}")
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, "result.json")

    def on_trial_result(self, trial, result: Dict[str, Any]) -> None:
        with open(self._path(trial), "a") as f:
            json.dump(_scalars(result), f, default=str)
            f.write("\n")


class CSVLoggerCallback(Callback):
    """One ``progress.csv`` per trial (``tune/logger/csv.py`` analog).
    The header is fixed by the first result; later extra keys are dropped
    (the reference's behavior)."""

    def __init__(self, exp_dir: str):
        self._dir = exp_dir
        self._fields: Dict[str, List[str]] = {}

    def _path(self, trial) -> str:
        d = os.path.join(self._dir, f"trial_{trial.trial_id}")
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, "progress.csv")

    def on_trial_result(self, trial, result: Dict[str, Any]) -> None:
        row = _scalars(result)
        path = self._path(trial)
        fields = self._fields.get(trial.trial_id)
        if fields is None:
            fields = self._fields[trial.trial_id] = list(row)
            with open(path, "w", newline="") as f:
                csv.DictWriter(f, fieldnames=fields).writeheader()
        with open(path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=fields, extrasaction="ignore").writerow(row)
