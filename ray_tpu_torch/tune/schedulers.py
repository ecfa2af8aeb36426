"""Trial schedulers: FIFO, ASHA, median stopping, PBT.

Analog of ``python/ray/tune/schedulers/*``: the runner feeds each reported
result to ``on_trial_result`` and acts on CONTINUE/STOP decisions;
PBT additionally mutates bottom-quantile trials from top-quantile
checkpoints (``schedulers/pbt.py`` behavior).

The port's own copy of ``ray_tpu/tune/schedulers.py``.
"""

from __future__ import annotations

import math
import random
from collections import defaultdict
from typing import Any, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


class FIFOScheduler:
    def on_trial_result(self, runner, trial, result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, runner, trial, result: Dict[str, Any]) -> None:
        pass


class ASHAScheduler(FIFOScheduler):
    """Asynchronous successive halving (``schedulers/async_hyperband.py``):
    at each rung (grace_period * reduction_factor^k iterations) a trial
    survives only if it is in the top 1/reduction_factor of results seen at
    that rung."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 max_t: int = 100, grace_period: int = 1, reduction_factor: int = 4,
                 time_attr: str = "training_iteration"):
        self.metric, self.mode = metric, mode
        self.max_t, self.grace, self.rf = max_t, grace_period, reduction_factor
        self.time_attr = time_attr
        self.rungs: Dict[int, List[float]] = defaultdict(list)
        self._passed: Dict[str, int] = defaultdict(int)  # trial -> rungs cleared

    def _milestones(self) -> List[int]:
        ms, t = [], self.grace
        while t < self.max_t:
            ms.append(t)
            t *= self.rf
        return ms

    def on_trial_result(self, runner, trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr, 0)
        value = result.get(self.metric)
        if value is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        score = -value if self.mode == "min" else value
        # Compare at the first result with t >= milestone (results need not
        # land exactly on grace*rf^k).  Only the HIGHEST milestone crossed is
        # recorded — a t=4-matured score folded into rung 1 would inflate the
        # cutoff against trials legitimately reporting at t=1.
        milestones = self._milestones()
        n_cleared = self._passed[trial.trial_id]
        crossed = [m for m in milestones[n_cleared:] if t >= m]
        if not crossed:
            return CONTINUE
        self._passed[trial.trial_id] = n_cleared + len(crossed)
        m = crossed[-1]
        rung = self.rungs[m]
        rung.append(score)
        k = max(1, len(rung) // self.rf)
        cutoff = sorted(rung, reverse=True)[k - 1]
        return STOP if score < cutoff else CONTINUE


class MedianStoppingRule(FIFOScheduler):
    """Stop a trial whose best result is worse than the median of running
    averages (``schedulers/median_stopping_rule.py``)."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 grace_period: int = 3, min_samples_required: int = 3,
                 time_attr: str = "training_iteration"):
        self.metric, self.mode = metric, mode
        self.grace = grace_period
        self.min_samples = min_samples_required
        self.time_attr = time_attr
        self.histories: Dict[str, List[float]] = defaultdict(list)

    def on_trial_result(self, runner, trial, result: Dict[str, Any]) -> str:
        value = result.get(self.metric)
        if value is None:
            return CONTINUE
        score = -value if self.mode == "min" else value
        self.histories[trial.trial_id].append(score)
        t = result.get(self.time_attr, 0)
        if t < self.grace or len(self.histories) < self.min_samples:
            return CONTINUE
        means = [sum(h) / len(h) for tid, h in self.histories.items()
                 if tid != trial.trial_id and h]
        if not means:
            return CONTINUE
        median = sorted(means)[len(means) // 2]
        best = max(self.histories[trial.trial_id])
        return STOP if best < median else CONTINUE


class PopulationBasedTraining(FIFOScheduler):
    """PBT (``schedulers/pbt.py``): every ``perturbation_interval``
    iterations, bottom-quantile trials exploit (clone config+checkpoint of
    a top-quantile trial) and explore (perturb hyperparams)."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25, seed: int = 0,
                 time_attr: str = "training_iteration"):
        self.metric, self.mode = metric, mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.rng = random.Random(seed)
        self.time_attr = time_attr
        self.latest: Dict[str, float] = {}
        self.last_perturb: Dict[str, int] = defaultdict(int)

    def on_trial_result(self, runner, trial, result: Dict[str, Any]) -> str:
        value = result.get(self.metric)
        if value is None:
            return CONTINUE
        score = -value if self.mode == "min" else value
        self.latest[trial.trial_id] = score
        t = result.get(self.time_attr, 0)
        if t - self.last_perturb[trial.trial_id] < self.interval:
            return CONTINUE
        self.last_perturb[trial.trial_id] = t
        if len(self.latest) < 2:
            return CONTINUE
        ranked = sorted(self.latest.items(), key=lambda kv: kv[1], reverse=True)
        k = max(1, int(len(ranked) * self.quantile))
        top = [tid for tid, _ in ranked[:k]]
        bottom = {tid for tid, _ in ranked[-k:]}
        if trial.trial_id in bottom and trial.trial_id not in top:
            donor_id = self.rng.choice(top)
            donor = runner.get_trial(donor_id)
            if donor is not None:
                runner.exploit_trial(trial, donor, self._explore(donor.config))
        return CONTINUE

    def _explore(self, config: Dict) -> Dict:
        new = dict(config)
        for key, spec in self.mutations.items():
            if isinstance(spec, list):
                new[key] = self.rng.choice(spec)
            elif callable(spec):
                new[key] = spec()
            elif key in new and isinstance(new[key], (int, float)):
                factor = self.rng.choice([0.8, 1.2])
                new[key] = type(new[key])(new[key] * factor)
        return new
