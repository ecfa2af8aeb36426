"""ray_tpu_torch.tune: the experiment runner on the port's runtime.

Counterpart of ``ray_tpu/tune/`` (the reference's ``Tuner``
``tune/tuner.py:44``, ``tune.run`` ``tune/tune.py:131``, ``TrialRunner``
``execution/trial_runner.py:320``): each trial runs in an actor of the
port's runtime, schedulers (ASHA, PBT, median stopping) make continue /
stop decisions on reported results, searchers suggest configs, and Train
runs on Tune through ``BaseTrainer.as_trainable``.  A trial host holds a
card only when ``TuneConfig(resources_per_trial={"GPU": ...})`` grants
it one.
"""

from ray_tpu_torch.tune.callback import Callback, CSVLoggerCallback, JSONLoggerCallback
from ray_tpu_torch.tune.search.searcher import Searcher, TPESearcher
from ray_tpu_torch.tune.trainable import DONE, TRAINING_ITERATION, Trainable, wrap_function
from ray_tpu_torch.tune.search.sample import (
    choice,
    grid_search,
    loguniform,
    randint,
    uniform,
)
from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
)
from ray_tpu_torch.tune.tuner import TuneConfig, Tuner, run
from ray_tpu_torch.tune.result_grid import ResultGrid

__all__ = [
    "Trainable",
    "wrap_function",
    "Callback",
    "CSVLoggerCallback",
    "JSONLoggerCallback",
    "Searcher",
    "TPESearcher",
    "uniform",
    "loguniform",
    "choice",
    "randint",
    "grid_search",
    "FIFOScheduler",
    "ASHAScheduler",
    "MedianStoppingRule",
    "PopulationBasedTraining",
    "Tuner",
    "TuneConfig",
    "run",
    "ResultGrid",
    "DONE",
    "TRAINING_ITERATION",
]
