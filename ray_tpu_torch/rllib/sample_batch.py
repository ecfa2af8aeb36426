"""SampleBatch: the columnar container for rollout data.

The port's own copy of ``ray_tpu/rllib/sample_batch.py`` (numpy only): a
dict of equal-length numpy arrays with the standard column names and
concat/slice/shuffle/minibatch utilities.  ``minibatches`` draws the same
permutation from the same numpy ``Generator`` as the JAX package, so both
learners see the same minibatches in the same order.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np


class SampleBatch(dict):
    OBS = "obs"
    NEXT_OBS = "new_obs"
    ACTIONS = "actions"
    REWARDS = "rewards"
    TERMINATEDS = "terminateds"
    TRUNCATEDS = "truncateds"
    ACTION_LOGP = "action_logp"
    VF_PREDS = "vf_preds"
    ADVANTAGES = "advantages"
    VALUE_TARGETS = "value_targets"
    EPS_ID = "eps_id"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if not isinstance(v, np.ndarray):
                self[k] = np.asarray(v)

    def __len__(self) -> int:
        for v in self.values():
            return len(v)
        return 0

    @property
    def count(self) -> int:
        return len(self)

    @staticmethod
    def concat_samples(batches: List["SampleBatch"]) -> "SampleBatch":
        if not batches:
            return SampleBatch()
        keys = batches[0].keys()
        return SampleBatch({
            k: np.concatenate([b[k] for b in batches], axis=0) for k in keys
        })

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: v[start:end] for k, v in self.items()})

    def shuffle(self, rng: np.random.Generator) -> "SampleBatch":
        perm = rng.permutation(len(self))
        return SampleBatch({k: v[perm] for k, v in self.items()})

    def minibatches(self, minibatch_size: int, rng: np.random.Generator) -> Iterator["SampleBatch"]:
        """Shuffled fixed-size minibatches (drops the ragged tail, so every
        SGD step sees one shape)."""
        shuffled = self.shuffle(rng)
        n = len(shuffled)
        for start in range(0, n - minibatch_size + 1, minibatch_size):
            yield shuffled.slice(start, start + minibatch_size)

    def as_arrays(self) -> Dict[str, np.ndarray]:
        return dict(self)
