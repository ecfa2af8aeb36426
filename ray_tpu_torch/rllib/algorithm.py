"""``train_one_step``: minibatch SGD epochs over one train batch.

Counterpart of ``ray_tpu/rllib/algorithm.py``'s ``train_one_step``
(``execution/train_ops.py`` in RLlib).  ``Algorithm``,
``AlgorithmConfig`` and ``synchronous_parallel_sample`` need the runtime
and are not ported yet, and neither is the learner's events span, which
waits for the port's copy of the events plane.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.policy import to_device
from ray_tpu_torch.rllib.sample_batch import SampleBatch


def train_one_step(
    policy,
    batch: SampleBatch,
    *,
    num_sgd_iter: int,
    sgd_minibatch_size: int,
    rng: np.random.Generator,
    required_keys: tuple,
) -> Dict[str, float]:
    """``num_sgd_iter`` epochs of ``policy.learn_on_minibatch`` over
    shuffled minibatches of ``batch``'s ``required_keys``; returns each
    metric's mean over the minibatches.

    The columns cross to the policy's device once, and each epoch indexes
    them there with ``rng.permutation``: the same minibatches, in the same
    order, as ``batch.minibatches(size, rng)`` gives the JAX package's
    learner (the ragged tail dropped)."""
    cols = {k: to_device(batch[k], policy.device) for k in required_keys}
    n = batch.count
    mb_size = min(sgd_minibatch_size, n)
    metrics: Dict[str, float] = {}
    count = 0
    for _ in range(num_sgd_iter):
        perm = torch.from_numpy(rng.permutation(n)).to(policy.device)
        for start in range(0, n - mb_size + 1, mb_size):
            idx = perm[start:start + mb_size]
            out = policy.learn_on_minibatch({k: v[idx] for k, v in cols.items()})
            for k, v in out.items():
                metrics[k] = metrics.get(k, 0.0) + v
            count += 1
    return {k: v / max(count, 1) for k, v in metrics.items()}
