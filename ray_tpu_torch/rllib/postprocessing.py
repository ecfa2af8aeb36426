"""GAE advantage estimation: the port's own copy of
``ray_tpu/rllib/postprocessing.py`` (numpy only)."""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.rllib.sample_batch import SampleBatch


def compute_gae(
    batch: SampleBatch,
    last_value: float,
    gamma: float = 0.99,
    lambda_: float = 0.95,
) -> SampleBatch:
    """Generalized Advantage Estimation over one trajectory fragment.

    ``last_value`` bootstraps the tail when the fragment was truncated
    mid-episode (0.0 if the episode terminated).  Adds ADVANTAGES and
    VALUE_TARGETS columns in place.

    Episode boundaries INSIDE the fragment are honored from the
    TERMINATEDS/TRUNCATEDS columns: a terminal step bootstraps nothing and
    cuts the GAE trace coming from the next episode's steps (we iterate
    backwards); a mid-fragment TRUNCATION (time-limit) also cuts the
    trace — the following rows belong to a different episode — but
    bootstraps with the value estimate at the truncated state instead of
    zero (the episode didn't end, the clock did).  The final state after
    truncation isn't in the batch, so its own value prediction stands in;
    the fragment's LAST row, when truncated, uses the caller-supplied
    ``last_value`` (the worker computed v(s_T) exactly).  Batches without
    a TRUNCATEDS column (hand-built unit fixtures) treat every step as
    not-truncated, the historical behavior.
    """
    rewards = batch[SampleBatch.REWARDS]
    values = batch[SampleBatch.VF_PREDS]
    terminateds = batch[SampleBatch.TERMINATEDS]
    truncateds = batch.get(SampleBatch.TRUNCATEDS)
    n = len(rewards)
    adv = np.zeros(n, dtype=np.float32)
    last_gae = 0.0
    next_value = last_value
    for t in range(n - 1, -1, -1):
        if terminateds[t]:
            # terminal: no bootstrap, cut the trace from the NEXT episode
            boot, trace = 0.0, 0.0
        elif truncateds is not None and truncateds[t]:
            # truncated: cut the trace, bootstrap with a value estimate —
            # last_value for the tail row (exact v(s_T)), the step's own
            # prediction mid-fragment (s_T isn't in the batch)
            boot, trace = (last_value if t == n - 1 else values[t]), 0.0
        else:
            boot, trace = next_value, 1.0
        delta = rewards[t] + gamma * boot - values[t]
        last_gae = delta + gamma * lambda_ * trace * last_gae
        adv[t] = last_gae
        next_value = values[t]
    batch[SampleBatch.ADVANTAGES] = adv
    batch[SampleBatch.VALUE_TARGETS] = (adv + values).astype(np.float32)
    return batch
