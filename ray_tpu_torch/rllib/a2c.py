"""A2C: synchronous advantage actor-critic.

Counterpart of ``ray_tpu/rllib/a2c.py`` (the reference's
``algorithms/a2c/a2c.py``): ``make_a2c_loss`` (vanilla policy gradient on
normalized advantages, a value loss and an entropy bonus), ``A2CConfig``
and ``A2C``, whose training step is one gradient step on the whole batch
(PPO without the ratio clip and the SGD epochs)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import (
    Algorithm,
    AlgorithmConfig,
    synchronous_parallel_sample,
    train_one_step,
)
from ray_tpu_torch.rllib.policy import gather_logp
from ray_tpu_torch.rllib.ppo import entropy_of, normalize
from ray_tpu_torch.rllib.rl_module import Columns
from ray_tpu_torch.rllib.sample_batch import SampleBatch


def make_a2c_loss(vf_loss_coeff: float, entropy_coeff: float):
    def loss(module, params, batch):
        out = module.forward_train(params, batch[SampleBatch.OBS])
        logp_all, logp = gather_logp(out[Columns.ACTION_DIST_INPUTS], batch[SampleBatch.ACTIONS])
        adv = normalize(batch[SampleBatch.ADVANTAGES])
        policy_loss = -(logp * adv).mean()
        vf_loss = torch.square(out[Columns.VF_PREDS] - batch[SampleBatch.VALUE_TARGETS]).mean()
        entropy = entropy_of(logp_all)
        total = policy_loss + vf_loss_coeff * vf_loss - entropy_coeff * entropy
        return total, {"policy_loss": policy_loss, "vf_loss": vf_loss, "entropy": entropy}

    return loss


def _a2c_loss_factory(config: Dict[str, Any]):
    return make_a2c_loss(config["vf_loss_coeff"], config["entropy_coeff"])


class A2CConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=A2C)
        self._config.update(
            _loss_factory=_a2c_loss_factory,
            lr=1e-3,
            train_batch_size=1000,
            # None = one gradient step over the whole batch (true A2C); a
            # size takes one optimizer step per microbatch instead (an
            # approximation, not gradient accumulation)
            microbatch_size=None,
            vf_loss_coeff=0.5,
            entropy_coeff=0.01,
            lambda_=0.95,
            grad_clip=0.5,
        )


class A2C(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        super().setup(config)
        self._sgd_rng = np.random.default_rng(self.config.get("seed", 0))

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        self.workers.sync_weights()
        batch = synchronous_parallel_sample(self.workers, max_env_steps=cfg["train_batch_size"])
        self._timesteps_total += batch.count
        learner_metrics = train_one_step(
            self.workers.local_worker.policy, batch, num_sgd_iter=1,
            sgd_minibatch_size=cfg["microbatch_size"] or batch.count, rng=self._sgd_rng,
            required_keys=(SampleBatch.OBS, SampleBatch.ACTIONS, SampleBatch.ADVANTAGES,
                           SampleBatch.VALUE_TARGETS))
        return {"info": {"learner": learner_metrics}}


A2C._default_config = A2CConfig().to_dict()
