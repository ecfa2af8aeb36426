"""PPO: clipped-surrogate policy optimization.

Counterpart of ``ray_tpu/rllib/ppo.py`` (the reference's ``ppo.py:311``
``PPO.training_step``: synchronous sampling, then minibatch SGD on the
clipped objective, then the weight broadcast): ``make_ppo_loss``,
``PPOConfig`` and ``PPO``.
"""

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
from ray_tpu_torch.rllib.rl_module import Columns
from ray_tpu_torch.rllib.sample_batch import SampleBatch

# PPOConfig's defaults in the JAX package (ppo.py), for a config dict
PPO_DEFAULTS = dict(lr=3e-4, train_batch_size=4000, sgd_minibatch_size=128, num_sgd_iter=10,
                    clip_param=0.2, vf_clip_param=10.0, vf_loss_coeff=0.5, entropy_coeff=0.0,
                    lambda_=0.95, grad_clip=0.5)

# the columns PPO's SGD reads
PPO_KEYS = (SampleBatch.OBS, SampleBatch.ACTIONS, SampleBatch.ACTION_LOGP,
            SampleBatch.ADVANTAGES, SampleBatch.VALUE_TARGETS)


def normalize(adv: torch.Tensor) -> torch.Tensor:
    """``(adv - mean) / (std + 1e-8)`` with the population std, as
    ``jnp.std`` computes it."""
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


def entropy_of(logp_all: torch.Tensor) -> torch.Tensor:
    """Mean entropy of the categoricals of ``logp_all`` [B, A]."""
    return -(logp_all.exp() * logp_all).sum(dim=-1).mean()


def make_ppo_loss(clip_param: float, vf_clip_param: float,
                  vf_loss_coeff: float, entropy_coeff: float):
    """``loss(module, params, batch) -> (total, metrics)``, the forward
    routed through the policy's RLModule."""

    def loss(module, params, batch):
        out = module.forward_train(params, batch[SampleBatch.OBS])
        logp_all, logp = gather_logp(out[Columns.ACTION_DIST_INPUTS], batch[SampleBatch.ACTIONS])
        old_logp = batch[SampleBatch.ACTION_LOGP]
        adv = normalize(batch[SampleBatch.ADVANTAGES])

        ratio = torch.exp(logp - old_logp)
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1 - clip_param, 1 + clip_param) * adv
        policy_loss = -torch.minimum(surr1, surr2).mean()

        vf_err = torch.square(out[Columns.VF_PREDS] - batch[SampleBatch.VALUE_TARGETS])
        vf_loss = torch.clamp(vf_err, max=vf_clip_param ** 2).mean()

        entropy = entropy_of(logp_all)
        total = policy_loss + vf_loss_coeff * vf_loss - entropy_coeff * entropy
        return total, {"policy_loss": policy_loss, "vf_loss": vf_loss, "entropy": entropy,
                       "kl": (old_logp - logp).mean()}

    return loss


def _ppo_loss_factory(config: Dict[str, Any]):
    """The loss from a config dict (``RolloutWorker`` calls it to attach
    the loss at policy construction)."""
    return make_ppo_loss(config["clip_param"], config["vf_clip_param"],
                         config["vf_loss_coeff"], config["entropy_coeff"])


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=PPO)
        self._config.update(_loss_factory=_ppo_loss_factory, **PPO_DEFAULTS)


class PPO(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        super().setup(config)
        # the local worker's policy was built with the loss: it is the learner
        self._sgd_rng = np.random.default_rng(self.config.get("seed", 0))

    def training_step(self) -> Dict[str, Any]:
        """Synchronous parallel sampling to ``train_batch_size``, then the
        clipped objective's minibatch SGD, then the weight broadcast."""
        cfg = self.config
        self.workers.sync_weights()
        batch = synchronous_parallel_sample(self.workers, max_env_steps=cfg["train_batch_size"])
        self._timesteps_total += batch.count
        learner_metrics = train_one_step(
            self.workers.local_worker.policy, batch, num_sgd_iter=cfg["num_sgd_iter"],
            sgd_minibatch_size=cfg["sgd_minibatch_size"], rng=self._sgd_rng,
            required_keys=PPO_KEYS)
        return {"info": {"learner": learner_metrics}}


# set after the class exists (PPOConfig's __init__ names PPO)
PPO._default_config = PPOConfig().to_dict()
