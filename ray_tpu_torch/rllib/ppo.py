"""PPO's clipped-surrogate loss.

Counterpart of ``ray_tpu/rllib/ppo.py``'s ``make_ppo_loss`` and
``_ppo_loss_factory``.  ``PPOConfig`` and ``PPO`` need ``Algorithm`` and
the runtime's worker set, which the port does not have yet; a local
learner is ``RolloutWorker`` + ``algorithm.train_one_step``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

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
