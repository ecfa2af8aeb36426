"""A2C's loss: counterpart of ``ray_tpu/rllib/a2c.py``'s ``make_a2c_loss``
(vanilla policy gradient on normalized advantages, a value loss and an
entropy bonus).  ``A2CConfig`` and ``A2C`` need ``Algorithm`` and are not
ported yet."""

from __future__ import annotations

from typing import Any, Dict

import torch

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
