"""DQN: the Huber TD loss and the epsilon-greedy policy with a target
network.

Counterpart of ``ray_tpu/rllib/dqn.py``'s ``make_dqn_loss`` and
``DQNPolicy``.  The Q-network is the actor-critic's logits head.  The
exploration draws come from a numpy ``default_rng(seed)`` in the JAX
package's order, so for the same Q-values and seed both policies act
alike.  ``DQNConfig`` and ``DQN`` need ``Algorithm`` and are not ported
yet.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.policy import TorchPolicy
from ray_tpu_torch.rllib.rl_module import Columns
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.util.tree import tree_map


def make_dqn_loss():
    """Huber (delta 1) TD loss on Q(s, a) against precomputed targets (the
    target network's max is taken outside the loss, with frozen params)."""

    def loss(module, params, batch):
        q_all = module.forward_train(params, batch[SampleBatch.OBS])[Columns.ACTION_DIST_INPUTS]
        q = q_all.gather(-1, batch[SampleBatch.ACTIONS].long()[:, None])[:, 0]
        td = q - batch[SampleBatch.VALUE_TARGETS]
        abs_td = td.abs()
        loss_val = torch.where(abs_td <= 1.0, 0.5 * td ** 2, abs_td - 0.5).mean()
        return loss_val, {"mean_q": q.mean(), "mean_td_error": abs_td.mean()}

    return loss


def _dqn_loss_factory(config: Dict[str, Any]):
    return make_dqn_loss()


def _dqn_policy_kwargs(config: Dict[str, Any]) -> Dict[str, Any]:
    """The exploration schedule from a config dict to the policy."""
    return {"epsilon_timesteps": config["epsilon_timesteps"],
            "final_epsilon": config["final_epsilon"]}


class DQNPolicy(TorchPolicy):
    """Epsilon-greedy acting + a frozen target network for TD targets."""

    def __init__(self, *args, epsilon_timesteps: int = 10_000, final_epsilon: float = 0.02,
                 **kwargs):
        self._epsilon_timesteps = epsilon_timesteps
        self._final_epsilon = final_epsilon
        super().__init__(*args, **kwargs)
        self.target_params = tree_map(lambda t: t.detach().clone(), self.params)
        self._steps = 0
        self._np_rng = np.random.default_rng(kwargs.get("seed", 0) or 0)

    @property
    def epsilon(self) -> float:
        frac = min(1.0, self._steps / max(1, self._epsilon_timesteps))
        return 1.0 + frac * (self._final_epsilon - 1.0)

    def on_global_timestep(self, timesteps_total: int) -> None:
        """Anneal from the global count of sampled steps."""
        self._steps = int(timesteps_total)

    @torch.no_grad()
    def q_values(self, obs: np.ndarray, params: Any = None) -> torch.Tensor:
        """Q [B, A] on the device (``params`` defaults to the online net)."""
        return self.module.forward_train(self.params if params is None else params,
                                         self._obs(obs))[Columns.ACTION_DIST_INPUTS]

    def compute_actions(self, obs: np.ndarray):
        q = self.q_values(obs).cpu().numpy()
        greedy = np.argmax(q, axis=-1)
        explore = self._np_rng.random(len(greedy)) < self.epsilon
        random_a = self._np_rng.integers(0, self.num_actions, len(greedy))
        actions = np.where(explore, random_a, greedy)
        self._steps += len(greedy)
        # logp/vf columns keep the RolloutWorker contract; DQN ignores them
        logp = np.zeros(len(greedy), np.float32)
        return actions.astype(np.int64), logp, q.max(axis=-1).astype(np.float32)

    def value(self, obs: np.ndarray) -> np.ndarray:
        return self.q_values(obs).max(dim=-1).values.cpu().numpy()

    @torch.no_grad()
    def compute_td_targets(self, batch: SampleBatch, gamma: float) -> np.ndarray:
        """``r + gamma (1 - done) max_a Q_target(s', a)``."""
        q_next = self.q_values(batch[SampleBatch.NEXT_OBS], self.target_params)
        rewards = self._obs(batch[SampleBatch.REWARDS])
        dones = self._obs(batch[SampleBatch.TERMINATEDS].astype(np.float32))
        return (rewards + gamma * (1.0 - dones) * q_next.max(dim=-1).values).cpu().numpy()

    def update_target(self) -> None:
        with torch.no_grad():
            tree_map(lambda t, s: t.copy_(s), self.target_params, self.params)
