"""SAC: soft actor-critic for continuous control.

Counterpart of ``ray_tpu/rllib/sac.py``'s ``_squashed_sample`` and
``SACPolicy``: a squashed-Gaussian actor, twin Q networks with
Polyak-averaged targets, entropy-regularized objectives and automatic
temperature tuning against a target entropy of ``-act_dim``.  One update
is one backward over the sum of the critic, actor and temperature losses
and one Adam step over all params (optax's single chain), then the Polyak
update from the updated critics.  The gradient stops where the JAX
package's ``stop_gradient`` stands: the TD target, the critics inside the
actor's loss, the temperature inside the actor's loss and the entropy
inside the temperature's.  ``SACConfig`` and ``SAC`` (the reference's
``sac.py``: sample, store to replay, updates from replay) drive it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig, synchronous_parallel_sample
from ray_tpu_torch.rllib.models import (
    apply_gaussian_actor,
    apply_q_network,
    init_gaussian_actor,
    init_q_network,
)
from ray_tpu_torch.rllib.policy import (
    adam_state,
    adam_update,
    copy_into,
    load_adam_state,
    make_adam,
    to_device,
    to_numpy,
)
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.util.tree import tree_map

_LOG_2PI = math.log(2.0 * math.pi)


def _squashed_sample(actor_params, obs: torch.Tensor, eps: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tanh-squashed action for the standard-normal draw ``eps`` [B, A],
    and its log-prob (change of variables)."""
    mean, log_std = apply_gaussian_actor(actor_params, obs)
    std = torch.exp(log_std)
    pre = mean + std * eps
    act = torch.tanh(pre)
    # Gaussian logp minus tanh Jacobian, summed over action dims
    logp = -0.5 * (((pre - mean) / std) ** 2 + 2.0 * log_std + _LOG_2PI).sum(dim=-1)
    logp = logp - (2.0 * (math.log(2.0) - pre - F.softplus(-2.0 * pre))).sum(dim=-1)
    return act, logp


class SACPolicy:
    """Continuous policy: actor + twin critics + temperature.

    The constructor takes what ``RolloutWorker`` passes a policy (obs_dim,
    num_actions=act_dim, lr, hiddens, seed, loss_fn unused, grad_clip), so
    SAC plugs into the same rollout machinery as the discrete learners.
    """

    def __init__(self, obs_dim: int, num_actions: int, *, lr=3e-4, hiddens=(64, 64), seed=0,
                 loss_fn=None, grad_clip=None, gamma=0.99, tau=0.005, initial_alpha=1.0,
                 device: DeviceLike = None, **_kw):
        del loss_fn
        self.device = resolve_device(device)
        self.obs_dim, self.act_dim = obs_dim, num_actions
        self.gamma, self.tau = gamma, tau
        g = torch.Generator().manual_seed(seed + 1)
        self.params = {
            "actor": init_gaussian_actor(g, obs_dim, num_actions, hiddens, device=self.device),
            "q1": init_q_network(g, obs_dim, num_actions, hiddens, device=self.device),
            "q2": init_q_network(g, obs_dim, num_actions, hiddens, device=self.device),
            "log_alpha": torch.tensor(math.log(initial_alpha), device=self.device),
        }
        self.target_q = tree_map(lambda t: t.detach().clone(),
                                 {"q1": self.params["q1"], "q2": self.params["q2"]})
        self.grad_clip = grad_clip
        self.optimizer = make_adam(self.params, lr)
        self.target_entropy = -float(num_actions)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _obs(self, x) -> torch.Tensor:
        return to_device(x, self.device)

    def _normal(self, n: int) -> torch.Tensor:
        return torch.randn(n, self.act_dim, generator=self.generator, device=self.device)

    # -- acting (RolloutWorker contract) --------------------------------
    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        obs_t = self._obs(obs).float()
        act, logp = _squashed_sample(self.params["actor"], obs_t, self._normal(len(obs_t)))
        vf = np.zeros(len(obs_t), np.float32)  # SAC has no V head; unused
        return act.cpu().numpy(), logp.cpu().numpy(), vf

    @torch.no_grad()
    def greedy_action(self, obs: np.ndarray) -> np.ndarray:
        mean, _ = apply_gaussian_actor(self.params["actor"], self._obs(obs).float())
        return torch.tanh(mean).cpu().numpy()

    def value(self, obs: np.ndarray) -> np.ndarray:
        return np.zeros(len(obs), np.float32)  # replay path never bootstraps here

    # -- learning --------------------------------------------------------
    def _losses(self, batch: Dict[str, torch.Tensor], eps_next: torch.Tensor,
                eps: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        p = self.params
        obs, act = batch[SampleBatch.OBS].float(), batch[SampleBatch.ACTIONS].float()
        next_obs = batch[SampleBatch.NEXT_OBS].float()
        done = batch[SampleBatch.TERMINATEDS].float()
        with torch.no_grad():  # targets from the frozen critics
            next_a, next_logp = _squashed_sample(p["actor"], next_obs, eps_next)
            tq = torch.minimum(apply_q_network(self.target_q["q1"], next_obs, next_a),
                               apply_q_network(self.target_q["q2"], next_obs, next_a))
            tq = tq - torch.exp(p["log_alpha"]) * next_logp
            q_target = batch[SampleBatch.REWARDS] + self.gamma * (1.0 - done) * tq
        q1 = apply_q_network(p["q1"], obs, act)
        q2 = apply_q_network(p["q2"], obs, act)
        critic_loss = ((q1 - q_target) ** 2).mean() + ((q2 - q_target) ** 2).mean()
        new_a, logp = _squashed_sample(p["actor"], obs, eps)
        a_det = torch.exp(p["log_alpha"].detach())
        frozen = tree_map(lambda t: t.detach(), {"q1": p["q1"], "q2": p["q2"]})
        q_pi = torch.minimum(apply_q_network(frozen["q1"], obs, new_a),
                             apply_q_network(frozen["q2"], obs, new_a))
        actor_loss = (a_det * logp - q_pi).mean()
        alpha_loss = -(p["log_alpha"] * (logp + self.target_entropy).detach()).mean()
        total = critic_loss + actor_loss + alpha_loss
        return total, {"critic_loss": critic_loss, "actor_loss": actor_loss,
                       "alpha_loss": alpha_loss, "alpha": a_det, "mean_q": q1.mean(),
                       "entropy": -logp.mean()}

    def learn_on_minibatch(self, batch: Dict[str, Any],
                           noise: Optional[Tuple[Any, Any]] = None) -> Dict[str, float]:
        """One update.  ``noise`` is the two standard-normal draws [B, A]
        (for the next observations' actions, then the observations'); by
        default they come from the policy's generator."""
        tb = {k: self._obs(v) for k, v in batch.items()}
        n = len(tb[SampleBatch.OBS])
        eps_next, eps = ((self._normal(n), self._normal(n)) if noise is None
                         else (self._obs(noise[0]), self._obs(noise[1])))
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self._losses(tb, eps_next, eps)
        loss.backward()
        adam_update(self.optimizer, self.grad_clip)
        with torch.no_grad():  # Polyak, from the updated critics
            tree_map(lambda t, s: t.mul_(1.0 - self.tau).add_(s, alpha=self.tau),
                     self.target_q, {"q1": self.params["q1"], "q2": self.params["q2"]})
        vals = torch.stack([loss.detach(), *(m.detach() for m in metrics.values())]).tolist()
        return dict(zip(["total_loss", *metrics], vals))

    # -- weights ---------------------------------------------------------
    def get_weights(self):
        return to_numpy(self.params)

    def set_weights(self, weights) -> None:
        copy_into(self.params, weights)

    def get_state(self) -> Dict[str, Any]:
        return {"weights": self.get_weights(), "target_q": to_numpy(self.target_q),
                "opt_state": adam_state(self.optimizer, self.params)}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.set_weights(state["weights"])
        if state.get("target_q") is not None:
            copy_into(self.target_q, state["target_q"])
        if state.get("opt_state") is not None:
            load_adam_state(self.optimizer, self.params, state["opt_state"])


def _sac_policy_kwargs(config: Dict[str, Any]) -> Dict[str, Any]:
    return {"gamma": config["gamma"], "tau": config["tau"]}


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=SAC)
        self._config.update(
            _policy_class=SACPolicy,
            _policy_kwargs_factory=_sac_policy_kwargs,
            _store_next_obs=True,
            lr=3e-4,
            gamma=0.99,
            tau=0.005,
            train_batch_size=256,
            replay_buffer_capacity=100_000,
            learning_starts=500,
            timesteps_per_iteration=500,
            updates_per_iteration=250,
            grad_clip=None,
            rollout_fragment_length=100,
        )


class SAC(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        super().setup(config)
        self.replay = ReplayBuffer(self.config["replay_buffer_capacity"],
                                   seed=self.config.get("seed") or 0)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        if self.reader is not None:
            batch = self._read_offline(cfg["timesteps_per_iteration"])
        else:
            self.workers.sync_weights()
            batch = synchronous_parallel_sample(self.workers,
                                                max_env_steps=cfg["timesteps_per_iteration"])
        self._timesteps_total += batch.count
        self.replay.add_batch(batch)

        policy: SACPolicy = self.workers.local_worker.policy
        learner_metrics: Dict[str, Any] = {}
        if len(self.replay) >= cfg["learning_starts"]:
            for _ in range(cfg["updates_per_iteration"]):
                mb = self.replay.sample(cfg["train_batch_size"])
                learner_metrics = policy.learn_on_minibatch({
                    k: mb[k] for k in (SampleBatch.OBS, SampleBatch.ACTIONS,
                                       SampleBatch.REWARDS, SampleBatch.TERMINATEDS,
                                       SampleBatch.NEXT_OBS)})
        learner_metrics["replay_size"] = len(self.replay)
        return {"info": {"learner": learner_metrics}}


SAC._default_config = SACConfig().to_dict()
