"""IMPALA: V-trace targets and the importance-weighted policy-gradient
loss.

Counterpart of ``ray_tpu/rllib/impala.py``: ``compute_vtrace`` (a numpy
copy, run on the host per episode segment), ``make_impala_loss``,
``ImpalaConfig`` and ``Impala``.  The rollout workers' behavior policies
lag the learner by one training step's SGD (the worker set samples
synchronously), which V-trace's clipped importance ratios correct.

V-trace recursion (from the IMPALA paper, computed per episode segment):
  delta_t = rho_t (r_t + gamma V(x_{t+1}) - V(x_t))
  vs_t    = V(x_t) + delta_t + gamma c_t (vs_{t+1} - V(x_{t+1}))
  pg_adv  = rho_t (r_t + gamma vs_{t+1} - V(x_t))
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import (
    Algorithm,
    AlgorithmConfig,
    synchronous_parallel_sample,
    train_one_step,
)
from ray_tpu_torch.rllib.policy import gather_logp
from ray_tpu_torch.rllib.ppo import entropy_of
from ray_tpu_torch.rllib.rl_module import Columns
from ray_tpu_torch.rllib.sample_batch import SampleBatch


def compute_vtrace(
    behavior_logp: np.ndarray,
    current_logp: np.ndarray,
    values: np.ndarray,          # V(x_t) under the CURRENT policy
    bootstrap_value: float,      # V(x_{T}) after the segment (0 if terminal)
    rewards: np.ndarray,
    gamma: float,
    rho_bar: float = 1.0,
    c_bar: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One contiguous segment -> (vs targets, pg advantages, clipped rho)."""
    T = len(rewards)
    rho = np.minimum(rho_bar, np.exp(current_logp - behavior_logp))
    c = np.minimum(c_bar, np.exp(current_logp - behavior_logp))
    v_next = np.append(values[1:], bootstrap_value)
    deltas = rho * (rewards + gamma * v_next - values)
    vs = np.zeros(T, np.float32)
    acc = 0.0  # vs_{t+1} - V(x_{t+1}), zero past the boundary
    for t in range(T - 1, -1, -1):
        acc = deltas[t] + gamma * c[t] * acc
        vs[t] = values[t] + acc
    vs_next = np.append(vs[1:], bootstrap_value)
    pg_adv = rho * (rewards + gamma * vs_next - values)
    return vs.astype(np.float32), pg_adv.astype(np.float32), rho.astype(np.float32)


def make_impala_loss(vf_loss_coeff: float, entropy_coeff: float):
    """Policy gradient with precomputed V-trace advantages (already
    rho-weighted, so NOT renormalized) + vs-target value loss."""

    def loss(module, params, batch):
        out = module.forward_train(params, batch[SampleBatch.OBS])
        logp_all, logp = gather_logp(out[Columns.ACTION_DIST_INPUTS], batch[SampleBatch.ACTIONS])
        pg_loss = -(logp * batch[SampleBatch.ADVANTAGES]).mean()
        vf_loss = torch.square(out[Columns.VF_PREDS] - batch[SampleBatch.VALUE_TARGETS]).mean()
        entropy = entropy_of(logp_all)
        total = pg_loss + vf_loss_coeff * vf_loss - entropy_coeff * entropy
        return total, {"policy_loss": pg_loss, "vf_loss": vf_loss, "entropy": entropy}

    return loss


def _impala_loss_factory(config: Dict[str, Any]):
    return make_impala_loss(config["vf_loss_coeff"], config["entropy_coeff"])


class ImpalaConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=Impala)
        self._config.update(
            _loss_factory=_impala_loss_factory,
            # V-trace needs raw transitions and the behavior policy's logp;
            # GAE columns would be computed from stale values
            _store_next_obs=True,
            _postprocess_gae=False,
            _keep_behavior_logp=True,
            lr=1e-3,
            train_batch_size=1000,
            minibatch_size=1000,
            vf_loss_coeff=0.5,
            entropy_coeff=0.01,
            vtrace_rho_clip=1.0,
            vtrace_c_clip=1.0,
            grad_clip=40.0,
        )


class Impala(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        super().setup(config)
        self._sgd_rng = np.random.default_rng(self.config.get("seed", 0))

    def _vtrace_batch(self, batch: SampleBatch) -> SampleBatch:
        """V-trace targets and policy-gradient advantages per contiguous
        segment, from the current learner policy (one forward over the
        whole batch, one over the segments' last next observations)."""
        cfg = self.config
        policy = self.workers.local_worker.policy
        obs = batch[SampleBatch.OBS]
        current_logp = policy.action_logp(obs, batch[SampleBatch.ACTIONS])
        values = policy.value(obs)
        terminateds = batch[SampleBatch.TERMINATEDS]
        truncateds = batch[SampleBatch.TRUNCATEDS]
        eps_id = batch[SampleBatch.EPS_ID]
        n = batch.count

        # segment boundaries: an episode's end or an eps_id change (a seam)
        bounds: List[Tuple[int, int]] = []
        start = 0
        for t in range(n):
            if (terminateds[t] or truncateds[t] or t == n - 1
                    or eps_id[t + 1] != eps_id[t]):
                bounds.append((start, t + 1))
                start = t + 1

        vs = np.empty(n, np.float32)
        pg_adv = np.empty(n, np.float32)
        boot_all = policy.value(batch[SampleBatch.NEXT_OBS][[e - 1 for _, e in bounds]])
        for (s, e), boot in zip(bounds, boot_all):
            bv = 0.0 if terminateds[e - 1] else float(boot)
            vs[s:e], pg_adv[s:e], _ = compute_vtrace(
                batch[SampleBatch.ACTION_LOGP][s:e], current_logp[s:e], values[s:e], bv,
                batch[SampleBatch.REWARDS][s:e], cfg["gamma"], cfg["vtrace_rho_clip"],
                cfg["vtrace_c_clip"])
        return SampleBatch({
            SampleBatch.OBS: obs,
            SampleBatch.ACTIONS: batch[SampleBatch.ACTIONS],
            SampleBatch.ADVANTAGES: pg_adv,
            SampleBatch.VALUE_TARGETS: vs,
            # the behavior logp rides along for losses with an importance
            # ratio (APPO's); IMPALA's required_keys drop it
            SampleBatch.ACTION_LOGP: batch[SampleBatch.ACTION_LOGP],
        })

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        self.workers.sync_weights()
        batch = synchronous_parallel_sample(self.workers, max_env_steps=cfg["train_batch_size"])
        self._timesteps_total += batch.count
        learner_metrics = train_one_step(
            self.workers.local_worker.policy, self._vtrace_batch(batch), num_sgd_iter=1,
            sgd_minibatch_size=cfg["minibatch_size"], rng=self._sgd_rng,
            required_keys=(SampleBatch.OBS, SampleBatch.ACTIONS, SampleBatch.ADVANTAGES,
                           SampleBatch.VALUE_TARGETS))
        return {"info": {"learner": learner_metrics}}


Impala._default_config = ImpalaConfig().to_dict()
