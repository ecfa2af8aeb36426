"""IMPALA: V-trace targets and the importance-weighted policy-gradient
loss.

Counterpart of ``ray_tpu/rllib/impala.py``'s ``compute_vtrace`` (a numpy
copy, run on the host per episode segment) and ``make_impala_loss``.
``ImpalaConfig`` and ``Impala`` need ``Algorithm`` and are not ported yet.

V-trace recursion (from the IMPALA paper, computed per episode segment):
  delta_t = rho_t (r_t + gamma V(x_{t+1}) - V(x_t))
  vs_t    = V(x_t) + delta_t + gamma c_t (vs_{t+1} - V(x_{t+1}))
  pg_adv  = rho_t (r_t + gamma vs_{t+1} - V(x_t))
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

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
