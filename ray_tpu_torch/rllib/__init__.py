"""ray_tpu_torch.rllib: the RLlib learner stack on PyTorch, without the
runtime.

Counterpart of ``ray_tpu/rllib/``'s modules that need no runtime: the
model catalog (``models``), ``RLModule``, ``TorchPolicy`` (``policy``),
the PPO, A2C, IMPALA and DQN losses, the DQN and SAC policies,
``train_one_step`` (``algorithm``), the local ``RolloutWorker`` with its
connector pipelines, and the port's own copies of the numpy modules
(``SampleBatch``, ``compute_gae``, ``ReplayBuffer``,
``SyntheticAtariEnv``).  A local learner is a ``RolloutWorker`` whose
policy carries a loss, sampled and then trained with ``train_one_step``.
``Algorithm`` with its configs, the ``WorkerSet``, APPO, the
PolicyServer, multi-agent and offline IO need the runtime and are not
ported yet.
"""

from ray_tpu_torch.rllib import connectors
from ray_tpu_torch.rllib.a2c import make_a2c_loss
from ray_tpu_torch.rllib.algorithm import train_one_step
from ray_tpu_torch.rllib.dqn import DQNPolicy, make_dqn_loss
from ray_tpu_torch.rllib.envs import SyntheticAtariEnv, synthetic_atari_creator
from ray_tpu_torch.rllib.impala import compute_vtrace, make_impala_loss
from ray_tpu_torch.rllib.policy import TorchPolicy, bind_loss
from ray_tpu_torch.rllib.postprocessing import compute_gae
from ray_tpu_torch.rllib.ppo import make_ppo_loss
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.rl_module import Columns, DefaultActorCriticModule, RLModule
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker
from ray_tpu_torch.rllib.sac import SACPolicy
from ray_tpu_torch.rllib.sample_batch import SampleBatch

__all__ = [
    "connectors",
    "Columns",
    "RLModule",
    "DefaultActorCriticModule",
    "TorchPolicy",
    "bind_loss",
    "DQNPolicy",
    "SACPolicy",
    "make_ppo_loss",
    "make_a2c_loss",
    "make_impala_loss",
    "make_dqn_loss",
    "compute_vtrace",
    "compute_gae",
    "train_one_step",
    "RolloutWorker",
    "ReplayBuffer",
    "SampleBatch",
    "SyntheticAtariEnv",
    "synthetic_atari_creator",
]
