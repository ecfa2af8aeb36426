"""ray_tpu_torch.rllib: reinforcement learning on PyTorch and the port's
runtime.

Counterpart of ``ray_tpu/rllib/``: ``Algorithm``/``AlgorithmConfig`` as
Trainables, remote ``RolloutWorker`` actors gathered in a ``WorkerSet``,
``SampleBatch`` columns, GAE postprocessing, and the algorithm families
PPO, A2C, IMPALA (V-trace), APPO (IMPALA's async sampling with PPO's
objective), DQN (replay and a target net) and SAC (continuous control),
multi-agent PPO over ``MultiAgentEnv``s, with vectorized envs, greedy
evaluation and offline JSON IO.  The
``PolicyServer`` holds a policy on a card for every rollout worker, with
the frame-stack transport.  Env<->policy preprocessing is composable
``connectors`` pipelines, and models plug in through ``RLModule``.
"""

from ray_tpu_torch.rllib import connectors
from ray_tpu_torch.rllib.a2c import A2C, A2CConfig, make_a2c_loss
from ray_tpu_torch.rllib.algorithm import (
    Algorithm,
    AlgorithmConfig,
    synchronous_parallel_sample,
    train_one_step,
)
from ray_tpu_torch.rllib.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig, DQNPolicy, make_dqn_loss
from ray_tpu_torch.rllib.envs import SyntheticAtariEnv, synthetic_atari_creator
from ray_tpu_torch.rllib.impala import Impala, ImpalaConfig, compute_vtrace, make_impala_loss
from ray_tpu_torch.rllib.multi_agent import (
    MultiAgentBatch,
    MultiAgentEnv,
    MultiAgentPPO,
    MultiAgentPPOConfig,
    MultiAgentRolloutWorker,
)
from ray_tpu_torch.rllib.offline import JsonReader, JsonWriter
from ray_tpu_torch.rllib.policy import TorchPolicy, bind_loss
from ray_tpu_torch.rllib.policy_server import PolicyServer, RemotePolicy, serve_policy
from ray_tpu_torch.rllib.postprocessing import compute_gae
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig, make_ppo_loss
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.rl_module import Columns, DefaultActorCriticModule, RLModule
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker
from ray_tpu_torch.rllib.sac import SAC, SACConfig, SACPolicy
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.rllib.worker_set import WorkerSet

__all__ = [
    "Algorithm",
    "AlgorithmConfig",
    "connectors",
    "RLModule",
    "DefaultActorCriticModule",
    "Columns",
    "PPO",
    "PPOConfig",
    "A2C",
    "A2CConfig",
    "Impala",
    "ImpalaConfig",
    "APPO",
    "APPOConfig",
    "compute_vtrace",
    "DQN",
    "DQNConfig",
    "DQNPolicy",
    "SAC",
    "SACConfig",
    "SACPolicy",
    "ReplayBuffer",
    "JsonReader",
    "JsonWriter",
    "TorchPolicy",
    "bind_loss",
    "make_ppo_loss",
    "make_a2c_loss",
    "make_impala_loss",
    "make_dqn_loss",
    "RolloutWorker",
    "MultiAgentBatch",
    "MultiAgentEnv",
    "MultiAgentPPO",
    "MultiAgentPPOConfig",
    "MultiAgentRolloutWorker",
    "WorkerSet",
    "SampleBatch",
    "compute_gae",
    "synchronous_parallel_sample",
    "train_one_step",
    "SyntheticAtariEnv",
    "synthetic_atari_creator",
    "PolicyServer",
    "RemotePolicy",
    "serve_policy",
]
