"""Algorithm / AlgorithmConfig: the RLlib training driver.

Counterpart of ``ray_tpu/rllib/algorithm.py`` (the reference's
``algorithm.py:142``, a Tune Trainable whose ``step`` runs
``training_step`` and gathers rollout metrics, and
``algorithm_config.py:112``, the fluent builder).  An Algorithm owns a
:class:`~ray_tpu_torch.rllib.worker_set.WorkerSet`; subclasses implement
``training_step()`` (sample, SGD, sync).

The config names its devices, and nothing falls back: the learner's
policy lives on ``resources(device=...)`` (the card when unset), and each
remote rollout worker on a share of a card, ``num_gpus_per_worker``
(default 0: the CPU).  Offline IO (``offline_data``): ``output`` makes
every rollout worker write its fragments as JSON lines, and ``input_``
feeds replay-based learners from such files (``offline.py``).
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, Optional, Type

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch._private import events
from ray_tpu_torch.rllib.policy import to_device
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.rllib.worker_set import WorkerSet
from ray_tpu_torch.tune.trainable import Trainable


class AlgorithmConfig:
    """Fluent config builder (``algorithm_config.py:112``)."""

    def __init__(self, algo_class: Optional[Type["Algorithm"]] = None):
        self.algo_class = algo_class
        self._config: Dict[str, Any] = {
            "env": None,
            "env_creator": None,
            "env_config": {},
            "num_rollout_workers": 0,
            "num_cpus_per_worker": 1,
            # the cards (or share of one) each remote rollout worker asks
            # for; 0 builds its policy on the CPU
            "num_gpus_per_worker": 0,
            # the learner's (local worker's) device; None is the card
            "device": None,
            "rollout_fragment_length": 200,
            "num_envs_per_worker": 1,
            "train_batch_size": 4000,
            "evaluation_interval": 0,  # 0 = never
            "evaluation_num_episodes": 5,
            "input": None,
            "output": None,
            "gamma": 0.99,
            "lr": 5e-4,
            "fcnet_hiddens": (64, 64),
            "seed": 0,
            "framework": "torch",
            # env<->policy transform pipelines (rllib/connectors); None =
            # defaults derived from the spaces; "observation_filter"
            # appends running-stat normalization to the default pipeline
            "agent_connectors": None,
            "action_connectors": None,
            "observation_filter": None,
            # RLModule plugin: factory(ConnectorContext) -> RLModule
            "_rl_module_factory": None,
        }

    # -- fluent sections (reference section names) ---------------------
    def environment(self, env: Optional[str] = None, *, env_creator=None,
                    env_config: Optional[Dict] = None) -> "AlgorithmConfig":
        if env is not None:
            self._config["env"] = env
        if env_creator is not None:
            self._config["env_creator"] = env_creator
        if env_config is not None:
            self._config["env_config"] = env_config
        return self

    def rollouts(self, *, num_rollout_workers: Optional[int] = None,
                 rollout_fragment_length: Optional[int] = None,
                 num_envs_per_worker: Optional[int] = None) -> "AlgorithmConfig":
        if num_rollout_workers is not None:
            self._config["num_rollout_workers"] = num_rollout_workers
        if rollout_fragment_length is not None:
            self._config["rollout_fragment_length"] = rollout_fragment_length
        if num_envs_per_worker is not None:
            self._config["num_envs_per_worker"] = num_envs_per_worker
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        self._config.update(kwargs)
        return self

    def resources(self, *, num_cpus_per_worker: Optional[float] = None,
                  num_gpus_per_worker: Optional[float] = None,
                  device: DeviceLike = None) -> "AlgorithmConfig":
        """The remote rollout workers' CPUs and cards (a share of one, or
        whole cards; 0 puts their policies on the CPU) and the learner's
        ``device`` (the card when unset)."""
        if num_cpus_per_worker is not None:
            self._config["num_cpus_per_worker"] = num_cpus_per_worker
        if num_gpus_per_worker is not None:
            self._config["num_gpus_per_worker"] = num_gpus_per_worker
        if device is not None:
            self._config["device"] = str(device)
        return self

    def framework(self, framework: str = "torch") -> "AlgorithmConfig":
        if framework != "torch":
            raise ValueError("only framework='torch' is supported")
        return self

    def connectors(self, *, agent_connectors=None, action_connectors=None,
                   observation_filter: Optional[str] = None) -> "AlgorithmConfig":
        """Compose the env<->policy transform pipelines: a list of
        connector instances, ``(name, kwargs)`` pairs or a factory
        ``fn(ctx) -> connectors``; ``observation_filter="MeanStdFilter"``
        appends running-stat normalization to the default pipeline."""
        if agent_connectors is not None:
            self._config["agent_connectors"] = agent_connectors
        if action_connectors is not None:
            self._config["action_connectors"] = action_connectors
        if observation_filter is not None:
            self._config["observation_filter"] = observation_filter
        return self

    def rl_module(self, module_factory) -> "AlgorithmConfig":
        """Plug a model in without subclassing Policy:
        ``module_factory(ctx: ConnectorContext) -> RLModule`` builds the
        network every policy (rollout workers, learner, PolicyServer)
        routes its forwards through."""
        self._config["_rl_module_factory"] = module_factory
        return self

    def evaluation(self, *, evaluation_interval: Optional[int] = None,
                   evaluation_num_episodes: Optional[int] = None) -> "AlgorithmConfig":
        if evaluation_interval is not None:
            self._config["evaluation_interval"] = evaluation_interval
        if evaluation_num_episodes is not None:
            self._config["evaluation_num_episodes"] = evaluation_num_episodes
        return self

    def offline_data(self, *, input_: Optional[str] = None,
                     output: Optional[str] = None) -> "AlgorithmConfig":
        """Offline IO (``rllib/offline``): ``output`` makes every rollout
        worker write its fragments as JSON lines; ``input_`` trains
        replay-based algorithms from recorded batches instead of an env."""
        if input_ is not None:
            self._config["input"] = input_
        if output is not None:
            self._config["output"] = output
        return self

    def debugging(self, *, seed: Optional[int] = None) -> "AlgorithmConfig":
        if seed is not None:
            self._config["seed"] = seed
        return self

    # -- materialize ---------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = copy.copy(self._config)
        d["_algo_class"] = self.algo_class
        return d

    def build(self) -> "Algorithm":
        if self.algo_class is None:
            raise ValueError("config has no algo_class; use e.g. PPOConfig()")
        return self.algo_class(config=self.to_dict())


class Algorithm(Trainable):
    """Tune-trainable RL driver (``algorithm.py:142``)."""

    _default_config: Dict[str, Any] = {}

    def __init__(self, config: Optional[Any] = None, **kwargs):
        if isinstance(config, AlgorithmConfig):
            config = config.to_dict()
        super().__init__(config, **kwargs)

    # -- Trainable hooks -----------------------------------------------
    def setup(self, config: Dict[str, Any]) -> None:
        from ray_tpu_torch._private.usage import record_feature
        record_feature("rllib")
        merged = dict(self._default_config)
        merged.update({k: v for k, v in config.items() if k != "_algo_class"})
        self.config = merged
        self.workers = WorkerSet(merged)
        self._timesteps_total = 0
        self._iteration_count = 0
        self.reader = None
        if merged.get("input"):
            from ray_tpu_torch.rllib.offline import JsonReader

            self.reader = JsonReader(merged["input"])

    def step(self) -> Dict[str, Any]:
        results = self.training_step()
        self._iteration_count += 1
        local = [self.workers.local_worker.get_metrics()]
        metrics = (self.workers.collect_metrics() + local if self.workers.remote_workers
                   else local)
        rews = [m["episode_reward_mean"] for m in metrics
                if not np.isnan(m["episode_reward_mean"])]
        lens = [m["episode_len_mean"] for m in metrics
                if not np.isnan(m["episode_len_mean"])]
        results.update({
            "episode_reward_mean": float(np.mean(rews)) if rews else np.nan,
            "episode_len_mean": float(np.mean(lens)) if lens else np.nan,
            "episodes_total": int(sum(m["episodes_total"] for m in metrics)),
            "timesteps_total": self._timesteps_total,
        })
        interval = self.config.get("evaluation_interval") or 0
        if interval and self._iteration_count % interval == 0:
            results["evaluation"] = self.evaluate()
        return results

    def evaluate(self) -> Dict[str, Any]:
        """Greedy episodes on a fresh env (``Algorithm.evaluate``)."""
        return self.workers.local_worker.evaluate_episodes(
            int(self.config.get("evaluation_num_episodes", 5)))

    def _read_offline(self, min_env_steps: int) -> SampleBatch:
        """Recorded batches from ``config["input"]``, at least
        ``min_env_steps`` transitions (the offline-training sampling seam)."""
        parts, total = [], 0
        while total < min_env_steps:
            b = self.reader.next()
            if b.count == 0:
                continue
            parts.append(b)
            total += b.count
        return SampleBatch.concat_samples(parts)

    def training_step(self) -> Dict[str, Any]:
        """Default: sample and do nothing (subclasses override)."""
        batch = self.workers.synchronous_parallel_sample()
        self.workers.sync_filters()
        self._timesteps_total += batch.count
        return {}

    def cleanup(self) -> None:
        self.workers.stop()

    # -- checkpointing (Trainable currency) ----------------------------
    def save_checkpoint(self) -> Dict:
        worker = self.workers.local_worker
        return {
            "policy_state": worker.policy.get_state(),
            "timesteps_total": self._timesteps_total,
            "config": {k: v for k, v in self.config.items()
                       if isinstance(v, (int, float, str, bool, tuple, list, dict, type(None)))},
            # connector pipelines (running-stat filters etc.) ride checkpoints
            "connector_state": worker.get_connector_state(),
        }

    def load_checkpoint(self, state: Dict) -> None:
        self.workers.local_worker.policy.set_state(state["policy_state"])
        if state.get("connector_state") is not None:
            self.workers.local_worker.set_connector_state(state["connector_state"])
            self.workers.sync_connectors()
        self._timesteps_total = state.get("timesteps_total", 0)
        self.workers.sync_weights()

    # -- inference ------------------------------------------------------
    def compute_single_action(self, obs, explore: bool = False,
                              episode_start: bool = False) -> int:
        """Greedy (or sampled) action for one observation.  Stateful
        connectors (frame stacks) track the caller's episode on the
        evaluation stream: pass ``episode_start=True`` on the first
        observation of each episode."""
        from ray_tpu_torch.rllib.rollout_worker import EVAL_ENV_ID

        worker = self.workers.local_worker
        policy = worker.policy
        if episode_start:
            worker.agent_connectors.reset(EVAL_ENV_ID)
        obs = worker._prep_obs(obs)[None]
        if explore:
            action, _, _ = policy.compute_actions(obs)
            return int(action[0])
        return int(np.asarray(policy.greedy_action(obs))[0])

    def get_policy(self):
        return self.workers.local_worker.policy


# -- execution ops (rollout_ops/train_ops as free functions) -------------

def synchronous_parallel_sample(worker_set: WorkerSet, *, max_env_steps: int) -> SampleBatch:
    """Sampling rounds until at least ``max_env_steps`` are collected
    (``execution/rollout_ops.py:21``); the remote workers' running-stat
    filters fold into the learner's pipelines once a call."""
    batches = []
    total = 0
    while total < max_env_steps:
        b = worker_set.synchronous_parallel_sample()
        batches.append(b)
        total += b.count
    worker_set.sync_filters()
    return SampleBatch.concat_samples(batches)


def sgd_epochs(policy, cols: Dict[str, torch.Tensor], *, num_sgd_iter: int,
               sgd_minibatch_size: int, rng: np.random.Generator) -> Dict[str, float]:
    """``num_sgd_iter`` epochs of ``policy.learn_on_minibatch`` over
    ``cols`` (tensors on the policy's device, one row a step), each epoch
    indexed there by ``rng.permutation``: the same minibatches, in the same
    order, as ``SampleBatch.minibatches(size, rng)`` gives the JAX
    package's learner (the ragged tail dropped).  Returns each metric's
    mean over the minibatches."""
    n = len(next(iter(cols.values())))
    device = next(iter(cols.values())).device
    mb_size = min(sgd_minibatch_size, n)
    metrics: Dict[str, float] = {}
    count = 0
    for _ in range(num_sgd_iter):
        perm = torch.from_numpy(rng.permutation(n)).to(device)
        for start in range(0, n - mb_size + 1, mb_size):
            idx = perm[start:start + mb_size]
            out = policy.learn_on_minibatch({k: v[idx] for k, v in cols.items()})
            for k, v in out.items():
                metrics[k] = metrics.get(k, 0.0) + v
            count += 1
    return {k: v / max(count, 1) for k, v in metrics.items()}


def train_one_step(
    policy,
    batch: SampleBatch,
    *,
    num_sgd_iter: int,
    sgd_minibatch_size: int,
    rng: np.random.Generator,
    required_keys: tuple,
) -> Dict[str, float]:
    """Minibatch SGD epochs over one train batch
    (``execution/train_ops.py:26``); returns each metric's mean over the
    minibatches.  A policy on a ``PolicyServer`` (``RemotePolicy``) gets
    the batch once, and every update runs on the server, from a seed drawn
    from ``rng``; a local policy gets the columns on its device once (see
    :func:`sgd_epochs`)."""
    t_wall = time.perf_counter()
    if hasattr(policy, "train_on_batch"):
        out = policy.train_on_batch(batch, num_sgd_iter=num_sgd_iter,
                                    sgd_minibatch_size=sgd_minibatch_size,
                                    required_keys=required_keys,
                                    seed=int(rng.integers(1 << 31)))
        events.emit("rllib", "learner train", entity_id="learner",
                    span_dur=time.perf_counter() - t_wall, env_steps=batch.count,
                    server_side=True)
        return out
    cols = {k: to_device(batch[k], policy.device) for k in required_keys}
    out = sgd_epochs(policy, cols, num_sgd_iter=num_sgd_iter,
                     sgd_minibatch_size=sgd_minibatch_size, rng=rng)
    events.emit("rllib", "learner train", entity_id="learner",
                span_dur=time.perf_counter() - t_wall, env_steps=batch.count)
    return out
