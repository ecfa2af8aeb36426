"""Multi-agent RL: MultiAgentEnv + per-policy mapping + multi-agent PPO.

Counterpart of ``ray_tpu/rllib/multi_agent.py``; the reference's
``rllib/env/multi_agent_env.py:30`` (the dict-keyed env API with
``"__all__"`` termination), per-policy training via the ``multiagent``
config (``policies`` + ``policy_mapping_fn``), and ``MultiAgentBatch``.  Each policy is an independent :class:`TorchPolicy`
(shared-policy setups map several agents onto one id); sampling groups
observations per policy so each tick is one batched forward per policy.
Every policy of a worker lives on the device the worker is given: the
learner's on ``resources(device=...)`` (the card when unset), a remote
worker's on its grant (``num_gpus_per_worker``), as ``RolloutWorker``'s.
"""

from __future__ import annotations

import copy
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.rllib.algorithm import Algorithm, train_one_step
from ray_tpu_torch.rllib.connectors import (
    ActionConnectorPipeline,
    AgentConnectorPipeline,
    ConnectorContext,
    DiscreteAction,
    NormalizeObs,
    build_pipeline,
    default_agent_connectors,
)
from ray_tpu_torch.rllib.policy import TorchPolicy
from ray_tpu_torch.rllib.postprocessing import compute_gae
from ray_tpu_torch.rllib.ppo import PPOConfig
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class MultiAgentEnv:
    """Base class for dict-keyed multi-agent environments
    (``multi_agent_env.py:30``).

    - ``reset() -> (obs_dict, info_dict)``
    - ``step(action_dict) -> (obs, rewards, terminateds, truncateds,
      infos)`` — all dicts keyed by agent id; ``terminateds``/``truncateds``
      carry the special ``"__all__"`` key ending the episode for everyone.
    - ``observation_space(agent_id)`` / ``action_space(agent_id)`` describe
      per-agent spaces.
    """

    agents: List[Any] = []

    def reset(self, *, seed: Optional[int] = None, options=None):
        raise NotImplementedError

    def step(self, action_dict: Dict):
        raise NotImplementedError

    def observation_space(self, agent_id):
        raise NotImplementedError

    def action_space(self, agent_id):
        raise NotImplementedError


class MultiAgentBatch:
    """Per-policy SampleBatches (``policy/sample_batch.py`` MultiAgentBatch
    analog).  ``count`` is SUMMED AGENT steps (a 2-agent tick counts 2) —
    size train_batch_size in agent steps, unlike the reference's
    env-step count."""

    def __init__(self, policy_batches: Dict[str, SampleBatch]):
        self.policy_batches = policy_batches

    @property
    def count(self) -> int:
        return sum(b.count for b in self.policy_batches.values())

    @staticmethod
    def concat_samples(batches: List["MultiAgentBatch"]) -> "MultiAgentBatch":
        merged: Dict[str, List[SampleBatch]] = {}
        for mb in batches:
            for pid, b in mb.policy_batches.items():
                merged.setdefault(pid, []).append(b)
        return MultiAgentBatch({
            pid: SampleBatch.concat_samples(parts)
            for pid, parts in merged.items()
        })


class _AgentTrail:
    """Per-agent column buffers within the running episode."""

    __slots__ = ("cols", "last_obs")

    def __init__(self, keys):
        self.cols: Dict[str, List] = {k: [] for k in keys}
        self.last_obs = None


class MultiAgentRolloutWorker:
    """Steps ONE MultiAgentEnv; groups per-policy forwards; GAE per agent
    trail (the multi-agent half of ``rollout_worker.py:153``)."""

    _KEYS = (
        SampleBatch.OBS, SampleBatch.ACTIONS, SampleBatch.REWARDS,
        SampleBatch.TERMINATEDS, SampleBatch.TRUNCATEDS, SampleBatch.EPS_ID,
        SampleBatch.ACTION_LOGP, SampleBatch.VF_PREDS,
    )

    def __init__(self, config: Dict[str, Any], worker_index: int = 0, *,
                 device: DeviceLike = None):
        self.config = config
        self.worker_index = worker_index
        ma = config["multiagent"]
        env_creator: Callable = config["env_creator"]
        self.env: MultiAgentEnv = env_creator(config.get("env_config", {}))
        self.mapping_fn: Callable = ma["policy_mapping_fn"]
        seed = int(config.get("seed") or 0) + worker_index

        loss_factory = config.get("_loss_factory")
        module_factory = config.get("_rl_module_factory")
        self.policies: Dict[str, TorchPolicy] = {}
        # per-policy connector pipelines (agents map onto their policy's
        # pipelines; episode state inside a pipeline is keyed by agent id,
        # so two agents sharing a policy never share a frame stack).
        # A config spec applies to every policy; None installs the same
        # defaults as the single-agent worker.
        self.agent_connectors: Dict[str, AgentConnectorPipeline] = {}
        self.action_connectors: Dict[str, ActionConnectorPipeline] = {}
        agent_spec = config.get("agent_connectors")
        action_spec = config.get("action_connectors")
        if not self.env.agents:
            raise ValueError(
                "MultiAgentEnv must list its agent ids in `.agents` at "
                "construction time (used to probe per-policy spaces)")
        for i, pid in enumerate(ma["policies"]):
            # probe spaces through any agent mapped to this policy
            agent = next((a for a in self.env.agents
                          if self.mapping_fn(a) == pid), None)
            if agent is None:
                raise ValueError(
                    f"policy {pid!r} has no agent mapped to it "
                    f"(agents: {self.env.agents}; check policy_mapping_fn)")
            obs_space = self.env.observation_space(agent)
            act_space = self.env.action_space(agent)
            obs_shape = tuple(obs_space.shape)
            ctx = ConnectorContext(
                obs_shape=obs_shape, obs_dim=int(np.prod(obs_shape)),
                num_actions=int(act_space.n), discrete=True, config=config)
            conv = len(obs_shape) == 3
            # per-policy deepcopy: a spec may carry connector INSTANCES,
            # and stateful ones (NormalizeObs) must not be shared across
            # policies with independent obs streams (or shapes)
            pipe = build_pipeline(
                AgentConnectorPipeline, ctx,
                copy.deepcopy(agent_spec)
                if isinstance(agent_spec, (list, tuple)) else agent_spec)
            if agent_spec is None:
                for c in default_agent_connectors(ctx, conv):
                    pipe.append(c)
                if config.get("observation_filter") == "MeanStdFilter":
                    # same knob as the single-agent worker
                    pipe.append(NormalizeObs())
            else:
                # an explicit pipeline may reshape the policy's input
                # (frame stacking); size the policy off a zeros probe
                probe = pipe(np.zeros(obs_shape, np.float32),
                             env_id="__probe__", training=False)
                pipe.reset("__probe__")
                ctx.obs_shape = tuple(probe.shape)
                ctx.obs_dim = int(np.prod(probe.shape))
            self.agent_connectors[pid] = pipe
            apipe = build_pipeline(
                ActionConnectorPipeline, ctx,
                copy.deepcopy(action_spec)
                if isinstance(action_spec, (list, tuple)) else action_spec)
            if action_spec is None:
                apipe.append(DiscreteAction())
            self.action_connectors[pid] = apipe
            self.policies[pid] = TorchPolicy(
                ctx.obs_dim,
                ctx.num_actions,
                lr=config.get("lr", 5e-4),
                hiddens=tuple(config.get("fcnet_hiddens", (64, 64))),
                seed=seed * 131 + i,
                loss_fn=loss_factory(config) if loss_factory else None,
                grad_clip=config.get("grad_clip", 0.5),
                obs_shape=ctx.obs_shape if len(ctx.obs_shape) == 3 else None,
                device=device,
                **({"module": module_factory(ctx)} if module_factory else {}),
            )
        self.gamma = config.get("gamma", 0.99)
        self.lambda_ = config.get("lambda_", 0.95)
        self.fragment_length = config.get("rollout_fragment_length", 200)

        self._obs, _ = self.env.reset(seed=seed)
        self._trails: Dict[Any, _AgentTrail] = {}
        # fragment-boundary obs already transformed with real episode
        # state; the next fragment's first tick reuses it (the
        # single-agent worker's ``prepped`` cache analog)
        self._boundary_prepped: Dict[Any, np.ndarray] = {}
        self._eps_id = worker_index * 1_000_000
        self._episode_reward = 0.0
        self._episode_len = 0
        self._episode_rewards: deque = deque(maxlen=100)
        self._episode_lengths: deque = deque(maxlen=100)
        self._episodes_total = 0
        self._total_steps = 0

    # -- helpers --------------------------------------------------------
    def _prep_for_policy(self, pid: str, obs) -> np.ndarray:
        """Single-obs inference path (``compute_single_action``): the
        policy's agent pipeline on a dedicated stream, statistics
        frozen."""
        return self.agent_connectors[pid](
            obs, env_id="__inference__", training=False)

    def _prep(self, agent, obs, training: bool = True) -> np.ndarray:
        """One obs through the agent's policy pipeline, episode state
        keyed by agent id."""
        return self.agent_connectors[self.mapping_fn(agent)](
            obs, env_id=agent, training=training)

    def _trail(self, agent) -> _AgentTrail:
        t = self._trails.get(agent)
        if t is None:
            t = self._trails[agent] = _AgentTrail(self._KEYS)
        return t

    # -- sampling -------------------------------------------------------
    def sample(self) -> MultiAgentBatch:
        segments: Dict[str, List[SampleBatch]] = {pid: [] for pid in self.policies}

        def close_trail(agent, trail, bootstrap: float):
            if not trail.cols[SampleBatch.OBS]:
                return
            pid = self.mapping_fn(agent)
            seg = SampleBatch({k: np.asarray(v) for k, v in trail.cols.items()})
            seg = compute_gae(seg, bootstrap, self.gamma, self.lambda_)
            segments[pid].append(seg)
            for v in trail.cols.values():
                v.clear()

        for _ in range(self.fragment_length):
            # group live agents by policy -> one batched forward per policy
            by_pid: Dict[str, List[Any]] = {}
            prepped: Dict[Any, np.ndarray] = {}
            for agent, obs in self._obs.items():
                by_pid.setdefault(self.mapping_fn(agent), []).append(agent)
                pre = self._boundary_prepped.pop(agent, None)
                prepped[agent] = self._prep(agent, obs) if pre is None else pre
            actions: Dict[Any, Any] = {}
            logps: Dict[Any, float] = {}
            vfs: Dict[Any, float] = {}
            for pid, agents in by_pid.items():
                batch = np.stack([prepped[a] for a in agents])
                acts, lps, vs = self.policies[pid].compute_actions(batch)
                for j, a in enumerate(agents):
                    actions[a] = acts[j]
                    logps[a] = lps[j]
                    vfs[a] = vs[j]
            prev_obs = self._obs
            obs, rewards, terms, truncs, _ = self.env.step({
                a: self.action_connectors[self.mapping_fn(a)](actions[a])
                for a in actions})
            all_term = bool(terms.get("__all__"))
            all_done = all_term or bool(truncs.get("__all__"))
            for agent in prev_obs:
                t = self._trail(agent)
                t.cols[SampleBatch.OBS].append(prepped[agent])
                t.cols[SampleBatch.ACTIONS].append(actions[agent])
                t.cols[SampleBatch.REWARDS].append(
                    np.float32(rewards.get(agent, 0.0)))
                # termination (no bootstrap) vs truncation (bootstrap
                # v(s_T)) — same split as the single-agent worker
                term = bool(terms.get(agent, False)) or all_term
                trunc = bool(truncs.get(agent, False)) or (all_done and not all_term)
                t.cols[SampleBatch.TERMINATEDS].append(term)
                t.cols[SampleBatch.TRUNCATEDS].append(trunc)
                t.cols[SampleBatch.EPS_ID].append(self._eps_id)
                t.cols[SampleBatch.ACTION_LOGP].append(np.float32(logps[agent]))
                t.cols[SampleBatch.VF_PREDS].append(np.float32(vfs[agent]))
                t.last_obs = obs.get(agent, prev_obs[agent])
                self._episode_reward += float(rewards.get(agent, 0.0))
                self._total_steps += 1
                if term or trunc:
                    bootstrap = 0.0 if term else self._bootstrap(agent, t.last_obs)
                    close_trail(agent, t, bootstrap)
                    # this agent's episode ended: fresh connector episode
                    # state (frame stacks) for its next life
                    self.agent_connectors[self.mapping_fn(agent)].reset(agent)
            self._episode_len += 1
            if all_done:
                for agent, t in self._trails.items():
                    close_trail(agent, t, 0.0 if all_term
                                else self._bootstrap(agent, t.last_obs))
                self._episode_rewards.append(self._episode_reward)
                self._episode_lengths.append(self._episode_len)
                self._episodes_total += 1
                self._episode_reward = 0.0
                self._episode_len = 0
                self._eps_id += 1
                self._obs, _ = self.env.reset()
                self._boundary_prepped.clear()
                for pipe in self.agent_connectors.values():
                    pipe.reset()
            else:
                self._obs = obs
        # fragment boundary: bootstrap open trails with v(current obs).
        # A live agent's boundary obs goes through its pipeline ONCE with
        # real episode state and is cached for the next fragment's first
        # tick — a training=False peek would still advance frame-stack
        # state, so the next fragment's _prep of the same obs would
        # duplicate the frame for the rest of the episode.
        for agent, t in self._trails.items():
            if t.cols[SampleBatch.OBS]:
                if agent in self._obs:
                    pre = self._prep(agent, self._obs[agent])
                    self._boundary_prepped[agent] = pre
                    pid = self.mapping_fn(agent)
                    boot = float(self.policies[pid].value(pre[None])[0])
                else:
                    # agent absent from the boundary obs dict: there is no
                    # new obs to transform, and re-pushing last_obs would
                    # duplicate a frame already in its connector episode
                    # state — bootstrap with the trail's own v(s_T) (the
                    # mid-fragment truncation convention in compute_gae)
                    boot = float(t.cols[SampleBatch.VF_PREDS][-1])
                close_trail(agent, t, boot)
        return MultiAgentBatch({
            pid: SampleBatch.concat_samples(parts)
            for pid, parts in segments.items() if parts
        })

    def _bootstrap(self, agent, obs) -> float:
        # training=False: the bootstrap peek must not double-count the
        # obs in running statistics (the sample loop already saw it or
        # will see it next fragment)
        pid = self.mapping_fn(agent)
        return float(self.policies[pid].value(
            self._prep(agent, obs, training=False)[None])[0])

    # -- WorkerSet surface ---------------------------------------------
    def get_metrics(self) -> Dict[str, Any]:
        rewards = list(self._episode_rewards)
        return {
            "episode_reward_mean": float(np.mean(rewards)) if rewards else np.nan,
            "episode_len_mean": (
                float(np.mean(self._episode_lengths))
                if self._episode_lengths else np.nan),
            "episodes_total": self._episodes_total,
            "worker_steps": self._total_steps,
        }

    def get_connector_state(self) -> Dict[str, Any]:
        return {
            "agent": {pid: p.to_state()
                      for pid, p in self.agent_connectors.items()},
            "action": {pid: p.to_state()
                       for pid, p in self.action_connectors.items()},
        }

    def set_connector_state(self, state: Dict[str, Any]) -> bool:
        # cached boundary transforms came from the replaced pipelines
        self._boundary_prepped.clear()
        for pid, s in state.get("agent", {}).items():
            self.agent_connectors[pid].set_state(s)
        for pid, s in state.get("action", {}).items():
            self.action_connectors[pid].set_state(s)
        return True

    # -- distributed filter sync (stats only; episode state untouched) --
    def pop_connector_stat_deltas(self):
        return {pid: p.pop_stat_deltas()
                for pid, p in self.agent_connectors.items()}

    def apply_connector_stat_deltas(self, deltas) -> bool:
        for pid, d in (deltas or {}).items():
            self.agent_connectors[pid].apply_stat_deltas(d)
        return True

    def get_connector_stat_states(self):
        return {pid: p.get_stat_states()
                for pid, p in self.agent_connectors.items()}

    def set_connector_stat_states(self, states) -> bool:
        for pid, s in (states or {}).items():
            self.agent_connectors[pid].set_stat_states(s)
        return True

    def get_weights(self) -> Dict[str, Any]:
        return {pid: p.get_weights() for pid, p in self.policies.items()}

    def set_weights(self, weights: Dict[str, Any]) -> bool:
        for pid, w in weights.items():
            self.policies[pid].set_weights(w)
        return True

    def set_global_vars(self, timesteps_total: int) -> bool:
        return True

    def evaluate_episodes(self, num_episodes: int,
                          max_steps_per_episode: int = 10_000) -> Dict[str, Any]:
        rewards = []
        for ep in range(num_episodes):
            obs, _ = self.env.reset(seed=977 + ep)
            # eval episodes must not inherit frame-stack residue from
            # training (ep 0) or the previous eval episode (ep 1..);
            # training episode state is rebuilt by the full reset below
            for pipe in self.agent_connectors.values():
                pipe.reset()
            total, steps = 0.0, 0
            while steps < max_steps_per_episode:
                acts = {}
                for agent, o in obs.items():
                    pid = self.mapping_fn(agent)
                    acts[agent] = self.action_connectors[pid](
                        self.policies[pid].greedy_action(
                            self._prep(agent, o, training=False)[None])[0])
                obs, rs, terms, truncs, _ = self.env.step(acts)
                total += float(sum(rs.values()))
                steps += 1
                if terms.get("__all__") or truncs.get("__all__"):
                    break
            rewards.append(total)
        # the shared env was disturbed: fresh training episode state
        self._obs, _ = self.env.reset()
        self._trails.clear()
        self._boundary_prepped.clear()
        for pipe in self.agent_connectors.values():
            pipe.reset()
        self._episode_reward = 0.0
        self._episode_len = 0
        return {"episode_reward_mean": float(np.mean(rewards)),
                "episodes_this_eval": num_episodes}

    def apply(self, fn_blob: bytes):
        import cloudpickle

        return cloudpickle.loads(fn_blob)(self)


class MultiAgentPPOConfig(PPOConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = MultiAgentPPO
        self._config.update(
            multiagent={"policies": {}, "policy_mapping_fn": None},
            _worker_class=MultiAgentRolloutWorker,
        )

    def multi_agent(self, *, policies, policy_mapping_fn) -> "MultiAgentPPOConfig":
        self._config["multiagent"] = {
            "policies": dict.fromkeys(policies),
            "policy_mapping_fn": policy_mapping_fn,
        }
        return self


class MultiAgentPPO(Algorithm):
    """PPO over per-policy batches: each policy runs clipped-surrogate SGD
    on its own agents' trajectories (the reference's multi-agent
    ``training_step`` over ``MultiAgentBatch``)."""

    def setup(self, config: Dict[str, Any]) -> None:
        super().setup(config)
        self._sgd_rng = np.random.default_rng(self.config.get("seed", 0))

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        self.workers.sync_weights()
        batches: List[MultiAgentBatch] = []
        total = 0
        while total < cfg["train_batch_size"]:
            b = self.workers.synchronous_parallel_sample()
            batches.append(b)
            total += b.count
        batch = MultiAgentBatch.concat_samples(batches)
        # remote workers' running-stat filters fold into the learner's
        # per-policy pipelines; no-op without stats
        self.workers.sync_filters()
        self._timesteps_total += batch.count
        learner: Dict[str, Dict[str, float]] = {}
        for pid, pb in batch.policy_batches.items():
            learner[pid] = train_one_step(
                self.workers.local_worker.policies[pid],
                pb,
                num_sgd_iter=cfg["num_sgd_iter"],
                sgd_minibatch_size=cfg["sgd_minibatch_size"],
                rng=self._sgd_rng,
                required_keys=(
                    SampleBatch.OBS, SampleBatch.ACTIONS,
                    SampleBatch.ACTION_LOGP, SampleBatch.ADVANTAGES,
                    SampleBatch.VALUE_TARGETS,
                ),
            )
        return {"info": {"learner": learner}}

    def save_checkpoint(self) -> Dict:
        worker = self.workers.local_worker
        return {
            "policy_state": {
                pid: p.get_state() for pid, p in worker.policies.items()
            },
            "connector_state": worker.get_connector_state(),
            "timesteps_total": self._timesteps_total,
        }

    def load_checkpoint(self, state: Dict) -> None:
        for pid, s in state["policy_state"].items():
            self.workers.local_worker.policies[pid].set_state(s)
        if state.get("connector_state") is not None:
            self.workers.local_worker.set_connector_state(
                state["connector_state"])
            self.workers.sync_connectors()
        self._timesteps_total = state.get("timesteps_total", 0)
        self.workers.sync_weights()

    def get_policy(self, policy_id: Optional[str] = None):
        policies = self.workers.local_worker.policies
        if policy_id is None:
            if len(policies) != 1:
                raise ValueError(
                    f"multiple policies {sorted(policies)}; pass policy_id")
            return next(iter(policies.values()))
        return policies[policy_id]

    def compute_single_action(self, obs, policy_id: Optional[str] = None,
                              explore: bool = False,
                              episode_start: bool = False) -> int:
        worker = self.workers.local_worker
        policies = worker.policies
        if policy_id is None and len(policies) == 1:
            policy_id = next(iter(policies))
        policy = self.get_policy(policy_id)
        if episode_start:
            # stateful connectors (frame stacks) track the caller's
            # episode on the shared inference stream — same contract as
            # the single-agent Algorithm.compute_single_action
            worker.agent_connectors[policy_id].reset("__inference__")
        # the worker's prep, so inference matches sampling exactly
        o = worker._prep_for_policy(policy_id, obs)
        if explore:
            action, _, _ = policy.compute_actions(o[None])
            return int(action[0])
        return int(policy.greedy_action(o[None])[0])


# set after the class exists (MultiAgentPPOConfig references MultiAgentPPO)
MultiAgentPPO._default_config = MultiAgentPPOConfig().to_dict()
