"""RolloutWorker: env stepping + trajectory postprocessing.

Counterpart of ``ray_tpu/rllib/rollout_worker.py``: it owns
``num_envs`` env instances stepped in lockstep (one batched
``compute_actions`` per tick), collects fixed-size sample fragments,
postprocesses each episode segment at its boundary (GAE for on-policy
learners; raw transitions for replay-based ones) with the bootstrap
values of a fragment in one batched ``value`` call, and exposes
get/set_weights.  It runs inline (the local worker) or as an actor of the
port's runtime (``num_rollout_workers > 0``).  The observation path is an
:class:`AgentConnectorPipeline` and the action path an
:class:`ActionConnectorPipeline` (``rllib/connectors/``); each raw
observation is transformed exactly once (cached per env as ``prepped``),
so stateful connectors see the true episode stream.

With a ``PolicyServer`` (``policy_server.py``) and
``_frame_stack_transport`` the worker ships only each env's newest frame
a tick, and the sample batch carries ``(worker, tick, env)`` references
to the server's stacks in place of pixels.  Each fragment emits a
``rollout sample`` span (env, inference, connector and postprocess
seconds) on the port's events plane, and keeps the same times in
``last_sample_phases``.  With ``output`` (``offline.py``) each fragment
is also written as one JSON line.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch._private import events
from ray_tpu_torch.rllib.connectors import (
    ActionConnectorPipeline,
    AgentConnectorPipeline,
    ConnectorContext,
    NormalizeObs,
    build_pipeline,
    default_action_connectors,
    default_agent_connectors,
)
from ray_tpu_torch.rllib.policy import TorchPolicy
from ray_tpu_torch.rllib.postprocessing import compute_gae
from ray_tpu_torch.rllib.sample_batch import SampleBatch

# the env_id stream used by evaluation / single-obs inference, so
# stateful connectors never mix it with training envs (0..num_envs-1)
EVAL_ENV_ID = -1


def _default_env_creator(env_name: str):
    import gymnasium as gym

    return gym.make(env_name)


class _EnvState:
    """Per-env rollout bookkeeping (column buffers + episode stats)."""

    __slots__ = ("env", "obs", "prepped", "cols", "episode_reward",
                 "episode_len", "eps_id")

    def __init__(self, env, obs, keys, eps_id):
        self.env = env
        self.obs = obs  # raw (the frame-stack transport reads raw frames)
        self.prepped = None  # connector-transformed, one transform per obs
        self.cols: Dict[str, List] = {k: [] for k in keys}
        self.episode_reward = 0.0
        self.episode_len = 0
        self.eps_id = eps_id


class RolloutWorker:
    """``config`` is the JAX package's config dict (``env`` or
    ``env_creator`` + ``env_config``, ``num_envs_per_worker``,
    ``rollout_fragment_length``, ``seed``, ``lr``, ``fcnet_hiddens``,
    ``grad_clip``, ``gamma``, ``lambda_``, ``_loss_factory``,
    ``_policy_class``, ``_policy_kwargs[_factory]``, ``_rl_module_factory``,
    ``_frame_stack_transport``, connector specs) with the port's factories
    and classes in it.  The policy lives on ``device`` (the card when
    None; raises when there is none); a ``RemotePolicy`` ignores it."""

    def __init__(self, config: Dict[str, Any], worker_index: int = 0, *,
                 device: DeviceLike = None):
        self.config = config
        self.worker_index = worker_index
        env_creator: Optional[Callable] = config.get("env_creator")
        self._make_env = (
            (lambda: env_creator(config.get("env_config", {})))
            if env_creator is not None
            else (lambda: _default_env_creator(config["env"]))
        )
        self.num_envs = max(1, int(config.get("num_envs_per_worker", 1)))
        probe_env = self._make_env()
        self.ctx = ConnectorContext.from_env(probe_env, config)
        self._obs_shape = self.ctx.obs_shape
        # an explicit agent pipeline may change the policy's input shape
        # (frame stacking widens it): probe it with zeros so the policy
        # sees the transformed shape
        agent_spec = config.get("agent_connectors")
        explicit_agent_pipe = None
        if agent_spec is not None:
            explicit_agent_pipe = build_pipeline(
                AgentConnectorPipeline, self.ctx, agent_spec)
            probe = explicit_agent_pipe(
                np.zeros(self._obs_shape, np.float32),
                env_id="__probe__", training=False)
            explicit_agent_pipe.reset("__probe__")
            self.ctx.obs_shape = tuple(probe.shape)
            self.ctx.obs_dim = int(np.prod(probe.shape))
        policy_obs_shape = self.ctx.obs_shape
        seed = int(config.get("seed") or 0) + worker_index

        loss_factory = config.get("_loss_factory")
        policy_cls = config.get("_policy_class") or TorchPolicy
        pk_factory = config.get("_policy_kwargs_factory")
        extra = (dict(pk_factory(config)) if pk_factory
                 else dict(config.get("_policy_kwargs") or {}))
        module_factory = config.get("_rl_module_factory")
        if module_factory is not None:
            extra.setdefault("module", module_factory(self.ctx))
        if len(policy_obs_shape) == 3 and policy_cls is TorchPolicy:
            # image observations -> the catalog's CNN; subclass policies
            # keep their own model choices
            extra.setdefault("obs_shape", policy_obs_shape)
        self.policy = policy_cls(
            self.ctx.obs_dim,
            self.ctx.num_actions,
            lr=config.get("lr", 5e-4),
            hiddens=tuple(config.get("fcnet_hiddens", (64, 64))),
            seed=seed,  # per-worker: decorrelates action sampling
            loss_fn=loss_factory(config) if loss_factory else None,
            grad_clip=config.get("grad_clip", 0.5),
            device=device,
            **extra,
        )
        # obs stay [H, W, C] only when the built policy carries a conv net
        # (or a custom module on an image env); flat-MLP policies on image
        # envs get flattened observations
        p = getattr(self.policy, "params", None)
        self._conv = (isinstance(p, dict) and "conv" in p) or (
            module_factory is not None and len(policy_obs_shape) == 3)
        if explicit_agent_pipe is not None:
            self.agent_connectors = explicit_agent_pipe
        else:
            self.agent_connectors = AgentConnectorPipeline(
                self.ctx, default_agent_connectors(self.ctx, self._conv))
            if config.get("observation_filter") == "MeanStdFilter":
                self.agent_connectors.append(NormalizeObs())
        self.action_connectors = build_pipeline(
            ActionConnectorPipeline, self.ctx, config.get("action_connectors"))
        if config.get("action_connectors") is None:
            for c in default_action_connectors(self.ctx):
                self.action_connectors.append(c)
        self._store_next_obs = bool(config.get("_store_next_obs"))
        # on-policy learners want GAE + behavior logp/vf columns; replay
        # learners want raw transitions; IMPALA wants transitions AND the
        # behavior policy's logp for V-trace importance ratios
        self._postprocess_gae = bool(
            config.get("_postprocess_gae", not self._store_next_obs))
        self._keep_behavior_logp = self._postprocess_gae or bool(
            config.get("_keep_behavior_logp"))
        # frame-stack transport: ship each env's newest frame instead of the
        # full stack; the pixels for training stay on the server's device.
        # It needs a remote policy with the stacked tick and channel-stacked
        # uint8 observations
        self._fst = bool(config.get("_frame_stack_transport")) and hasattr(
            self.policy, "compute_actions_stacked")
        if self._fst:
            # reference rows replace pixels in the obs column, so every
            # reader of obs as pixels is excluded: offline writers, replay
            # learners (next_obs) and V-trace's logp recompute
            if config.get("output") or self._store_next_obs or not self._postprocess_gae:
                raise ValueError(
                    "frame_stack_transport supports on-policy GAE learners (PPO/A2C) "
                    "without offline output: the obs column holds device-snapshot "
                    "references, not pixels")
            self.policy.start_rollout(worker_index, self.num_envs)
            self._reset_mask = np.ones((self.num_envs,), bool)
        self.gamma = config.get("gamma", 0.99)
        self.lambda_ = config.get("lambda_", 0.95)
        self.fragment_length = config.get("rollout_fragment_length", 200)

        keys = [
            SampleBatch.OBS, SampleBatch.ACTIONS, SampleBatch.REWARDS,
            SampleBatch.TERMINATEDS, SampleBatch.TRUNCATEDS, SampleBatch.EPS_ID,
        ]
        if self._store_next_obs:
            keys.append(SampleBatch.NEXT_OBS)
        if self._keep_behavior_logp:
            keys += [SampleBatch.ACTION_LOGP, SampleBatch.VF_PREDS]
        self._keys = keys

        self._eps_counter = worker_index * 1_000_000
        self._envs: List[_EnvState] = []
        for i in range(self.num_envs):
            env = probe_env if i == 0 else self._make_env()
            obs, _ = env.reset(seed=seed * 10_000 + i)
            es = _EnvState(env, obs, keys, self._next_eps_id())
            es.prepped = self.agent_connectors(obs, env_id=i)
            self._envs.append(es)
        self._episode_rewards: deque = deque(maxlen=100)
        self._episode_lengths: deque = deque(maxlen=100)
        self._episodes_total = 0
        self._total_steps = 0
        self.last_sample_phases: Dict[str, float] = {}
        self._writer = None
        if config.get("output"):
            from ray_tpu_torch.rllib.offline import JsonWriter

            self._writer = JsonWriter(config["output"], worker_index=worker_index)

    def _next_eps_id(self) -> int:
        self._eps_counter += 1
        return self._eps_counter

    def _prep_obs(self, o, env_id: Any = EVAL_ENV_ID, training: bool = False) -> np.ndarray:
        """One obs through the agent pipeline on the evaluation stream
        (statistics frozen, episode state apart from the training envs')."""
        return self.agent_connectors(o, env_id=env_id, training=training)

    def _env_action(self, action: np.ndarray):
        """Policy output -> what env.step accepts (the action pipeline)."""
        return self.action_connectors(action)

    # -- connector state ------------------------------------------------
    def get_connector_state(self) -> Dict[str, Any]:
        return {"agent": self.agent_connectors.to_state(),
                "action": self.action_connectors.to_state()}

    def set_connector_state(self, state: Dict[str, Any]) -> bool:
        self.agent_connectors.set_state(state["agent"])
        self.action_connectors.set_state(state["action"])
        # the rebuilt pipelines invalidate every cached transform: re-prep
        # each env's current obs on fresh episode state
        for i, es in enumerate(self._envs):
            self.agent_connectors.reset(i)
            es.prepped = (None if self._fst
                          else self.agent_connectors(es.obs, env_id=i, training=False))
        return True

    # -- distributed filter sync (statistics only; episode state untouched)
    def pop_connector_stat_deltas(self):
        return self.agent_connectors.pop_stat_deltas()

    def apply_connector_stat_deltas(self, deltas) -> bool:
        self.agent_connectors.apply_stat_deltas(deltas)
        return True

    def get_connector_stat_states(self):
        return self.agent_connectors.get_stat_states()

    def set_connector_stat_states(self, states) -> bool:
        self.agent_connectors.set_stat_states(states)
        return True

    # ------------------------------------------------------------------
    def sample(self) -> SampleBatch:
        """One fragment of ``num_envs * rollout_fragment_length`` steps,
        postprocessed per episode segment at its boundary; the bootstrap
        values (truncations and the fragment's end) come from one batched
        ``policy.value`` call at the end of the fragment.  Where the
        fragment's wall went is left in ``last_sample_phases``."""
        t_wall = time.perf_counter()
        phase = {"env_s": 0.0, "infer_s": 0.0, "connector_s": 0.0, "postprocess_s": 0.0}
        segments: List[SampleBatch] = []
        deferred: List = []  # (cols_snapshot, boot_prepped) awaiting v(s_T)

        def snapshot(es: _EnvState):
            seg_cols = {k: np.asarray(v) for k, v in es.cols.items()}
            for v in es.cols.values():
                v.clear()
            return seg_cols

        def close_terminal(es: _EnvState):
            if len(es.cols[SampleBatch.OBS]) == 0:
                return
            seg = SampleBatch(snapshot(es))
            if self._postprocess_gae:
                t0 = time.perf_counter()
                seg = compute_gae(seg, 0.0, self.gamma, self.lambda_)
                phase["postprocess_s"] += time.perf_counter() - t0
            segments.append(seg)

        def defer_bootstrap(es: _EnvState, boot_prepped):
            if len(es.cols[SampleBatch.OBS]) == 0:
                return
            deferred.append((snapshot(es), boot_prepped))

        def transform(o, i):
            t0 = time.perf_counter()
            out = self.agent_connectors(o, env_id=i)
            phase["connector_s"] += time.perf_counter() - t0
            return out

        for _ in range(self.fragment_length):
            t0 = time.perf_counter()
            if self._fst:
                # the newest channel only (uint8 [n, H, W]); the server holds
                # and advances the whole stacks on its device
                new_frames = np.stack([np.asarray(es.obs)[..., -1] for es in self._envs])
                actions, logps, vfs, tick = self.policy.compute_actions_stacked(
                    self.worker_index, new_frames, self._reset_mask)
                self._reset_mask[:] = False
                # [N, 3] (worker, tick, env) references stand in for pixels
                obs_batch = np.stack([np.array([self.worker_index, tick, i], np.int32)
                                      for i in range(self.num_envs)])
            else:
                obs_batch = np.stack([es.prepped for es in self._envs])
                actions, logps, vfs = self.policy.compute_actions(obs_batch)
            phase["infer_s"] += time.perf_counter() - t0
            for i, es in enumerate(self._envs):
                a = actions[i]
                t0 = time.perf_counter()
                next_obs, reward, terminated, truncated, _ = es.env.step(self._env_action(a))
                phase["env_s"] += time.perf_counter() - t0
                es.cols[SampleBatch.OBS].append(obs_batch[i])
                es.cols[SampleBatch.ACTIONS].append(a)
                es.cols[SampleBatch.REWARDS].append(np.float32(reward))
                es.cols[SampleBatch.TERMINATEDS].append(terminated)
                es.cols[SampleBatch.TRUNCATEDS].append(truncated)
                es.cols[SampleBatch.EPS_ID].append(es.eps_id)
                # transform next_obs once and reuse it (NEXT_OBS column,
                # truncation bootstrap, next tick's input); a terminal
                # step's obs is discarded by the reset, so it is not
                # transformed unless the learner reads NEXT_OBS
                next_prepped = None
                if not self._fst and (not terminated or self._store_next_obs):
                    next_prepped = transform(next_obs, i)
                if self._store_next_obs:
                    es.cols[SampleBatch.NEXT_OBS].append(next_prepped)
                if self._keep_behavior_logp:
                    es.cols[SampleBatch.ACTION_LOGP].append(np.float32(logps[i]))
                    es.cols[SampleBatch.VF_PREDS].append(np.float32(vfs[i]))
                es.episode_reward += float(reward)
                es.episode_len += 1
                self._total_steps += 1
                es.obs = next_obs
                es.prepped = next_prepped
                if terminated or truncated:
                    # terminal: no bootstrap; truncation: bootstrap v(s_T)
                    if terminated:
                        close_terminal(es)
                    else:
                        defer_bootstrap(es, next_prepped if next_prepped is not None
                                        else transform(next_obs, i))
                    self._episode_rewards.append(es.episode_reward)
                    self._episode_lengths.append(es.episode_len)
                    self._episodes_total += 1
                    es.episode_reward = 0.0
                    es.episode_len = 0
                    es.eps_id = self._next_eps_id()
                    es.obs, _ = es.env.reset()
                    # episode boundary: frame stacks et al. start fresh
                    self.agent_connectors.reset(i)
                    es.prepped = None if self._fst else transform(es.obs, i)
                    if self._fst:
                        self._reset_mask[i] = True
        # fragment ended mid-episode: bootstrap with v(current obs), already
        # transformed except on the frame-stack transport, where obs stay raw
        for i, es in enumerate(self._envs):
            defer_bootstrap(es, es.prepped if es.prepped is not None else transform(es.obs, i))
        if deferred:
            if self._postprocess_gae:
                t0 = time.perf_counter()
                boots = self.policy.value(np.stack([b for _, b in deferred]))
                phase["infer_s"] += time.perf_counter() - t0
                t0 = time.perf_counter()
                for (seg_cols, _), v in zip(deferred, boots):
                    segments.append(compute_gae(
                        SampleBatch(seg_cols), float(v), self.gamma, self.lambda_))
                phase["postprocess_s"] += time.perf_counter() - t0
            else:
                segments.extend(SampleBatch(c) for c, _ in deferred)
        batch = SampleBatch.concat_samples(segments)
        if self._writer is not None:
            self._writer.write(batch)
        wall = time.perf_counter() - t_wall
        self.last_sample_phases = {**phase, "wall_s": wall}
        events.emit("rllib", "rollout sample", entity_id=f"rollout-{self.worker_index}",
                    span_dur=wall, env_steps=batch.count,
                    **{k: round(v, 6) for k, v in phase.items()})
        return batch

    # ------------------------------------------------------------------
    def evaluate_episodes(self, num_episodes: int,
                          max_steps_per_episode: int = 10_000) -> Dict[str, Any]:
        """Greedy evaluation on a dedicated cached env; the step cap guards
        envs with no time limit.  Observations ride the agent pipeline on
        the evaluation stream (frozen statistics, own episode state)."""
        env = getattr(self, "_eval_env", None)
        if env is None:
            env = self._eval_env = self._make_env()
        rewards, lengths = [], []
        for ep in range(num_episodes):
            obs, _ = env.reset(seed=977 + ep)
            self.agent_connectors.reset(EVAL_ENV_ID)
            total, steps = 0.0, 0
            while steps < max_steps_per_episode:
                a = self.policy.greedy_action(self._prep_obs(obs)[None])[0]
                obs, r, term, trunc, _ = env.step(self._env_action(a))
                total += float(r)
                steps += 1
                if term or trunc:
                    break
            rewards.append(total)
            lengths.append(steps)
        self.agent_connectors.reset(EVAL_ENV_ID)
        return {
            "episode_reward_mean": float(np.mean(rewards)),
            "episode_len_mean": float(np.mean(lengths)),
            "episodes_this_eval": num_episodes,
        }

    # ------------------------------------------------------------------
    def get_metrics(self) -> Dict[str, Any]:
        rewards = list(self._episode_rewards)
        return {
            "episode_reward_mean": float(np.mean(rewards)) if rewards else np.nan,
            "episode_len_mean": (
                float(np.mean(self._episode_lengths)) if self._episode_lengths else np.nan),
            "episodes_total": self._episodes_total,
            "worker_steps": self._total_steps,
        }

    def set_global_vars(self, timesteps_total: int) -> bool:
        """Pin the policy's exploration schedule to global progress."""
        hook = getattr(self.policy, "on_global_timestep", None)
        if hook is not None:
            hook(timesteps_total)
        return True

    def get_weights(self):
        return self.policy.get_weights()

    def set_weights(self, weights) -> bool:
        self.policy.set_weights(weights)
        return True

    def apply(self, fn_blob: bytes):
        """Run a pickled ``fn(worker)`` (the reference's foreach_worker hook)."""
        import cloudpickle

        return cloudpickle.loads(fn_blob)(self)
