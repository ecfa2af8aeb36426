"""The port's multi-agent RL, on the CPU.

``test_rllib_multiagent.py``'s two multi-agent tests and
``test_rllib_connectors.py``'s three multi-agent connector tests by name,
with every policy on ``device="cpu"``; ``MultiAgentPPO.training_step``
from the JAX package's weights (``convert.from_jax_rl_state``, one state
per policy), fed the ``MultiAgentBatch``es the JAX local worker drew,
against the JAX package's: per policy the learner metrics and weights
within 1e-5 (f32), and the same summed agent-step count; and a remote
``MultiAgentRolloutWorker`` (``_worker_class``) on the runtime.

One runtime serves the remote-worker test (``init(num_cpus=4)``).  JAX is
imported inside the tests only: a remote worker that unpickles this
module's env imports the module.
"""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib import (
    MultiAgentBatch,
    MultiAgentEnv,
    MultiAgentPPOConfig,
    MultiAgentRolloutWorker,
    SampleBatch,
)
from ray_tpu_torch.rllib.connectors import NormalizeObs


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The learners' tensors are tiny: torch's intra-op threads only
    contend, with each other and with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runtime():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


class _Box:
    def __init__(self, shape):
        self.shape = shape


class _Discrete:
    def __init__(self, n):
        self.n = n


def _dual_cartpole(base):
    """Two independent CartPole instances inside one ``base``
    MultiAgentEnv (the port's or the JAX package's class): each agent
    balances its own pole; the episode ends when both are done."""

    class DualCartPole(base):
        agents = ["cart_0", "cart_1"]

        def __init__(self, _config=None):
            import gymnasium as gym

            self._envs = {a: gym.make("CartPole-v1") for a in self.agents}
            self._done = {a: False for a in self.agents}

        def observation_space(self, agent_id):
            return _Box(self._envs[agent_id].observation_space.shape)

        def action_space(self, agent_id):
            return _Discrete(int(self._envs[agent_id].action_space.n))

        def reset(self, *, seed=None, options=None):
            obs = {}
            for i, (a, env) in enumerate(self._envs.items()):
                o, _ = env.reset(seed=None if seed is None else seed + i)
                obs[a] = o
                self._done[a] = False
            return obs, {}

        def step(self, action_dict):
            obs, rewards, terms, truncs = {}, {}, {}, {}
            for a, act in action_dict.items():
                if self._done[a]:
                    continue
                o, r, term, trunc, _ = self._envs[a].step(int(act))
                rewards[a] = r
                terms[a] = term
                truncs[a] = trunc
                if term or trunc:
                    self._done[a] = True
                else:
                    obs[a] = o
            terms["__all__"] = all(self._done.values())
            truncs["__all__"] = False
            return obs, rewards, terms, truncs, {}

    return DualCartPole


DualCartPole = _dual_cartpole(MultiAgentEnv)


def _make_dual(cfg):
    return DualCartPole(cfg)


def _pid(agent_id):
    return f"p{agent_id[-1]}"


def test_multiagent_ppo_learns_dual_cartpole():
    config = (
        MultiAgentPPOConfig()
        .environment(env_creator=lambda cfg: DualCartPole(cfg))
        .rollouts(num_rollout_workers=0, rollout_fragment_length=200)
        .training(train_batch_size=800, sgd_minibatch_size=128,
                  num_sgd_iter=6, lr=3e-4, entropy_coeff=0.01)
        .multi_agent(
            policies=["p0", "p1"],
            policy_mapping_fn=lambda agent_id: f"p{agent_id[-1]}",
        )
        .resources(device="cpu")
        .debugging(seed=7)
    )
    algo = config.build()
    first = None
    best = -np.inf
    for _ in range(18):
        res = algo.step()
        r = res["episode_reward_mean"]
        if not np.isnan(r):
            if first is None:
                first = r
            best = max(best, r)
        assert set(res["info"]["learner"]) <= {"p0", "p1"}
    algo.cleanup()
    # combined reward of two fresh CartPoles starts ~40-60; learning must
    # push the (100-episode-window) mean well past the initial level
    assert first is not None
    assert best > first * 1.5 and best > 100, (first, best)


def test_multiagent_checkpoint_roundtrip():
    config = (
        MultiAgentPPOConfig()
        .environment(env_creator=lambda cfg: DualCartPole(cfg))
        .training(train_batch_size=300, sgd_minibatch_size=64, num_sgd_iter=2)
        .multi_agent(policies=["p0", "p1"],
                     policy_mapping_fn=lambda aid: f"p{aid[-1]}")
        .resources(device="cpu")
    )
    algo = config.build()
    algo.step()
    state = algo.save_checkpoint()
    assert set(state["policy_state"]) == {"p0", "p1"}
    algo2 = config.build()
    algo2.load_checkpoint(state)
    w1 = algo.workers.local_worker.policies["p0"].get_weights()
    w2 = algo2.workers.local_worker.policies["p0"].get_weights()
    np.testing.assert_allclose(w1["pi"][0]["w"], w2["pi"][0]["w"])
    algo.cleanup()
    algo2.cleanup()


def test_multi_agent_connector_passthrough():
    """Multi-agent sampling routes per-policy pipelines: defaults behave
    like the old hardwired prep, and a custom spec applies per agent."""

    class TwoAgentEnv(MultiAgentEnv):
        agents = ["a", "b"]

        def __init__(self, config=None):
            self._t = 0

        def reset(self, *, seed=None, options=None):
            self._t = 0
            return {a: np.zeros(3, np.float32) + 7.0 for a in self.agents}, {}

        def step(self, action_dict):
            assert all(isinstance(v, int) for v in action_dict.values())
            self._t += 1
            done = self._t >= 5
            obs = {a: np.zeros(3, np.float32) + 7.0 for a in self.agents}
            rew = {a: 1.0 for a in self.agents}
            return obs, rew, {"__all__": done}, {"__all__": False}, {}

        def observation_space(self, agent_id):
            return _Box((3,))

        def action_space(self, agent_id):
            return _Discrete(2)

    base = {
        "env_creator": lambda cfg: TwoAgentEnv(cfg),
        "multiagent": {"policies": {"shared": None},
                       "policy_mapping_fn": lambda a: "shared"},
        "rollout_fragment_length": 10,
        "fcnet_hiddens": (8,),
        "seed": 0,
    }
    w = MultiAgentRolloutWorker(dict(base), device="cpu")
    b = w.sample()
    assert b.policy_batches["shared"]["obs"].shape[1] == 3
    np.testing.assert_allclose(b.policy_batches["shared"]["obs"][0], 7.0)
    # per-policy custom pipeline: normalization applies to every agent
    w2 = MultiAgentRolloutWorker(dict(
        base, agent_connectors=[("flatten_obs", {}), ("normalize_obs", {})]), device="cpu")
    b2 = w2.sample()
    assert abs(float(b2.policy_batches["shared"]["obs"].mean())) < 7.0
    state = w2.get_connector_state()
    name, params = state["agent"]["shared"][-1]
    assert name == "normalize_obs" and params["n"] > 0
    w2.set_connector_state(state)


def test_multi_agent_filter_knob_and_instance_isolation():
    """observation_filter='MeanStdFilter' works for multi-agent too, and
    a spec carrying connector INSTANCES gets a per-policy deep copy —
    stateful connectors must not be shared across policies."""

    class TwoPolicyEnv(MultiAgentEnv):
        agents = ["a", "b"]

        def reset(self, *, seed=None, options=None):
            return {ag: np.zeros(3, np.float32) for ag in self.agents}, {}

        def step(self, action_dict):
            return ({ag: np.zeros(3, np.float32) for ag in self.agents},
                    {ag: 0.0 for ag in self.agents},
                    {"__all__": False}, {"__all__": False}, {})

        def observation_space(self, agent_id):
            return _Box((3,))

        def action_space(self, agent_id):
            return _Discrete(2)

    base = {
        "env_creator": lambda cfg: TwoPolicyEnv(),
        "multiagent": {"policies": {"p0": None, "p1": None},
                       "policy_mapping_fn": lambda a: "p0" if a == "a" else "p1"},
        "fcnet_hiddens": (8,),
        "seed": 0,
    }
    w = MultiAgentRolloutWorker(dict(base, observation_filter="MeanStdFilter"), device="cpu")
    n0 = w.agent_connectors["p0"].connectors[-1]
    n1 = w.agent_connectors["p1"].connectors[-1]
    assert isinstance(n0, NormalizeObs) and isinstance(n1, NormalizeObs)
    assert n0 is not n1
    w2 = MultiAgentRolloutWorker(dict(base, agent_connectors=[NormalizeObs()]), device="cpu")
    assert (w2.agent_connectors["p0"].connectors[0]
            is not w2.agent_connectors["p1"].connectors[0])


def test_multi_agent_frame_stack_no_boundary_double_push():
    """A fragment boundary's bootstrap peek must not advance frame-stack
    state twice: the boundary obs is transformed once and the next
    fragment's first tick reuses it, so every stacked row matches the
    true counter stream (a double push would duplicate the boundary
    frame for the rest of the episode)."""

    class CounterEnv(MultiAgentEnv):
        agents = ["a"]

        def __init__(self, config=None):
            self._t = 0

        def reset(self, *, seed=None, options=None):
            self._t = 0
            return {"a": np.array([0.0], np.float32)}, {}

        def step(self, action_dict):
            self._t += 1
            return ({"a": np.array([float(self._t)], np.float32)},
                    {"a": 0.0}, {"__all__": False}, {"__all__": False}, {})

        def observation_space(self, agent_id):
            return _Box((1,))

        def action_space(self, agent_id):
            return _Discrete(2)

    w = MultiAgentRolloutWorker({
        "env_creator": lambda cfg: CounterEnv(cfg),
        "multiagent": {"policies": {"shared": None},
                       "policy_mapping_fn": lambda a: "shared"},
        "agent_connectors": [("frame_stack_obs", {"num_frames": 2})],
        "rollout_fragment_length": 4,
        "fcnet_hiddens": (8,),
        "seed": 0,
    }, device="cpu")
    rows = np.concatenate([
        w.sample().policy_batches["shared"]["obs"],
        w.sample().policy_batches["shared"]["obs"]])
    # counter stream 0,1,2,... stacked pairwise: [t-1, t], the episode's
    # first frame repeated
    expected = np.array([[0, 0], [0, 1], [1, 2], [2, 3],
                         [3, 4], [4, 5], [5, 6], [6, 7]], np.float32)
    np.testing.assert_allclose(rows, expected)


def test_training_step_matches_jax():
    """Three ``MultiAgentPPO.training_step``s of each package from the same
    per-policy weights, on the JAX worker's ``MultiAgentBatch``es: per
    policy the learner metrics and weights agree within 1e-5, and the
    summed agent-step count is equal."""
    import jax

    import ray_tpu.rllib as jrl
    from ray_tpu_torch.convert import from_jax_rl_state
    from ray_tpu_torch.util.tree import tree_map

    jax_dual = _dual_cartpole(jrl.MultiAgentEnv)

    def build(cfg, env):
        return (cfg.environment(env_creator=lambda c: env(c))
                .rollouts(rollout_fragment_length=40)
                .training(train_batch_size=120, sgd_minibatch_size=32, num_sgd_iter=2,
                          entropy_coeff=0.01, fcnet_hiddens=(16,))
                .multi_agent(policies=["p0", "p1"], policy_mapping_fn=_pid)
                .debugging(seed=5))

    jalgo = build(jrl.MultiAgentPPOConfig(), jax_dual).build()
    talgo = build(MultiAgentPPOConfig(), DualCartPole).resources(device="cpu").build()
    jpols = jalgo.workers.local_worker.policies
    tpols = talgo.workers.local_worker.policies
    for pid in ("p0", "p1"):
        tpols[pid].set_state(from_jax_rl_state(jpols[pid].get_state(), device="cpu"))

    drawn = []
    jround = jalgo.workers.synchronous_parallel_sample

    def record():
        b = jround()
        drawn.append(MultiAgentBatch({
            pid: SampleBatch({k: np.array(v) for k, v in pb.items()})
            for pid, pb in b.policy_batches.items()}))
        return b

    jalgo.workers.synchronous_parallel_sample = record
    talgo.workers.synchronous_parallel_sample = lambda: drawn.pop(0)

    for step in range(3):
        want = jalgo.training_step()["info"]["learner"]
        got = talgo.training_step()["info"]["learner"]
        assert not drawn
        assert talgo._timesteps_total == jalgo._timesteps_total
        assert set(got) == set(want) == {"p0", "p1"}
        for pid in want:
            assert set(got[pid]) == set(want[pid])
            for k in want[pid]:
                np.testing.assert_allclose(got[pid][k], want[pid][k], atol=1e-5, rtol=1e-5,
                                           err_msg=f"step {step}: {pid} {k}")
            tree_map(lambda g, w: np.testing.assert_allclose(
                np.asarray(g), w, atol=1e-5, err_msg=f"step {step}: {pid} weights"),
                tpols[pid].get_weights(),
                jax.tree_util.tree_map(np.asarray, jpols[pid].get_weights()))
    assert talgo._timesteps_total >= 3 * 120
    jalgo.cleanup()
    talgo.cleanup()


def test_remote_multi_agent_workers(runtime):
    """``_worker_class`` puts a ``MultiAgentRolloutWorker`` on every remote
    seat: a step samples there (its policies on the CPU, as its grant
    says), merges the ``MultiAgentBatch``es and pushes both policies'
    weights back."""
    algo = (MultiAgentPPOConfig()
            .environment(env_creator=_make_dual)
            .rollouts(num_rollout_workers=2, rollout_fragment_length=50)
            .training(train_batch_size=200, sgd_minibatch_size=64, num_sgd_iter=1,
                      fcnet_hiddens=(16,))
            .multi_agent(policies=["p0", "p1"], policy_mapping_fn=_pid)
            .resources(device="cpu")
            .debugging(seed=0).build())
    try:
        r = algo.train()
        assert set(r["info"]["learner"]) == {"p0", "p1"}
        assert r["timesteps_total"] >= 200
        algo.workers.sync_weights()
        remote = ray_tpu_torch.get(algo.workers.remote_workers[0].get_weights.remote(),
                                   timeout=60)
        local = algo.workers.local_worker.get_weights()
        for pid in ("p0", "p1"):
            np.testing.assert_array_equal(remote[pid]["pi"][0]["w"], local[pid]["pi"][0]["w"])
    finally:
        algo.cleanup()
