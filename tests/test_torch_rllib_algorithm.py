"""The port's RLlib algorithms on its runtime, on the CPU.

Counterparts by name of ``test_rllib.py``'s PPO, A2C, IMPALA, DQN and SAC
tests (CartPole learns, checkpoint restore, 2 parallel rollout workers,
the evaluation interval, SAC on Pendulum), with the learner on
``resources(device="cpu")``, and the parity of what is deterministic with
the JAX package: the configs' defaults, ``Trainable``'s loop, and
IMPALA's V-trace batch from the same weights (f32, within 1e-5);
``test_torch_rllib_training_step.py`` holds the other algorithms'
``training_step``s.  The
devices follow the config: a learner with none named, or a remote worker
granted a card, raises on a host without one.

One runtime serves the module (``init(num_cpus=8, num_gpus=2)``, fake
cards); every wait has a timeout.  JAX is imported inside the tests only.
"""

import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib import (
    A2CConfig,
    DQNConfig,
    ImpalaConfig,
    PPOConfig,
    SACConfig,
    SampleBatch,
    compute_vtrace,
)
from ray_tpu_torch.tune import Trainable

T = 120  # seconds: every get in this file


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
    ray_tpu_torch.init(num_cpus=8, num_gpus=2)
    yield
    ray_tpu_torch.shutdown()


def _fast_ppo_config(num_workers=0):
    return (
        PPOConfig()
        .environment("CartPole-v1")
        .rollouts(num_rollout_workers=num_workers, rollout_fragment_length=400)
        .training(train_batch_size=2000, sgd_minibatch_size=128, num_sgd_iter=8, lr=3e-4,
                  entropy_coeff=0.01)
        .resources(device="cpu")
        .debugging(seed=0)
    )


def test_ppo_cartpole_learns():
    """The RLlib 'done' bar: reward >= 195 on CartPole."""
    algo = _fast_ppo_config().build()
    best = 0.0
    for _ in range(30):
        r = algo.train()
        best = max(best, r["episode_reward_mean"])
        if best >= 195:
            break
    assert best >= 195, f"PPO failed to learn CartPole: best={best}"
    # greedy inference from the trained policy holds the pole
    import gymnasium as gym

    env = gym.make("CartPole-v1")
    obs, _ = env.reset(seed=123)
    total = 0.0
    for _ in range(500):
        obs, reward, terminated, truncated, _ = env.step(algo.compute_single_action(obs))
        total += reward
        if terminated or truncated:
            break
    assert total >= 100, f"greedy rollout too short: {total}"
    algo.cleanup()


def test_ppo_checkpoint_restore():
    algo = _fast_ppo_config().build()
    for _ in range(3):
        algo.train()
    state = algo.save_checkpoint()
    ts = state["timesteps_total"]
    w0 = state["policy_state"]["weights"]

    algo2 = _fast_ppo_config().build()
    algo2.load_checkpoint(state)
    assert algo2._timesteps_total == ts
    w1 = algo2.workers.local_worker.get_weights()
    np.testing.assert_allclose(w0["pi"][0]["w"], w1["pi"][0]["w"])
    # the optimizer's moments came back too (not zeroed)
    opt = algo2.workers.local_worker.policy.get_state()["opt_state"]
    assert opt["step"] == state["policy_state"]["opt_state"]["step"] > 0
    assert max(float(np.abs(m["w"]).max()) for m in opt["exp_avg"]["pi"]) > 0
    # and through the Trainable's own save / restore
    ckpt = algo.save()
    algo2.restore(ckpt)
    assert algo2.iteration == algo.iteration == 3
    algo.cleanup()
    algo2.cleanup()


def test_ppo_parallel_rollout_workers(runtime):
    """num_rollout_workers > 0: sampling runs on actors of the port's
    runtime, whose policies follow the config's grant (the CPU here),
    and weights sync."""
    import cloudpickle

    algo = _fast_ppo_config(num_workers=2).build()
    r1 = algo.train()
    assert r1["timesteps_total"] >= 2000
    r2 = algo.train()
    assert r2["timesteps_total"] > r1["timesteps_total"]
    assert r2["episodes_total"] > 0
    probe = cloudpickle.dumps(lambda w: (w.worker_index, str(w.policy.device),
                                         w.get_weights()["pi"][0]["w"]))
    local = algo.workers.local_worker.get_weights()["pi"][0]["w"]
    algo.workers.sync_weights()
    got = ray_tpu_torch.get([w.apply.remote(probe) for w in algo.workers.remote_workers],
                            timeout=T)
    assert [g[:2] for g in got] == [(1, "cpu"), (2, "cpu")]
    for g in got:
        np.testing.assert_array_equal(g[2], local)
    algo.cleanup()


def test_remote_workers_granted_a_card_raise_without_one(runtime):
    """A worker granted a share of a card builds its policy on the card:
    on a host without one its construction raises, and no fallback to the
    CPU hides it.  Its grant comes back when it is gone."""
    free = ray_tpu_torch.available_resources().get("GPU")
    algo = (_fast_ppo_config(num_workers=2).rollouts(rollout_fragment_length=50)
            .training(train_batch_size=100).resources(num_gpus_per_worker=0.5).build())
    with pytest.raises(Exception, match="no CUDA device"):
        algo.train()
    algo.cleanup()
    deadline = time.monotonic() + 30
    while ray_tpu_torch.available_resources().get("GPU") != free:
        assert time.monotonic() < deadline, ray_tpu_torch.available_resources()
        time.sleep(0.1)


def test_learner_device_defaults_to_the_card():
    cfg = PPOConfig().environment("CartPole-v1").rollouts(rollout_fragment_length=8)
    assert cfg.to_dict()["device"] is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cfg.build()


def test_config_refuses_what_is_not_ported():
    """Only the JAX framework is refused; offline IO is ported, and
    ``offline_data`` sets the keys the JAX package's sets."""
    with pytest.raises(ValueError, match="torch"):
        PPOConfig().framework("jax")
    PPOConfig().framework("torch")
    cfg = DQNConfig().offline_data(input_="/in", output="/out").to_dict()
    assert (cfg["input"], cfg["output"]) == ("/in", "/out")


@pytest.mark.parametrize("name", ["PPO", "A2C", "Impala", "DQN", "SAC", "APPO",
                                  "MultiAgentPPO"])
def test_config_defaults_match_jax(name):
    """Every default of the JAX package's config, the same in the port's;
    the port adds the devices."""
    import ray_tpu.rllib as jrl
    import ray_tpu_torch.rllib as trl

    def plain(d):
        return {k: v for k, v in d.items() if not callable(v) and not k.startswith("_")}

    j = plain(getattr(jrl, f"{name}Config")().to_dict())
    t = plain(getattr(trl, f"{name}Config")().to_dict())
    assert j.pop("framework") == "jax" and t.pop("framework") == "torch"
    assert t.pop("device") is None and t.pop("num_gpus_per_worker") == 0
    assert t["input"] is None and t["output"] is None
    assert t == j


def test_trainable_loop_matches_jax():
    """``train``'s result keys and counts, ``save`` and ``restore`` as the
    JAX package's ``Trainable`` gives them, for the same subclass."""
    from ray_tpu.tune.trainable import Trainable as JaxTrainable

    def make(base):
        class Count(base):
            def setup(self, config):
                self.n = config.get("start", 0)

            def step(self):
                self.n += 1
                return {"n": self.n}

            def save_checkpoint(self):
                return {"n": self.n}

            def load_checkpoint(self, state):
                self.n = state["n"]

        return Count({"start": 5})

    runs = []
    for base in (JaxTrainable, Trainable):
        t = make(base)
        results = [t.train() for _ in range(3)]
        ckpt = t.save()
        fresh = make(base)
        fresh.restore(ckpt)
        runs.append((results, fresh.iteration, fresh.n, fresh.train()))
        t.stop()
    assert runs[0] == runs[1]


def test_dqn_cartpole_learns():
    """DQN (replay, a target net, epsilon-greedy) reaches a learning
    signal on CartPole."""
    config = (
        DQNConfig()
        .environment("CartPole-v1")
        .rollouts(num_rollout_workers=0, rollout_fragment_length=200)
        .resources(device="cpu")
        .debugging(seed=7)
        .training(lr=5e-4, timesteps_per_iteration=500, updates_per_iteration=200,
                  learning_starts=500, epsilon_timesteps=3500, target_network_update_freq=200,
                  fcnet_hiddens=(64, 64))
    )
    algo = config.build()
    best = 0.0
    for _ in range(40):
        r = algo.train()
        best = max(best, r["episode_reward_mean"])
        if best >= 130:
            break
    assert best >= 130, f"DQN failed to learn CartPole: best={best}"
    info = r["info"]["learner"]
    assert info["replay_size"] > 0 and info["epsilon"] < 1.0
    algo.cleanup()


def test_a2c_cartpole_learns():
    algo = (
        A2CConfig()
        .environment("CartPole-v1")
        .rollouts(rollout_fragment_length=200)
        .training(train_batch_size=800, lr=2e-3, entropy_coeff=0.01)
        .resources(device="cpu")
        .debugging(seed=3)
        .build()
    )
    best = 0.0
    for _ in range(40):
        r = algo.train()
        best = max(best, r["episode_reward_mean"])
        if best >= 120:
            break
    algo.cleanup()
    assert best >= 120, f"A2C failed to improve on CartPole: best={best}"


def test_impala_cartpole_learns():
    algo = (
        ImpalaConfig()
        .environment("CartPole-v1")
        .rollouts(rollout_fragment_length=200)
        .training(train_batch_size=800, lr=2e-3)
        .resources(device="cpu")
        .debugging(seed=0)
        .build()
    )
    best = 0.0
    for _ in range(40):
        r = algo.train()
        best = max(best, r["episode_reward_mean"])
        if best >= 120:
            break
    algo.cleanup()
    assert best >= 120, f"IMPALA failed to improve on CartPole: best={best}"


def test_impala_vtrace_batch_matches_jax():
    """The V-trace batch (advantages and targets per segment, bootstraps
    at truncations and the fragment's seams) from the same weights and the
    same sampled batch, against the JAX package's ``Impala``."""
    from ray_tpu.rllib import ImpalaConfig as JaxImpalaConfig

    kw = dict(train_batch_size=64, fcnet_hiddens=(16,))
    jalgo = (JaxImpalaConfig().environment("CartPole-v1")
             .rollouts(rollout_fragment_length=64, num_envs_per_worker=2)
             .training(**kw).debugging(seed=1).build())
    talgo = (ImpalaConfig().environment("CartPole-v1")
             .rollouts(rollout_fragment_length=64, num_envs_per_worker=2)
             .training(**kw).resources(device="cpu").debugging(seed=1).build())
    talgo.workers.local_worker.set_weights(jalgo.workers.local_worker.get_weights())
    batch = talgo.workers.local_worker.sample()
    assert not batch[SampleBatch.TERMINATEDS].all()
    got, want = talgo._vtrace_batch(batch), jalgo._vtrace_batch(batch)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-5, err_msg=k)
    jalgo.cleanup()
    talgo.cleanup()


def test_vtrace_reduces_to_gae_targets_on_policy():
    """With identical behavior/current logp, rho = c = 1 and vs is the
    discounted return recursion."""
    rng = np.random.default_rng(0)
    T_ = 6
    logp = rng.normal(size=T_).astype(np.float32)
    values = rng.normal(size=T_).astype(np.float32)
    rewards = rng.normal(size=T_).astype(np.float32)
    vs, _, rho = compute_vtrace(logp, logp, values, 0.5, rewards, 0.9)
    assert np.allclose(rho, 1.0)
    expect = np.zeros(T_, np.float32)
    acc = 0.5
    for t in range(T_ - 1, -1, -1):
        acc = rewards[t] + 0.9 * acc
        expect[t] = acc
    np.testing.assert_allclose(vs, expect, rtol=1e-5)


def test_evaluation_interval():
    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .evaluation(evaluation_interval=2, evaluation_num_episodes=2)
        .training(train_batch_size=400, sgd_minibatch_size=64, num_sgd_iter=2)
        .resources(device="cpu")
        .build()
    )
    r1 = algo.train()
    assert "evaluation" not in r1
    r2 = algo.train()
    assert "evaluation" in r2
    assert r2["evaluation"]["episodes_this_eval"] == 2
    assert np.isfinite(r2["evaluation"]["episode_reward_mean"])
    algo.cleanup()


def test_sac_pendulum_runs_and_improves():
    algo = (
        SACConfig()
        .environment("Pendulum-v1")
        .training(timesteps_per_iteration=400, updates_per_iteration=100, learning_starts=300)
        .resources(device="cpu")
        .debugging(seed=0)
        .build()
    )
    first = last = None
    for _ in range(8):
        r = algo.train()
        m = r["episode_reward_mean"]
        if first is None and np.isfinite(m):
            first = m
        if np.isfinite(m):
            last = m
    lm = r["info"]["learner"]
    assert np.isfinite(lm["critic_loss"]) and np.isfinite(lm["actor_loss"])
    assert lm["alpha"] > 0
    # the policy acts in the canonical [-1, 1] box; the worker rescales to
    # the env's Box(-2, 2) so full torque is reachable
    pol = algo.get_policy()
    assert pol.device == torch.device("cpu")
    a = pol.greedy_action(np.zeros((4, 3), np.float32))
    assert a.shape == (4, 1) and np.all(np.abs(a) <= 1.0 + 1e-6)
    w = algo.workers.local_worker
    assert np.allclose(w._env_action(np.array([1.0])), [2.0])
    assert np.allclose(w._env_action(np.array([-1.0])), [-2.0])
    assert last is not None and first is not None
    assert last >= first - 100  # not collapsing; strict improvement is noisy in 8 iterations
    algo.cleanup()
