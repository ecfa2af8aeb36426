"""The port's PPO, A2C, DQN and SAC ``training_step`` against the JAX
package's, on the CPU.

Each pair of algorithms starts from the same weights (and, for DQN and
SAC, the same target nets) and learns from the same batches: the JAX
local worker samples, and the port's sampling round is handed what it
drew, so what is held is the orchestration around the policies, which
``test_torch_rllib_policy.py`` holds to the JAX package's one update at
a time.  f32: metrics and weights within 1e-5, as there.  No runtime:
both algorithms sample on their local worker.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib import SampleBatch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The learners' tensors are tiny: torch's intra-op threads only
    contend, with each other and with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_trees(got, want, what):
    """Two weight trees (the port's tensors, JAX's arrays) within 1e-5."""
    import jax

    from ray_tpu_torch.util.tree import tree_map

    tree_map(lambda g, w: np.testing.assert_allclose(
        np.asarray(g), w, atol=1e-5, err_msg=what),
        got, jax.tree_util.tree_map(np.asarray, want))


_STEP_CASES = {
    "PPO": ("CartPole-v1", dict(train_batch_size=96, sgd_minibatch_size=32, num_sgd_iter=2,
                                entropy_coeff=0.01, fcnet_hiddens=(16,)),
            dict(rollout_fragment_length=48)),
    "A2C": ("CartPole-v1", dict(train_batch_size=96, fcnet_hiddens=(16,)),
            dict(rollout_fragment_length=48)),
    # the target syncs every 4 updates: 6 a step puts syncs inside a step
    # and across steps; the batches' count crosses learning_starts
    "DQN": ("CartPole-v1", dict(timesteps_per_iteration=40, learning_starts=60,
                                updates_per_iteration=6, target_network_update_freq=4,
                                train_batch_size=16, epsilon_timesteps=100,
                                fcnet_hiddens=(16,)),
            # one round a step: later rounds start from the epsilon that
            # acting (JAX's only) annealed
            dict(rollout_fragment_length=40)),
    "SAC": ("Pendulum-v1", dict(timesteps_per_iteration=40, learning_starts=60,
                                updates_per_iteration=3, train_batch_size=16, lr=1e-3,
                                fcnet_hiddens=(16,)),
            dict(rollout_fragment_length=20)),
}


@pytest.mark.parametrize("name", list(_STEP_CASES))
def test_training_step_matches_jax(name):
    """Three ``training_step``s of the port's algorithm and of the JAX
    package's, from the same weights, on the same sampled batches (the
    JAX local worker samples; the port's sampling round is handed what it
    drew) and, for SAC, the same normal draws: the learner metrics, the
    env-step count, epsilon, the replay size, the weights and the target
    nets agree after every step (f32, within 1e-5).  What is held is the
    orchestration: sync, sampling to the batch size, minibatch order,
    replay draws, the target-sync cadence and the epsilon schedule."""
    import jax

    import ray_tpu.rllib as jrl
    import ray_tpu_torch.rllib as trl
    from ray_tpu_torch.convert import from_jax_rl_state

    env, training, rollouts = _STEP_CASES[name]

    def build(cfg):
        cfg = cfg.environment(env).rollouts(**rollouts).training(**training).debugging(seed=3)
        return cfg

    jalgo = build(getattr(jrl, f"{name}Config")()).build()
    talgo = build(getattr(trl, f"{name}Config")()).resources(device="cpu").build()
    jpol, tpol = jalgo.get_policy(), talgo.get_policy()
    tpol.set_state(from_jax_rl_state(jpol.get_state(), device="cpu"))
    if name == "DQN":
        tpol.update_target()  # the JAX target is its init's copy, as the port's

    drawn, epsilons = [], []
    jsample = jalgo.workers.synchronous_parallel_sample

    def record():
        """The JAX round's batch, and DQN's epsilon as the round starts
        (acting anneals it further, and only JAX acts)."""
        epsilons.append(getattr(jpol, "epsilon", None))
        b = jsample()
        drawn.append(SampleBatch({k: np.array(v) for k, v in b.items()}))
        return b

    def replay():
        assert getattr(tpol, "epsilon", None) == epsilons.pop(0)
        return drawn.pop(0)

    jalgo.workers.synchronous_parallel_sample = record
    talgo.workers.synchronous_parallel_sample = replay

    noises = []
    if name == "SAC":
        jlearn, tlearn = jpol.learn_on_minibatch, tpol.learn_on_minibatch

        def jax_learn(batch):
            """Note the two normal draws JAX's update makes, then make it."""
            _, key = jax.random.split(jpol._rng)
            r1, r2 = jax.random.split(key)
            shape = np.shape(batch[SampleBatch.ACTIONS])
            noises.append((np.asarray(jax.random.normal(r1, shape)),
                           np.asarray(jax.random.normal(r2, shape))))
            return jlearn(batch)

        jpol.learn_on_minibatch = jax_learn
        tpol.learn_on_minibatch = lambda batch: tlearn(batch, noise=noises.pop(0))

    learned = 0
    for step in range(3):
        want = jalgo.training_step()["info"]["learner"]
        got = talgo.training_step()["info"]["learner"]
        assert not drawn and not epsilons and not noises
        assert talgo._timesteps_total == jalgo._timesteps_total
        assert set(got) == set(want), step
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-5,
                                       err_msg=f"step {step}: {k}")
        learned += "total_loss" in want
        _close_trees(tpol.get_weights(), jpol.get_weights(), f"step {step}: weights")
        if name == "DQN":
            _close_trees(tpol.target_params, jpol.target_params, f"step {step}: target")
        if name == "SAC":
            _close_trees(tpol.target_q, jpol.target_q, f"step {step}: target_q")
        if name in ("DQN", "SAC"):
            assert len(talgo.replay) == len(jalgo.replay)
    assert learned >= 2  # replay algorithms learn from the second step on
    jalgo.cleanup()
    talgo.cleanup()
