"""The port's APPO, on the CPU.

With no remote workers APPO samples synchronously and learns as its async
step does: three ``training_step``s from the JAX package's weights
(``convert.from_jax_rl_state``), fed the batches the JAX local worker
drew, against the JAX package's APPO learner step (``appo.py``'s
V-trace batch and clipped-surrogate ``train_one_step``) on the same
batches: learner metrics and weights within 1e-5 (f32).  The JAX
package's own fallback goes to IMPALA's step, whose keys drop the
behavior logp its loss reads, and raises ``KeyError``; so the reference
is its async step's learner.  On the runtime: ``test_rllib.py``'s two
APPO tests by name, and ``cleanup`` leaves no sample in flight and no
worker alive.

One runtime serves the module (``init(num_cpus=4)``); JAX is imported
inside the tests only.
"""

import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib import APPOConfig, SampleBatch


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


def _close_trees(got, want, what):
    """Two weight trees (the port's arrays, JAX's arrays) within 1e-5."""
    import jax

    from ray_tpu_torch.util.tree import tree_map

    tree_map(lambda g, w: np.testing.assert_allclose(
        np.asarray(g), w, atol=1e-5, err_msg=what),
        got, jax.tree_util.tree_map(np.asarray, want))


def test_sync_training_step_matches_jax():
    import ray_tpu.rllib as jrl
    from ray_tpu.rllib.algorithm import synchronous_parallel_sample as jsample_to
    from ray_tpu.rllib.algorithm import train_one_step as jtrain_one_step
    from ray_tpu_torch.convert import from_jax_rl_state
    from ray_tpu_torch.rllib.appo import APPO_KEYS

    def build(cfg):
        return (cfg.environment("CartPole-v1").rollouts(rollout_fragment_length=48)
                .training(train_batch_size=96, minibatch_size=32, num_sgd_iter=2,
                          fcnet_hiddens=(16,), entropy_coeff=0.01)
                .debugging(seed=3))

    jalgo = build(jrl.APPOConfig()).build()
    talgo = build(APPOConfig()).resources(device="cpu").build()
    jpol, tpol = jalgo.get_policy(), talgo.get_policy()
    tpol.set_state(from_jax_rl_state(jpol.get_state(), device="cpu"))
    cfg = jalgo.config

    drawn = []
    jround = jalgo.workers.synchronous_parallel_sample

    def record():
        b = jround()
        drawn.append(SampleBatch({k: np.array(v) for k, v in b.items()}))
        return b

    jalgo.workers.synchronous_parallel_sample = record
    talgo.workers.synchronous_parallel_sample = lambda: drawn.pop(0)

    for step in range(3):
        batch = jsample_to(jalgo.workers, max_env_steps=cfg["train_batch_size"])
        jalgo._timesteps_total += batch.count
        want = jtrain_one_step(jpol, jalgo._vtrace_batch(batch),
                               num_sgd_iter=cfg["num_sgd_iter"],
                               sgd_minibatch_size=cfg["minibatch_size"],
                               rng=jalgo._sgd_rng, required_keys=APPO_KEYS)
        got = talgo.training_step()["info"]["learner"]
        assert not drawn
        assert talgo._timesteps_total == jalgo._timesteps_total
        assert set(got) == set(want) == {"total_loss", "policy_loss", "vf_loss",
                                         "entropy", "kl"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-5,
                                       err_msg=f"step {step}: {k}")
        _close_trees(tpol.get_weights(), jpol.get_weights(), f"step {step}: weights")
    jalgo.cleanup()
    talgo.cleanup()


def test_appo_async_cartpole_learns(runtime):
    """APPO: async rollout/learner overlap (workers always have a sample
    in flight; the learner trains on whatever lands first) with the
    clipped surrogate over V-trace-corrected advantages (reference
    rllib/algorithms/appo/appo.py)."""
    algo = (
        APPOConfig()
        .environment("CartPole-v1")
        .rollouts(num_rollout_workers=2, rollout_fragment_length=200)
        .training(train_batch_size=400, lr=3e-3, num_sgd_iter=2,
                  minibatch_size=200, batches_per_step=2)
        .resources(device="cpu")
        .debugging(seed=0)
        .build()
    )
    best = 0.0
    for _ in range(120):
        r = algo.train()
        best = max(best, r["episode_reward_mean"])
        if best >= 120:
            break
    algo.cleanup()
    assert best >= 120, f"APPO failed to improve on CartPole: best={best}"


def test_appo_overlaps_sampling_with_learning(runtime):
    """The async contract itself: while the learner is inside
    training_step, every rollout worker has a sample() already in flight
    (no sampling barrier)."""
    algo = (
        APPOConfig()
        .environment("CartPole-v1")
        .rollouts(num_rollout_workers=2, rollout_fragment_length=50)
        .training(train_batch_size=100)
        .resources(device="cpu")
        .debugging(seed=0)
        .build()
    )
    algo.train()
    # after a step returns, the workers are re-armed: one in-flight
    # sample per worker is already running
    assert len(algo._inflight) == len(algo.workers.remote_workers)
    algo.cleanup()
    assert not algo._inflight


def test_cleanup_ends_the_workers_and_their_samples(runtime):
    """``cleanup`` with samples in flight: none is left, every worker is
    dead (a call on it raises) and the runtime has all its CPUs back.
    The workers here hold CPUs; a card share comes back the same way, as
    the kill gives back the whole grant."""
    free = 4  # the runtime's CPUs, back once the earlier tests' workers are gone
    deadline = time.monotonic() + 30
    while ray_tpu_torch.available_resources()["CPU"] != free:
        assert time.monotonic() < deadline, ray_tpu_torch.available_resources()
        time.sleep(0.1)
    algo = (APPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=2, rollout_fragment_length=400)
            .training(train_batch_size=400, batches_per_step=1)
            .resources(device="cpu", num_cpus_per_worker=1)
            .debugging(seed=0).build())
    algo.train()
    workers = list(algo.workers.remote_workers)
    assert len(algo._inflight) == 2
    assert ray_tpu_torch.available_resources()["CPU"] == free - 2
    algo.cleanup()
    assert not algo._inflight
    for w in workers:
        with pytest.raises(ray_tpu_torch.exceptions.RayActorError):
            ray_tpu_torch.get(w.get_metrics.remote(), timeout=30)
    deadline = time.monotonic() + 30
    while ray_tpu_torch.available_resources()["CPU"] != free:
        assert time.monotonic() < deadline, ray_tpu_torch.available_resources()
        time.sleep(0.1)
