"""The port's policies and rollout worker against ray_tpu.rllib's.

``TorchPolicy``, ``DQNPolicy`` and ``SACPolicy`` start from the JAX
policies' weights (``set_weights`` of ``get_weights()``) or state
(``convert.from_jax_rl_state`` of ``get_state()``) and take the same
numpy minibatches.  f32: weights after each update agree within 1e-5,
metrics within 1e-5 (absolute and relative), forwards within 1e-5.
Sampled actions cannot match ``jax.random``'s draws, so acting is held
to what is deterministic: ``action_logp`` of given actions, greedy
actions, values, the log-prob of the drawn action, DQN's epsilon-greedy
actions (numpy draws) and SAC's update given JAX's own noise.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import dqn as jdqn
from ray_tpu.rllib import ppo as jppo
from ray_tpu.rllib import sac as jsac
from ray_tpu.rllib.envs import synthetic_atari_creator as jax_atari
from ray_tpu.rllib.policy import JaxPolicy
from ray_tpu.rllib.rollout_worker import RolloutWorker as JaxWorker
from ray_tpu_torch.convert import from_jax_rl_state
from ray_tpu_torch.rllib import dqn, ppo, sac
from ray_tpu_torch.rllib.envs import synthetic_atari_creator
from ray_tpu_torch.rllib.policy import TorchPolicy
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.util.tree import tree_map

TOL = dict(atol=1e-5, rtol=1e-5)
A = 4


def _close(got, want, atol=1e-5):
    """Two weight trees (dict keys matched by name) within ``atol``."""
    tree_map(lambda g, w: np.testing.assert_allclose(np.asarray(g), w, atol=atol),
             got, jax.tree_util.tree_map(np.asarray, want))


def _metrics_close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def _ppo_batch(rng, n, obs_shape):
    obs = (rng.integers(0, 256, (n, *obs_shape), dtype=np.uint8) if len(obs_shape) == 3
           else rng.standard_normal((n, *obs_shape)).astype(np.float32))
    return {SampleBatch.OBS: obs,
            SampleBatch.ACTIONS: rng.integers(0, A, n),
            SampleBatch.ACTION_LOGP: (np.log(1 / A) + rng.normal(0, 0.1, n)).astype(np.float32),
            SampleBatch.ADVANTAGES: rng.normal(size=n).astype(np.float32),
            SampleBatch.VALUE_TARGETS: rng.normal(0, 3, n).astype(np.float32)}


def _pair(obs_shape=None, grad_clip=0.05, lr=1e-3):
    """A JaxPolicy and a TorchPolicy with PPO's loss and the same weights."""
    kw = dict(hiddens=(32,), lr=lr, grad_clip=grad_clip, obs_shape=obs_shape)
    dim = int(np.prod(obs_shape)) if obs_shape else 8
    jpol = JaxPolicy(dim, A, loss_fn=jppo.make_ppo_loss(0.2, 10.0, 0.5, 0.01), **kw)
    tpol = TorchPolicy(dim, A, loss_fn=ppo.make_ppo_loss(0.2, 10.0, 0.5, 0.01), device="cpu",
                       **kw)
    tpol.set_weights(jpol.get_weights())
    return jpol, tpol


def _global_norm_fn(jpol):
    """The global norm of the JAX policy's gradient on a batch (jitted)."""
    def norm(params, batch):
        grads = jax.grad(lambda p: jpol._loss_fn(p, batch)[0])(params)
        return jnp.sqrt(sum(jnp.sum(g ** 2) for g in jax.tree_util.tree_leaves(grads)))
    return jax.jit(norm)


@pytest.mark.parametrize("obs_shape", [None, (36, 36, 4)], ids=["mlp", "cnn"])
def test_learn_on_minibatch_three_steps_with_clipping(obs_shape):
    """Three Adam updates with the global-norm clip active on each, as
    optax clips: weights and metrics after every step."""
    rng = np.random.default_rng(0)
    jpol, tpol = _pair(obs_shape)
    global_norm = _global_norm_fn(jpol)
    for step in range(3):
        batch = _ppo_batch(rng, 16, obs_shape or (8,))
        assert float(global_norm(jpol.params, batch)) > 0.05  # the clip scales this step
        _metrics_close(tpol.learn_on_minibatch(batch), jpol.learn_on_minibatch(batch))
        _close(tpol.get_weights(), jpol.get_weights())


@pytest.mark.parametrize("grad_clip", [0.05, None], ids=["clip", "no_clip"])
def test_jax_state_after_two_steps_gives_the_same_third_update(grad_clip):
    """``JaxPolicy.get_state()`` after 2 updates, carried into a fresh
    port policy (weights, Adam count and moments), makes update 3 as the
    JAX policy makes it; the optax chain has a clip state or none."""
    rng = np.random.default_rng(1)
    jpol, _ = _pair(grad_clip=grad_clip)
    batches = [_ppo_batch(rng, 16, (8,)) for _ in range(3)]
    for b in batches[:2]:
        jpol.learn_on_minibatch(b)
    state = from_jax_rl_state(jpol.get_state(), device="cpu")
    assert state["opt_state"]["step"] == 2
    tpol = TorchPolicy(8, A, hiddens=(32,), lr=1e-3, grad_clip=grad_clip, seed=5,
                       loss_fn=ppo.make_ppo_loss(0.2, 10.0, 0.5, 0.01), device="cpu")
    tpol.set_state(state)
    _metrics_close(tpol.learn_on_minibatch(batches[2]), jpol.learn_on_minibatch(batches[2]))
    _close(tpol.get_weights(), jpol.get_weights())
    assert tpol.get_state()["opt_state"]["step"] == 3


def test_port_state_round_trip_resumes_exactly():
    rng = np.random.default_rng(2)
    _, a = _pair()
    batches = [_ppo_batch(rng, 16, (8,)) for _ in range(3)]
    for b in batches[:2]:
        a.learn_on_minibatch(b)
    b_pol = TorchPolicy(8, A, hiddens=(32,), lr=1e-3, grad_clip=0.05, seed=9,
                        loss_fn=ppo.make_ppo_loss(0.2, 10.0, 0.5, 0.01), device="cpu")
    b_pol.set_state(a.get_state())
    assert a.learn_on_minibatch(batches[2]) == b_pol.learn_on_minibatch(batches[2])
    tree_map(np.testing.assert_array_equal, a.get_weights(), b_pol.get_weights())
    with pytest.raises(ValueError, match="shape"):
        b_pol.set_weights(tree_map(lambda w: w[:1], a.get_weights()))


@pytest.mark.parametrize("obs_shape", [None, (36, 36, 4)], ids=["mlp", "cnn"])
def test_acting_surface(obs_shape):
    """value, greedy_action and action_logp equal the JAX policy's; a
    drawn action's logp is log_softmax at it, its vf_pred is value()."""
    rng = np.random.default_rng(3)
    jpol, tpol = _pair(obs_shape)
    obs = _ppo_batch(rng, 32, obs_shape or (8,))[SampleBatch.OBS]
    acts = rng.integers(0, A, 32)
    np.testing.assert_allclose(tpol.value(obs), jpol.value(obs), **TOL)
    np.testing.assert_array_equal(tpol.greedy_action(obs), jpol.greedy_action(obs))
    np.testing.assert_allclose(tpol.action_logp(obs, acts), jpol.action_logp(obs, acts), **TOL)
    a, logp, vf = tpol.compute_actions(obs)
    assert a.dtype == np.int64 and a.shape == (32,) and set(a) <= set(range(A))
    np.testing.assert_allclose(logp, jpol.action_logp(obs, a), **TOL)
    np.testing.assert_allclose(vf, jpol.value(obs), **TOL)
    # the draws come from the policy's seeded generator
    again = TorchPolicy(tpol.obs_dim, A, hiddens=(32,), obs_shape=obs_shape, device="cpu")
    again.set_weights(tpol.get_weights())
    np.testing.assert_array_equal(again.compute_actions(obs)[0], a)
    with pytest.raises(RuntimeError, match="loss_fn"):
        again.learn_on_minibatch({})


def _dqn_pair(**kw):
    jpol = jdqn.DQNPolicy(6, 3, hiddens=(16,), loss_fn=jdqn.make_dqn_loss(), seed=3,
                          grad_clip=10.0, **kw)
    tpol = dqn.DQNPolicy(6, 3, hiddens=(16,), loss_fn=dqn.make_dqn_loss(), seed=3,
                         grad_clip=10.0, device="cpu", **kw)
    tpol.set_weights(jpol.get_weights())
    tpol.update_target()
    return jpol, tpol


def test_dqn_epsilon_greedy_actions_equal_for_the_same_seed_and_q():
    jpol, tpol = _dqn_pair(epsilon_timesteps=400, final_epsilon=0.1)
    rng = np.random.default_rng(4)
    for _ in range(8):  # epsilon falls from 1 to 0.28 over the ticks
        obs = rng.standard_normal((25, 6)).astype(np.float32)
        got, want = tpol.compute_actions(obs), jpol.compute_actions(obs)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[2], want[2], **TOL)
        assert tpol.epsilon == jpol.epsilon
    tpol.on_global_timestep(10_000)
    assert tpol.epsilon == pytest.approx(0.1)
    np.testing.assert_allclose(tpol.value(obs), jpol.value(obs), **TOL)


def test_dqn_td_targets_update_and_target_sync():
    jpol, tpol = _dqn_pair()
    rng = np.random.default_rng(5)
    mb = SampleBatch({SampleBatch.OBS: rng.standard_normal((32, 6)).astype(np.float32),
                      SampleBatch.NEXT_OBS: rng.standard_normal((32, 6)).astype(np.float32),
                      SampleBatch.ACTIONS: rng.integers(0, 3, 32),
                      SampleBatch.REWARDS: rng.normal(size=32).astype(np.float32),
                      SampleBatch.TERMINATEDS: rng.random(32) < 0.3})
    for step in range(3):
        want = jpol.compute_td_targets(mb, 0.99)
        np.testing.assert_allclose(tpol.compute_td_targets(mb, 0.99), want, **TOL)
        cols = {SampleBatch.OBS: mb[SampleBatch.OBS], SampleBatch.ACTIONS: mb[SampleBatch.ACTIONS],
                SampleBatch.VALUE_TARGETS: want * 4.0}  # |td| past 1: both Huber branches
        _metrics_close(tpol.learn_on_minibatch(cols), jpol.learn_on_minibatch(cols))
        _close(tpol.get_weights(), jpol.get_weights())
        if step == 1:
            jpol.update_target()
            tpol.update_target()
    _close(tpol.target_params, jpol.target_params)


def _sac_batch(rng, n=20, obs_dim=3, act_dim=2):
    return {SampleBatch.OBS: rng.standard_normal((n, obs_dim)).astype(np.float32),
            SampleBatch.ACTIONS: rng.uniform(-1, 1, (n, act_dim)).astype(np.float32),
            SampleBatch.REWARDS: rng.normal(size=n).astype(np.float32),
            SampleBatch.TERMINATEDS: rng.random(n) < 0.2,
            SampleBatch.NEXT_OBS: rng.standard_normal((n, obs_dim)).astype(np.float32)}


def _jax_noise(jpol, shape):
    """The two normal draws JAX's next ``learn_on_minibatch`` makes."""
    _, key = jax.random.split(jpol._rng)
    r1, r2 = jax.random.split(key)
    return np.asarray(jax.random.normal(r1, shape)), np.asarray(jax.random.normal(r2, shape))


@pytest.mark.parametrize("grad_clip", [None, 1.0], ids=["no_clip", "clip"])
def test_sac_update_given_the_same_noise(grad_clip):
    """Two SAC updates (critics, actor, temperature, Polyak targets) from
    a JAX policy's state, each with the normal draws JAX makes."""
    rng = np.random.default_rng(6)
    kw = dict(hiddens=(16, 16), seed=2, grad_clip=grad_clip, lr=3e-3, tau=0.05)
    jpol = jsac.SACPolicy(3, 2, **kw)
    jpol.learn_on_minibatch(_sac_batch(rng))  # moments and targets off their init
    tpol = sac.SACPolicy(3, 2, device="cpu", **kw)
    tpol.set_state(from_jax_rl_state(jpol.get_state(), device="cpu"))
    assert tpol.params["log_alpha"].shape == ()
    for _ in range(2):
        batch = _sac_batch(rng)
        noise = _jax_noise(jpol, (20, 2))
        _metrics_close(tpol.learn_on_minibatch(batch, noise=noise),
                       jpol.learn_on_minibatch(batch))
        _close(tpol.get_weights(), jpol.get_weights())
        _close(tpol.target_q, jpol.target_q)
    obs = _sac_batch(rng)[SampleBatch.OBS]
    np.testing.assert_allclose(tpol.greedy_action(obs), jpol.greedy_action(obs), **TOL)
    act, logp, vf = tpol.compute_actions(obs)
    assert act.shape == (20, 2) and np.abs(act).max() < 1 and logp.shape == vf.shape == (20,)
    tpol.learn_on_minibatch(batch)  # its own draws


_PPO = dict(clip_param=0.2, vf_clip_param=10.0, vf_loss_coeff=0.5, entropy_coeff=0.0)


@pytest.mark.parametrize("env", ["cartpole", "atari"])
def test_rollout_worker_fragment_shape(env):
    """JAX's ``test_rollout_worker_fragment_shape`` on the port's worker:
    the columns and shapes of a fragment, then ``value()`` equal to a JAX
    worker's after ``set_weights`` from its ``get_weights()``."""
    if env == "cartpole":
        base = {"env": "CartPole-v1", "rollout_fragment_length": 64, "seed": 0}
        jcfg, tcfg, n, obs_shape, dtype = base, base, 64, (4,), np.float32
    else:
        base = {"env_config": {"episode_len": 6}, "rollout_fragment_length": 5,
                "num_envs_per_worker": 2, "fcnet_hiddens": (16,), "seed": 0}
        jcfg = dict(base, env_creator=jax_atari)
        tcfg = dict(base, env_creator=synthetic_atari_creator)
        n, obs_shape, dtype = 10, (84, 84, 4), np.uint8
    jw = JaxWorker(dict(jcfg, _loss_factory=jppo._ppo_loss_factory, **_PPO))
    tw = RolloutWorker(dict(tcfg, _loss_factory=ppo._ppo_loss_factory, **_PPO), device="cpu")
    batch = tw.sample()
    want = jw.sample()
    assert batch.count == want.count == n
    assert set(batch) == set(want) >= {
        SampleBatch.OBS, SampleBatch.ACTIONS, SampleBatch.ADVANTAGES,
        SampleBatch.VALUE_TARGETS, SampleBatch.ACTION_LOGP}
    for k in want:
        assert batch[k].shape == want[k].shape, k
        # actions are int64 in the port (what gather takes), int32 in JAX's
        assert batch[k].dtype == (np.int64 if k == SampleBatch.ACTIONS else want[k].dtype), k
    assert batch[SampleBatch.OBS].shape == (n, *obs_shape) and batch[SampleBatch.OBS].dtype == dtype
    assert set(tw.last_sample_phases) == {"env_s", "infer_s", "connector_s", "postprocess_s",
                                          "wall_s"}
    tw.set_weights(jw.get_weights())
    obs = batch[SampleBatch.OBS]
    np.testing.assert_allclose(tw.policy.value(obs), jw.policy.value(obs), **TOL)
    # the batch's own GAE: value targets are advantages plus vf_preds
    np.testing.assert_allclose(batch[SampleBatch.VALUE_TARGETS],
                               batch[SampleBatch.ADVANTAGES] + batch[SampleBatch.VF_PREDS],
                               atol=1e-6)
    assert tw.get_metrics()["worker_steps"] == n
    if env == "cartpole":
        # greedy evaluation is deterministic: the same episodes
        assert tw.evaluate_episodes(2) == jw.evaluate_episodes(2)


def test_rollout_worker_raises_on_what_is_not_ported():
    """Everything of the JAX package's worker is ported now: offline
    ``output`` writes each fragment as a JSON line
    (``test_torch_rllib_offline.py`` holds the files to the JAX
    package's).  The frame-stack transport needs a policy with the stacked
    tick (a ``RemotePolicy``), so a local policy samples as usual, as in
    the JAX package; ``apply`` runs a pickled function on the worker."""
    import cloudpickle

    from ray_tpu_torch.rllib import JsonReader

    base = {"env_creator": synthetic_atari_creator, "env_config": {"episode_len": 4},
            "fcnet_hiddens": (8,)}
    with tempfile.TemporaryDirectory() as out:
        b = RolloutWorker(dict(base, output=out, rollout_fragment_length=2),
                          device="cpu").sample()
        assert os.listdir(out) == ["output-worker_0-0.json"]
        np.testing.assert_array_equal(JsonReader(out).read_all()[SampleBatch.OBS],
                                      b[SampleBatch.OBS])
    w = RolloutWorker(dict(base, _frame_stack_transport=True, rollout_fragment_length=2),
                      device="cpu")
    assert w.sample()[SampleBatch.OBS].dtype == np.uint8
    assert w.apply(cloudpickle.dumps(lambda worker: worker.worker_index + 7)) == 7
