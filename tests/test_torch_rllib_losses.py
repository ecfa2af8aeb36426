"""The port's RL losses, advantage estimators and SGD loop against
ray_tpu.rllib's.

The same numpy batch (``default_rng``) and the same weights go through
each JAX loss under ``jax.value_and_grad`` and through the port's loss and
``backward``.  f32: the loss and its metrics agree within 1e-5 (absolute
and relative), each gradient leaf within 1e-4 of that leaf's largest
entry.  ``compute_gae``, ``compute_vtrace`` and ``SampleBatch.minibatches``
are numpy in both packages and must agree exactly; ``train_one_step``
leaves the same weights within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import a2c as ja2c
from ray_tpu.rllib import dqn as jdqn
from ray_tpu.rllib import impala as jimpala
from ray_tpu.rllib import ppo as jppo
from ray_tpu.rllib.algorithm import train_one_step as jax_train_one_step
from ray_tpu.rllib.policy import JaxPolicy
from ray_tpu.rllib.postprocessing import compute_gae as jax_gae
from ray_tpu.rllib.rl_module import DefaultActorCriticModule as JaxModule
from ray_tpu.rllib.sample_batch import SampleBatch as JaxBatch
from ray_tpu_torch.convert import from_jax_rl_params
from ray_tpu_torch.rllib import a2c, dqn, impala, ppo
from ray_tpu_torch.rllib.algorithm import train_one_step
from ray_tpu_torch.rllib.policy import TorchPolicy
from ray_tpu_torch.rllib.postprocessing import compute_gae
from ray_tpu_torch.rllib.rl_module import DefaultActorCriticModule
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.util.tree import tree_leaves, tree_map

B, A = 24, 6
LOSSES = {
    # name: (JAX loss, port loss); PPO with a tight clip so the batch's
    # ratios reach both sides of it
    "ppo": (jppo.make_ppo_loss(0.05, 0.6, 0.5, 0.01), ppo.make_ppo_loss(0.05, 0.6, 0.5, 0.01)),
    "a2c": (ja2c.make_a2c_loss(0.5, 0.01), a2c.make_a2c_loss(0.5, 0.01)),
    "impala": (jimpala.make_impala_loss(0.5, 0.01), impala.make_impala_loss(0.5, 0.01)),
    "dqn": (jdqn.make_dqn_loss(), dqn.make_dqn_loss()),
}


def _batch(rng, obs_shape):
    obs = (rng.integers(0, 256, (B, *obs_shape), dtype=np.uint8) if len(obs_shape) == 3
           else rng.standard_normal((B, *obs_shape)).astype(np.float32))
    return {
        SampleBatch.OBS: obs,
        SampleBatch.ACTIONS: rng.integers(0, A, B),
        # behavior logp near log(1/A): ratios on both sides of the clip
        SampleBatch.ACTION_LOGP: (np.log(1 / A) + rng.normal(0, 0.2, B)).astype(np.float32),
        SampleBatch.ADVANTAGES: rng.normal(0.3, 1.5, B).astype(np.float32),
        # targets at 0 and +-3 of the values: Huber's two branches, PPO's vf clip
        SampleBatch.VALUE_TARGETS: rng.normal(0, 1.5, B).astype(np.float32),
    }


def _module(obs_shape):
    dim = int(np.prod(obs_shape))
    shape = obs_shape if len(obs_shape) == 3 else None
    return (JaxModule(dim, A, hiddens=(32,), obs_shape=shape),
            DefaultActorCriticModule(dim, A, hiddens=(32,), obs_shape=shape))


def _assert_grads_close(got, want):
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * scale, (g.shape, scale)


@pytest.mark.parametrize("obs_shape", [(10,), (42, 42, 4)], ids=["mlp", "cnn"])
@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_and_gradients_match_jax_grad(name, obs_shape):
    rng = np.random.default_rng(7)
    jmod, tmod = _module(obs_shape)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(0)))
    batch = _batch(rng, obs_shape)
    jloss, tloss = LOSSES[name]
    (want, wm), wg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(jmod, p, b), has_aux=True))(params, batch)
    tp = from_jax_rl_params(params, device="cpu")
    for t in tree_leaves(tp):
        t.requires_grad_(True)
    got, gm = tloss(tmod, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5, rtol=1e-5)
    assert set(gm) == set(wm)
    for k in wm:
        np.testing.assert_allclose(gm[k].item(), float(wm[k]), atol=1e-5, rtol=1e-5, err_msg=k)
    grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in tree_leaves(tp)]
    _assert_grads_close(grads, wg)


def test_advantages_use_the_population_std():
    """``jnp.std`` divides by n: at n 2 Bessel's correction would scale
    the normalized advantages by 1/sqrt(2)."""
    adv = torch.tensor([1.0, 3.0])
    np.testing.assert_allclose(ppo.normalize(adv).numpy(), [-1.0, 1.0], atol=1e-6)


def _trajectory(rng, n):
    return {
        SampleBatch.REWARDS: rng.normal(size=n).astype(np.float32),
        SampleBatch.VF_PREDS: rng.normal(size=n).astype(np.float32),
        SampleBatch.TERMINATEDS: rng.random(n) < 0.1,
        SampleBatch.TRUNCATEDS: rng.random(n) < 0.1,
    }


@pytest.mark.parametrize("last_value", [0.0, 1.7])
def test_compute_gae_equals_the_jax_package(last_value):
    cols = _trajectory(np.random.default_rng(3), 200)
    want = jax_gae(JaxBatch({k: v.copy() for k, v in cols.items()}), last_value, 0.97, 0.9)
    got = compute_gae(SampleBatch({k: v.copy() for k, v in cols.items()}), last_value, 0.97, 0.9)
    for k in (SampleBatch.ADVANTAGES, SampleBatch.VALUE_TARGETS):
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("clips", [(1.0, 1.0), (0.5, 2.0)])
def test_compute_vtrace_equals_the_jax_package(clips):
    rng = np.random.default_rng(4)
    n = 50
    args = (rng.normal(-1.5, 0.3, n).astype(np.float32),
            rng.normal(-1.5, 0.3, n).astype(np.float32),
            rng.normal(size=n).astype(np.float32), 0.4,
            rng.normal(size=n).astype(np.float32), 0.99, *clips)
    for got, want in zip(impala.compute_vtrace(*args), jimpala.compute_vtrace(*args)):
        np.testing.assert_array_equal(got, want)


def test_minibatches_come_in_the_jax_package_order():
    rng = np.random.default_rng(5)
    cols = {"x": np.arange(70), "y": rng.normal(size=(70, 3))}
    want = list(JaxBatch(cols).minibatches(16, np.random.default_rng(11)))
    got = list(SampleBatch(cols).minibatches(16, np.random.default_rng(11)))
    assert len(got) == len(want) == 4  # the ragged tail of 6 is dropped
    for g, w in zip(got, want):
        for k in cols:
            np.testing.assert_array_equal(g[k], w[k])


def test_train_one_step_matches_the_jax_package():
    """PPO, 3 epochs of minibatches of 16 over 56 rows (a ragged tail):
    the same minibatches in the same order on the device, and so the same
    weights and mean metrics."""
    rng = np.random.default_rng(6)
    loss = (jppo.make_ppo_loss(0.2, 10.0, 0.5, 0.01), ppo.make_ppo_loss(0.2, 10.0, 0.5, 0.01))
    jpol = JaxPolicy(10, A, hiddens=(32,), loss_fn=loss[0], lr=1e-3)
    tpol = TorchPolicy(10, A, hiddens=(32,), loss_fn=loss[1], lr=1e-3, device="cpu")
    tpol.set_weights(jpol.get_weights())
    cols = _batch(rng, (10,))
    cols = {k: np.concatenate([v, v[:32]]) for k, v in cols.items()}  # 56 rows
    kw = dict(num_sgd_iter=3, sgd_minibatch_size=16, required_keys=ppo.PPO_KEYS)
    want = jax_train_one_step(jpol, JaxBatch(cols), rng=np.random.default_rng(9), **kw)
    got = train_one_step(tpol, SampleBatch(cols), rng=np.random.default_rng(9), **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-5, err_msg=k)
    tree_map(lambda g, w: np.testing.assert_allclose(g, w, atol=1e-5),
             tpol.get_weights(), jpol.get_weights())
