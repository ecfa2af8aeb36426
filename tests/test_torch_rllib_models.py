"""The port's RL model catalog and RLModule against ray_tpu.rllib's.

The same numpy inputs (``default_rng``) go through the JAX package's nets
and the port's, with the JAX package's weights carried across by
``convert.from_jax_rl_params``.  f32: forwards agree within 1e-5
absolute and relative.  The test imports both packages; the port imports
nothing of ray_tpu.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import models as jm
from ray_tpu.rllib import rl_module as jrl
from ray_tpu_torch.convert import from_jax_rl_params
from ray_tpu_torch.rllib import models as tm
from ray_tpu_torch.rllib import rl_module as trl
from ray_tpu_torch.util.tree import tree_leaves, tree_map

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _frames(rng, n, shape=(84, 84, 4)):
    return rng.integers(0, 256, (n, *shape), dtype=np.uint8)


@pytest.mark.parametrize("hiddens", [(64, 64), (16,)])
def test_mlp_actor_critic_forward(hiddens):
    rng = np.random.default_rng(0)
    params = _np(jm.init_actor_critic(jax.random.PRNGKey(1), 8, 5, hiddens))
    obs = rng.standard_normal((12, 8)).astype(np.float32)
    want = jax.jit(jm.apply_model)(params, jnp.asarray(obs))
    got = tm.apply_model(from_jax_rl_params(params, device="cpu"), _t(obs))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("obs_shape,filters,hiddens", [
    ((84, 84, 4), jm.NATURE_CONV_FILTERS, (256,)),
    # not square and other strides: the (h, w, c) flatten order and the
    # ConvSpec's strides are what make the logits right
    ((44, 36, 3), ((8, 5, 3), (16, 3, 2)), (24,)),
])
def test_conv_actor_critic_forward_on_uint8_frames(obs_shape, filters, hiddens):
    """uint8 frames, cast to f32/255 inside ``apply_model`` in both."""
    rng = np.random.default_rng(1)
    params = _np(jm.init_conv_actor_critic(jax.random.PRNGKey(2), obs_shape, 6,
                                           conv_filters=filters, hiddens=hiddens))
    frames = _frames(rng, 5, obs_shape)
    want = jax.jit(jm.apply_model)(params, jnp.asarray(frames))
    tp = from_jax_rl_params(params, device="cpu")
    assert isinstance(tp["conv_spec"], tm.ConvSpec)
    assert tp["conv_spec"].filters == tuple(tuple(f) for f in filters)
    got = tm.apply_model(tp, _t(frames))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # float frames already scaled take the same path without the cast
    scaled = tm.apply_model(tp, _t(frames.astype(np.float32) / 255.0))
    np.testing.assert_allclose(scaled[0].numpy(), got[0].numpy(), atol=1e-6)


def test_conv_trunk_width_and_init_layout():
    """The port's own init: HWIO kernels, the flat width JAX's
    ``eval_shape`` gives, zero biases, and the same leaf shapes."""
    jp = _np(jm.init_conv_actor_critic(jax.random.PRNGKey(0), (84, 84, 4), 6))
    tp = tm.init_conv_actor_critic(torch.Generator().manual_seed(0), (84, 84, 4), 6,
                                   device="cpu")
    assert tm.conv_out_hw(84, 84, tm.NATURE_CONV_FILTERS) == (7, 7)
    shapes = tree_map(lambda t: tuple(t.shape), tp)
    assert shapes == tree_map(lambda a: a.shape, from_jax_rl_params(jp, device="cpu"))
    assert tp["pi"][0]["w"].shape == (3136, 256)
    assert all(float(layer["b"].abs().max()) == 0 for layer in tp["conv"] + tp["pi"])
    # ConvSpec is metadata: 14 leaves (3 convs, 2 layers in each head), no strides
    assert len(tree_leaves(tp)) == 14
    n = sum(t.numel() for t in tree_leaves(tp))
    assert n == sum(a.size for a in jax.tree_util.tree_leaves(jp))
    # the last policy layer is down-scaled, the value layer is not
    assert float(tp["pi"][-1]["w"].std()) < 0.01 * 3 / np.sqrt(256)


def test_gaussian_actor_and_q_network_forward():
    rng = np.random.default_rng(2)
    actor = _np(jm.init_gaussian_actor(jax.random.PRNGKey(3), 5, 2))
    q = _np(jm.init_q_network(jax.random.PRNGKey(4), 5, 2))
    # push log_std past its bounds on some rows: the clip must agree
    actor["layers"][-1]["w"] = actor["layers"][-1]["w"] * 4000.0
    obs = rng.standard_normal((9, 5)).astype(np.float32)
    act = rng.uniform(-1, 1, (9, 2)).astype(np.float32)
    want = jax.jit(jm.apply_gaussian_actor)(actor, jnp.asarray(obs))
    got = tm.apply_gaussian_actor(from_jax_rl_params(actor, device="cpu"), _t(obs))
    assert float(got[1].max()) == 2.0 or float(got[1].min()) == -20.0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(
        tm.apply_q_network(from_jax_rl_params(q, device="cpu"), _t(obs), _t(act)).numpy(),
        np.asarray(jm.apply_q_network(q, jnp.asarray(obs), jnp.asarray(act))), **TOL)


@pytest.mark.parametrize("obs_shape", [None, (84, 84, 4)])
def test_default_module_forwards(obs_shape):
    """``DefaultActorCriticModule``: the same columns from the same
    weights, on every forward."""
    rng = np.random.default_rng(3)
    jmod = jrl.DefaultActorCriticModule(16, 6, hiddens=(32,), obs_shape=obs_shape)
    tmod = trl.DefaultActorCriticModule(16, 6, hiddens=(32,), obs_shape=obs_shape)
    params = _np(jmod.init(jax.random.PRNGKey(5)))
    obs = (_frames(rng, 3) if obs_shape else
           rng.standard_normal((3, 16)).astype(np.float32))
    tp = from_jax_rl_params(params, device="cpu")
    own = tree_map(lambda t: t.shape, tmod.init(torch.Generator().manual_seed(0), device="cpu"))
    assert own == tree_map(lambda t: t.shape, tp)
    for fwd in ("forward_train", "forward_exploration", "forward_inference"):
        want = jax.jit(getattr(jmod, fwd))(params, jnp.asarray(obs))
        got = getattr(tmod, fwd)(tp, _t(obs))
        assert set(got) == set(want) == {trl.Columns.ACTION_DIST_INPUTS, trl.Columns.VF_PREDS}
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)


def test_rl_module_base_raises():
    with pytest.raises(NotImplementedError):
        trl.RLModule().init(torch.Generator(), device="cpu")
    with pytest.raises(NotImplementedError):
        trl.RLModule().forward_inference({}, torch.zeros(1))


_Pair = collections.namedtuple("_Pair", "a b")


def test_tree_map_keeps_structure_and_metadata():
    spec = tm.ConvSpec(((1, 2, 3),))
    tree = {"x": [np.ones(2), (np.zeros(()), "tag")], "s": spec, "n": None,
            "p": _Pair(np.arange(3), torch.ones(1))}
    out = tree_map(lambda a: a * 2, tree)
    assert out["s"] is spec and out["n"] is None and out["x"][1][1] == "tag"
    assert isinstance(out["p"], _Pair) and isinstance(out["x"][1], tuple)
    np.testing.assert_array_equal(out["p"].a, [0, 2, 4])
    assert len(tree_leaves(tree)) == 4
    summed = tree_map(lambda a, b: a + b, {"u": np.ones(2), "v": [np.ones(1)]},
                      {"v": [np.ones(1)], "u": np.ones(2)})
    np.testing.assert_array_equal(summed["u"], [2, 2])
    with pytest.raises(ValueError):
        tree_map(lambda a, b: a, {"u": [np.ones(1)]}, {"u": [np.ones(1), np.ones(1)]})
    with pytest.raises(ValueError):
        tree_map(lambda a, b: a, {"u": np.ones(1)}, {"u": "text"})
