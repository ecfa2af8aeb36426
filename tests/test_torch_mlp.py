"""The port's MLP classifier against ray_tpu.models.mlp, from the same
weights (made by the JAX package, carried over by ``convert``) and the
same numpy batch.  f32 on the CPU; tolerance 1e-5 absolute and relative
on the logits, the loss and every gradient leaf (the same f32 products in
another summation order); accuracy equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import mlp as jmlp
from ray_tpu_torch.convert import from_jax_params
from ray_tpu_torch.models import mlp as tmlp

TOL = 1e-5
CONFIGS = {"mnist": {}, "narrow": dict(in_dim=20, hidden=(16,), num_classes=3)}


def _pair(name, seed=0, batch=64):
    jcfg, tcfg = jmlp.MLPConfig(**CONFIGS[name]), tmlp.MLPConfig(**CONFIGS[name])
    jp = jmlp.init(jcfg, jax.random.PRNGKey(seed))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), None, device="cpu")
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, jcfg.in_dim)).astype(np.float32)
    y = rng.integers(0, jcfg.num_classes, batch).astype(np.int32)
    return (jcfg, jp, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
            tcfg, tp, {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()})


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_apply_loss_and_accuracy_match_jax(name):
    jcfg, jp, jb, tcfg, tp, tb = _pair(name)
    np.testing.assert_allclose(tmlp.apply(tp, tb["x"], tcfg).numpy(),
                               np.asarray(jmlp.apply(jp, jb["x"], jcfg)), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tmlp.loss_fn(tp, tb, tcfg).item(),
                               float(jmlp.loss_fn(jp, jb, jcfg)), atol=TOL, rtol=TOL)
    assert tmlp.accuracy(tp, tb, tcfg).item() == float(jmlp.accuracy(jp, jb, jcfg))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_gradients_match_jax(name):
    jcfg, jp, jb, tcfg, tp, tb = _pair(name, seed=1)
    jgrads = jax.grad(jmlp.loss_fn)(jp, jb, jcfg)
    for t in tp.values():
        t.requires_grad_(True)
    tmlp.loss_fn(tp, tb, tcfg).backward()
    assert set(tp) == set(jgrads)
    for k, t in tp.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrads[k]), atol=TOL, rtol=TOL,
                                   err_msg=k)


def test_init_matches_jax_shapes_and_scale():
    """The port's own init: the JAX package's shapes, He-normal weights
    (std sqrt(2 / fan_in)) and zero biases."""
    cfg = tmlp.MLPConfig()
    jshapes = jax.eval_shape(lambda k: jmlp.init(jmlp.MLPConfig(), k), jax.random.PRNGKey(0))
    params = tmlp.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: v.shape for k, v in jshapes.items()}
    for i, fan_in in enumerate((784, 512, 256)):
        assert abs(params[f"w{i}"].std().item() / (2.0 / fan_in) ** 0.5 - 1) < 0.05
        assert not params[f"b{i}"].any()
