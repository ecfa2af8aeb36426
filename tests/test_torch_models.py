"""The port's model forwards against ray_tpu.models, from the same weights.

Weights are made by the JAX package and carried over by
``convert.from_jax_params``; tokens come from numpy.  f32, atol 1e-4 on
the logits (two layers of the same f32 arithmetic in another summation
order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu_torch.convert import from_jax_params
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama

ATOL = 1e-4

FAMILIES = {
    "gpt2": (jgpt2, jgpt2.GPT2Config.tiny, tgpt2, tgpt2.GPT2Config.tiny),
    "llama": (jllama, jllama.LlamaConfig.tiny, tllama, tllama.LlamaConfig.tiny),
}


def _pair(family, seed=0):
    jmod, jcfg_fn, tmod, tcfg_fn = FAMILIES[family]
    jcfg, tcfg = jcfg_fn(dtype=jnp.float32), tcfg_fn(dtype=torch.float32)
    jp = jmod.init(jcfg, jax.random.PRNGKey(seed))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jmod, jcfg, jp, tmod, tcfg, tp


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("t", [1, 13, 64])
def test_apply_logits_match_jax(family, t):
    jmod, jcfg, jp, tmod, tcfg, tp = _pair(family)
    toks = np.random.default_rng(t).integers(0, jcfg.vocab_size, (2, t))
    want = np.asarray(jmod.apply(jp, jnp.asarray(toks), jcfg))
    got = tmod.apply(tp, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, t, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_gpt2_small_shapes_match_jax():
    """The 125M config: the port's own init gives the JAX package's tree
    of shapes (checked abstractly, nothing is drawn at full size)."""
    jcfg = jgpt2.GPT2Config.gpt2_small()
    jshapes = jax.eval_shape(lambda k: jgpt2.init(jcfg, k), jax.random.PRNGKey(0))
    tcfg = tgpt2.GPT2Config.gpt2_small(n_layers=1)
    tshapes = tgpt2.init(tcfg, device="meta")
    assert set(jshapes) == set(tshapes)
    for name, leaf in jshapes["blocks"].items():
        assert tuple(tshapes["blocks"][name].shape) == (1,) + leaf.shape[1:], name
    assert tuple(tshapes["wte"].shape) == jshapes["wte"].shape == (50304, 768)


def test_bf16_leaves_carry_their_bits():
    """An ml_dtypes bfloat16 leaf is reinterpreted, not rounded twice."""
    x = jnp.asarray(np.random.default_rng(0).standard_normal((3, 5)), jnp.bfloat16)
    tp = from_jax_params({"w": np.asarray(x)}, tgpt2.GPT2Config.tiny(), device="cpu")
    assert tp["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["w"].float().numpy(), np.asarray(x, np.float32))


def test_convert_rejects_wrong_depth():
    _, jcfg, jp, _, _, _ = _pair("gpt2")
    with pytest.raises(ValueError, match="layers"):
        from_jax_params(jax.tree.map(np.asarray, jp),
                        tgpt2.GPT2Config.tiny(n_layers=3), device="cpu")


def test_convert_without_a_config_rejects_uneven_depths():
    """With no config (a predictor's checkpoint), the block leaves must
    still agree with each other; a tree without blocks (the MLP) needs no
    depth at all."""
    blocks = {"w": np.zeros((2, 3), np.float32), "b": np.zeros((3, 3), np.float32)}
    with pytest.raises(ValueError, match="layers"):
        from_jax_params({"blocks": blocks}, None, device="cpu")
    blocks["b"] = np.zeros((2, 3), np.float32)
    assert from_jax_params({"blocks": blocks}, None, device="cpu")["blocks"]["b"].shape == (2, 3)
    assert set(from_jax_params({"w0": np.ones((4, 2))}, None, device="cpu")) == {"w0"}


def test_moe_and_mesh_are_not_ported():
    """A mesh takes the params as DTensors on it (``parallel.shard_params``):
    the stack raises for plain tensors with a mesh, for a dense and for an
    MoE config alike.  The sharded paths are held to the JAX package in
    test_torch_sharded_train.py; MoE on one device in test_torch_moe.py."""
    from ray_tpu_torch.models import transformer

    for cfg in (tgpt2.GPT2Config.tiny(dtype=torch.float32),
                tgpt2.GPT2Config.tiny(dtype=torch.float32, n_experts=4)):
        params = tgpt2.init(cfg, device="cpu")
        x = torch.zeros(1, 4, cfg.d_model)
        with pytest.raises(ValueError, match="DTensor"):
            transformer.apply_stack(x, params["blocks"], cfg, mesh=object())


def test_logical_axes_match_jax():
    """Every model's logical axes, dense and MoE, as the JAX package names
    them (they decide each leaf's placements on a mesh)."""
    from ray_tpu.models import bert as jbert
    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu.models import llama as jllama
    from ray_tpu_torch.models import bert as tbert
    from ray_tpu_torch.models import llama as tllama

    assert tllama.logical_axes() == jllama.logical_axes()
    for n in (0, 4):
        assert (tgpt2.logical_axes(tgpt2.GPT2Config.tiny(n_experts=n))
                == jgpt2.logical_axes(jgpt2.GPT2Config.tiny(n_experts=n)))
        assert (tbert.logical_axes(tbert.BertConfig.tiny(n_experts=n))
                == jbert.logical_axes(jbert.BertConfig.tiny(n_experts=n)))
