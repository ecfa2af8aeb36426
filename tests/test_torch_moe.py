"""The port's Switch MoE against ray_tpu.ops.moe and an MoE GPT-2's
training against the JAX package's, from the same weights.

Inputs come from numpy seeds; weights are made by the JAX package and
carried over by ``convert``.  f32 on the CPU.  Tolerances: ``moe_ffn``'s
output, aux and gradients atol 1e-5 (the expert products sum in another
order; the dispatch and combine are exact in both); the GPT-2 loss,
gradients and 5-step trajectory atol 1e-5, as in ``test_torch_train.py``;
bf16 ``moe_ffn`` 2e-2 absolute and relative (a few bf16 ulps, 2^-8
relative each: the two packages round the expert products, biases and
GELU at other places).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.ops import moe as jmoe
from ray_tpu_torch.convert import from_jax_params, from_jax_train_state
from ray_tpu_torch.models import generate
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.transformer import named_leaves
from ray_tpu_torch.ops import moe as tmoe
from ray_tpu_torch.serve.llm import GenerationEngine

ATOL = 1e-5
OPT = dict(lr=1e-3, warmup=2, total_steps=10)
NAMES = ("x", "router", "w1", "b1", "w2", "b2")


def _moe_inputs(seed=0, b=2, t=24, d=32, e=4, f=64):
    rng = np.random.default_rng(seed)
    n = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    return {"x": n(b, t, d), "router": n(d, e), "w1": n(e, d, f, scale=0.2),
            "b1": n(e, f, scale=0.1), "w2": n(e, f, d, scale=0.2), "b2": n(e, d, scale=0.1)}


def _jax_moe(a, cf):
    return jmoe.moe_ffn(*(a[k] for k in NAMES), capacity_factor=cf)


def _torch_moe(a, cf):
    return tmoe.moe_ffn(*(a[k] for k in NAMES), capacity_factor=cf)


def _scalar(y, aux):
    """A scalar that reads every output element and the aux loss."""
    return (y * y).mean() + y.mean() + 0.1 * aux


@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_moe_ffn_matches_jax(cf):
    """cf 0.5 leaves room for half the tokens: some are dropped, and their
    output rows are zero in both."""
    a = _moe_inputs()
    jy, jaux = _jax_moe({k: jnp.asarray(v) for k, v in a.items()}, cf)
    ty, taux = _torch_moe({k: torch.from_numpy(v) for k, v in a.items()}, cf)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=ATOL, rtol=0)
    dropped = (np.asarray(jy) == 0).all(-1)
    assert dropped.any() == (cf < 1.0)
    np.testing.assert_array_equal((ty.numpy() == 0).all(-1), dropped)


@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_moe_ffn_gradients_match_jax(cf):
    a = _moe_inputs(seed=1)
    jgrads = jax.grad(lambda p: _scalar(*_jax_moe(p, cf)))(
        {k: jnp.asarray(v) for k, v in a.items()})
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in a.items()}
    _scalar(*_torch_moe(tp, cf)).backward()
    for k in NAMES:
        assert float(np.abs(np.asarray(jgrads[k])).max()) > 0, k
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgrads[k]),
                                   atol=ATOL, rtol=0, err_msg=k)


def test_moe_ffn_bf16_matches_jax():
    """bf16 activations and experts with the f32 router, as a block
    passes them."""
    a = _moe_inputs(seed=2)
    cast = lambda k, v: v if k == "router" else v.astype(jnp.bfloat16)
    jy, jaux = _jax_moe({k: cast(k, jnp.asarray(v)) for k, v in a.items()}, 2.0)
    ty, taux = _torch_moe({k: torch.from_numpy(v).to(torch.float32 if k == "router"
                                                      else torch.bfloat16)
                           for k, v in a.items()}, 2.0)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=ATOL, rtol=0)


def test_moe_ffn_rejects_a_mesh():
    """The expert-parallel path runs on DTensors, on their own mesh
    (tests/test_torch_sharded_train.py): plain tensors with a mesh raise."""
    a = {k: torch.from_numpy(v) for k, v in _moe_inputs().items()}
    with pytest.raises(ValueError, match="DTensors"):
        tmoe.moe_ffn(*(a[k] for k in NAMES), mesh=object())


def test_moe_logical_axes_match_jax():
    assert tmoe.moe_logical_axes() == jmoe.moe_logical_axes()


def _configs(**kw):
    return (jgpt2.GPT2Config.tiny(dtype=jnp.float32, n_experts=4, **kw),
            tgpt2.GPT2Config.tiny(dtype=torch.float32, n_experts=4, **kw))


def _tokens(vocab, seed=0, b=2, t=16):
    return np.random.default_rng(seed).integers(0, vocab, (b, t + 1)).astype(np.int32)


def _flat(tree):
    return dict(named_leaves(jax.tree.map(np.asarray, tree)))


def test_moe_init_matches_jax_tree():
    """The port's init draws the JAX package's tree of shapes, the MoE
    leaves in place of the dense FFN."""
    jcfg, tcfg = _configs()
    jshapes = dict(named_leaves(jax.eval_shape(lambda k: jgpt2.init(jcfg, k),
                                               jax.random.PRNGKey(0))))
    tshapes = dict(named_leaves(tgpt2.init(tcfg, device="cpu")))
    assert {n: tuple(s.shape) for n, s in jshapes.items()} == \
        {n: tuple(t.shape) for n, t in tshapes.items()}
    assert "blocks/ew1" in tshapes and "blocks/w1" not in tshapes


def test_moe_gpt2_loss_and_grads_match_jax():
    jcfg, tcfg = _configs()
    jp = jgpt2.init(jcfg, jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    for _, t in named_leaves(tp):
        t.requires_grad_(True)
    toks = _tokens(jcfg.vocab_size)
    jloss, jgrads = jax.jit(jax.value_and_grad(jgpt2.loss_fn), static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks)}, jcfg)
    loss = tgpt2.loss_fn(tp, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=ATOL, rtol=0)
    _, jaux = jax.jit(lambda p, t: jgpt2.apply(p, t, jcfg, return_aux=True))(
        jp, jnp.asarray(toks[:, :-1]))
    with torch.no_grad():
        _, aux = tgpt2.apply(tp, torch.from_numpy(toks[:, :-1]).long(), tcfg, return_aux=True)
    assert float(jaux) > 0
    np.testing.assert_allclose(aux.item(), float(jaux), atol=ATOL, rtol=0)
    jg = _flat(jgrads)
    for name, t in named_leaves(tp):
        np.testing.assert_allclose(t.grad.numpy(), jg[name], atol=ATOL, rtol=0, err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax_trajectory():
    jcfg, _ = _configs()
    toks = _tokens(jcfg.vocab_size, seed=1)
    opt = jgpt2.make_optimizer(**OPT)
    state = jgpt2.init_state(jcfg, jax.random.PRNGKey(0), opt)
    step = jax.jit(jgpt2.make_train_step(jcfg, opt))
    states, losses = [state], []
    for _ in range(5):
        state, m = step(state, {"tokens": jnp.asarray(toks)})
        states.append(state)
        losses.append(float(m["loss"]))
    return toks, states, losses


def test_moe_gpt2_train_steps_match_jax():
    """5 steps of make_train_step from the same state: the losses and the
    final params, every MoE leaf included."""
    _, tcfg = _configs()
    toks, jstates, jlosses = _jax_trajectory()
    opt = tgpt2.make_optimizer(**OPT)
    state = from_jax_train_state(jax.tree.map(np.asarray, jstates[0]), tcfg, opt, device="cpu")
    step = tgpt2.make_train_step(tcfg, opt)
    losses = []
    for _ in range(5):
        state, m = step(state, {"tokens": torch.from_numpy(toks).long()})
        losses.append(m["loss"].item())
    np.testing.assert_allclose(losses, jlosses, atol=ATOL, rtol=0)
    jp = _flat(jstates[5]["params"])
    for name, t in named_leaves(state["params"]):
        np.testing.assert_allclose(t.detach().numpy(), jp[name], atol=ATOL, rtol=0,
                                   err_msg=name)


def test_moe_decay_groups_match_the_jax_mask():
    """Every MoE leaf has ndim >= 2 on the stacked tree, so optax's mask
    decays each of them; the port's decayed group is the same set."""
    jcfg, tcfg = _configs()
    mask = _flat(jax.tree.map(lambda x: x.ndim >= 2, jgpt2.init(jcfg, jax.random.PRNGKey(0))))
    params = tgpt2.init(tcfg, device="cpu")
    opt_state = tgpt2.make_optimizer(**OPT).init(params)
    decayed = {id(t) for g in opt_state["adamw"].param_groups if g["weight_decay"] > 0
               for t in g["params"]}
    got = {name: id(t) in decayed for name, t in named_leaves(params)}
    assert got == mask
    for leaf in ("router", "ew1", "eb1", "ew2", "eb2"):
        assert got[f"blocks/{leaf}"], leaf


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_moe_remat_policies_give_the_same_loss_and_grads(policy):
    """Remat recomputes the MoE block (its routing included) in the
    backward; the loss and gradients equal those of no remat."""
    _, tcfg = _configs()
    params = tgpt2.init(tcfg, torch.Generator().manual_seed(3), device="cpu")
    toks = {"tokens": torch.from_numpy(_tokens(tcfg.vocab_size, seed=2)).long()}
    out = {}
    for name, cfg in (("none", tcfg), (policy, tgpt2.GPT2Config.tiny(
            dtype=torch.float32, n_experts=4, remat=True, remat_policy=policy))):
        p = {k: ({n: t.clone().requires_grad_(True) for n, t in v.items()}
                 if isinstance(v, dict) else v.clone().requires_grad_(True))
             for k, v in params.items()}
        loss = tgpt2.loss_fn(p, toks, cfg)
        loss.backward()
        out[name] = (loss.item(), {n: t.grad for n, t in named_leaves(p)})
    assert out["none"][0] == out[policy][0]
    for n, g in out["none"][1].items():
        torch.testing.assert_close(out[policy][1][n], g, atol=1e-6, rtol=0)


def test_generation_rejects_an_moe_config():
    _, tcfg = _configs()
    with pytest.raises(NotImplementedError, match="MoE"):
        GenerationEngine(tcfg, device="cpu")
    params = tgpt2.init(tcfg, device="cpu")
    toks = torch.ones(1, 4, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="MoE"):
        generate.generate(params, tcfg, toks, torch.tensor([4]), max_new_tokens=2)
