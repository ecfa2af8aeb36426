"""The port's training path against the JAX package's, from the same weights.

Weights (and, for the trajectories, the whole train state) are made by
the JAX package and carried over by ``convert``; tokens come from numpy.
Tiny configs in f32 on the CPU.  Tolerances: loss and gradients atol
1e-5, optimizer trajectories (losses and params after 5 steps) atol 1e-5,
the schedule rtol 1e-6 plus two f32 ulps of the peak lr (optax evaluates
it in f32, the port in f64).  The gap the tolerances cover is f32
arithmetic in another order, plus ``clip_grad_norm_``'s ``norm + 1e-6``
divisor where optax divides by the norm (a relative 1e-6 / norm on a
clipped gradient, cancelled by Adam's normalisation down to its eps).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.util import flops as jflops
from ray_tpu_torch.convert import from_jax_params, from_jax_train_state
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.transformer import named_leaves
from ray_tpu_torch.util import flops as tflops

ATOL = 1e-5
OPT = dict(lr=1e-3, warmup=2, total_steps=10)

FAMILIES = {
    "gpt2": (jgpt2, jgpt2.GPT2Config.tiny, tgpt2, tgpt2.GPT2Config.tiny),
    "llama": (jllama, jllama.LlamaConfig.tiny, tllama, tllama.LlamaConfig.tiny),
}


def _configs(family, **kw):
    jmod, jcfg_fn, tmod, tcfg_fn = FAMILIES[family]
    return jmod, jcfg_fn(dtype=jnp.float32, **kw), tmod, tcfg_fn(dtype=torch.float32, **kw)


def _tokens(vocab, seed=0, b=2, t=16):
    return np.random.default_rng(seed).integers(0, vocab, (b, t + 1)).astype(np.int32)


def _batches(toks, form):
    if form == "tokens":
        return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks).long()}
    j = {"inputs": jnp.asarray(toks[:, :-1]), "targets": jnp.asarray(toks[:, 1:])}
    return j, {k: torch.from_numpy(np.array(v)).long() for k, v in j.items()}


def _flat(tree):
    return dict(named_leaves(jax.tree.map(np.asarray, tree)))


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("form", ["tokens", "inputs"])
def test_loss_and_grads_match_jax(family, form):
    jmod, jcfg, tmod, tcfg = _configs(family)
    jp = jmod.init(jcfg, jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    for _, t in named_leaves(tp):
        t.requires_grad_(True)
    jb, tb = _batches(_tokens(jcfg.vocab_size), form)
    jloss, jgrads = jax.value_and_grad(jmod.loss_fn)(jp, jb, jcfg)
    loss = tmod.loss_fn(tp, tb, tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=ATOL, rtol=0)
    jg = _flat(jgrads)
    for name, t in named_leaves(tp):
        np.testing.assert_allclose(t.grad.numpy(), jg[name], atol=ATOL, rtol=0, err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax_trajectory(family):
    """The JAX package's train state before and after each of 5 jitted
    steps on one batch, and the 5 losses; built once per family and shared
    by the tests that hold the port's steps against it."""
    jmod, jcfg, _, _ = _configs(family)
    toks = _tokens(jcfg.vocab_size, seed=1)
    opt = jmod.make_optimizer(**OPT)
    state = jmod.init_state(jcfg, jax.random.PRNGKey(0), opt)
    step = jax.jit(jmod.make_train_step(jcfg, opt))
    states, losses = [state], []
    for _ in range(5):
        state, m = step(state, {"tokens": jnp.asarray(toks)})
        states.append(state)
        losses.append(float(m["loss"]))
    return toks, states, losses


def _port_run(tmod, tcfg, state, n_steps, toks):
    step = tmod.make_train_step(tcfg, tmod.make_optimizer(**OPT))
    losses = []
    for _ in range(n_steps):
        state, m = step(state, {"tokens": torch.from_numpy(toks).long()})
        losses.append(m["loss"].item())
    return state, losses


def _assert_params_close(tstate, jstate):
    jp = _flat(jstate["params"])
    for name, t in named_leaves(tstate["params"]):
        np.testing.assert_allclose(t.detach().numpy(), jp[name], atol=ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_train_steps_match_jax(family):
    """5 steps of make_train_step from the same state: the losses and the
    final params.  The first update runs at lr = schedule(0) = 0 in both,
    so it leaves every param as it was (weight decay included)."""
    _, _, tmod, tcfg = _configs(family)
    toks, jstates, jlosses = _jax_trajectory(family)
    state = from_jax_train_state(jax.tree.map(np.asarray, jstates[0]), tcfg,
                                 tmod.make_optimizer(**OPT), device="cpu")
    before = {n: t.detach().clone() for n, t in named_leaves(state["params"])}
    state, first = _port_run(tmod, tcfg, state, 1, toks)
    for name, t in named_leaves(state["params"]):
        assert torch.equal(t.detach(), before[name]), name
    state, rest = _port_run(tmod, tcfg, state, 4, toks)
    np.testing.assert_allclose(first + rest, jlosses, atol=ATOL, rtol=0)
    assert first[0] == rest[0] and jlosses[0] == jlosses[1]
    assert state["step"] == int(jstates[5]["step"]) == 5
    _assert_params_close(state, jstates[5])


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_resume_from_jax_train_state(family):
    """2 JAX steps, then 3 port steps from the converted state, against 5
    JAX steps."""
    _, _, tmod, tcfg = _configs(family)
    toks, jstates, jlosses = _jax_trajectory(family)
    state = from_jax_train_state(jax.tree.map(np.asarray, jstates[2]), tcfg,
                                 tmod.make_optimizer(**OPT), device="cpu")
    assert state["step"] == 2
    assert state["opt_state"]["adamw"].param_groups[0]["lr"] == pytest.approx(
        float(optax.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10, 1e-4)(2)), rel=1e-6)
    state, losses = _port_run(tmod, tcfg, state, 3, toks)
    np.testing.assert_allclose(losses, jlosses[2:], atol=ATOL, rtol=0)
    _assert_params_close(state, jstates[5])


@pytest.mark.parametrize("lr,warmup,total", [(1e-3, 2, 10), (3e-4, 100, 10000),
                                             (5e-4, 10, 5), (2e-4, 0, 50)])
def test_schedule_matches_optax(lr, warmup, total):
    port = tgpt2.make_optimizer(lr=lr, warmup=warmup, total_steps=total)
    ref = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(total, warmup + 1), lr * 0.1)
    counts = list(range(total + 3)) if total < 100 else [0, 1, 50, 99, 100, 101, 5000, 10002]
    for c in counts:  # optax's f32 warm-up, (0 - lr)·frac + lr, loses up to an ulp of lr
        np.testing.assert_allclose(port.schedule(c), float(ref(c)), rtol=1e-6, atol=lr * 2e-7,
                                   err_msg=f"count {c}")
    assert port.schedule(0) == (0.0 if warmup else lr)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_decay_groups_match_the_jax_mask(family):
    """Decayed exactly where the JAX mask says ``x.ndim >= 2`` on the
    stacked tree: every block leaf (norms and biases included), not the
    final norm."""
    jmod, jcfg, tmod, tcfg = _configs(family)
    jp = jmod.init(jcfg, jax.random.PRNGKey(0))
    mask = dict(named_leaves(jax.tree.map(lambda x: x.ndim >= 2, jp)))
    state = tmod.init_state(tcfg, torch.Generator().manual_seed(0),
                            tmod.make_optimizer(**OPT), device="cpu")
    ids = {id(t): n for n, t in named_leaves(state["params"])}
    groups = state["opt_state"]["adamw"].param_groups
    decayed = {ids[id(t)] for g in groups if g["weight_decay"] > 0 for t in g["params"]}
    assert decayed == {n for n, m in mask.items() if m}
    assert all(g["weight_decay"] in (0.0, 0.1) for g in groups)
    assert "blocks/" + ("ln1_w" if family == "gpt2" else "attn_norm") in decayed


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_remat_policies_give_the_same_gradients(family):
    """remat off, "full" and "dots" give the same loss and gradients; the
    backward of "full" re-runs the forward's weight products and that of
    "dots" does not (they were saved); an unknown policy raises."""
    _, _, tmod, _ = _configs(family)
    toks = torch.from_numpy(_tokens(512, seed=3)).long()
    grads, mm = {}, {}
    for name, kw in [("off", dict(remat=False)), ("full", dict(remat=True, remat_policy="full")),
                     ("dots", dict(remat=True, remat_policy="dots"))]:
        _, _, _, tcfg = _configs(family, **kw)
        params = tmod.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
        for _, t in named_leaves(params):
            t.requires_grad_(True)
        loss = tmod.loss_fn(params, {"tokens": toks}, tcfg)
        with _CountMM() as counter:
            loss.backward()
        grads[name] = (loss.item(), {n: t.grad for n, t in named_leaves(params)})
        mm[name] = counter.mm
    for name in ("full", "dots"):
        assert grads[name][0] == grads["off"][0]
        for leaf, g in grads[name][1].items():
            torch.testing.assert_close(g, grads["off"][1][leaf], atol=1e-6, rtol=0, msg=leaf)
    assert mm["dots"] == mm["off"] < mm["full"]
    _, _, _, bad = _configs(family, remat=True, remat_policy="nothing")
    params = tmod.init(bad, device="cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        tmod.loss_fn(params, {"tokens": toks}, bad)


def test_train_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = tgpt2.make_optimizer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgpt2.init_state(tgpt2.GPT2Config.tiny(), None, opt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tllama.init_state(tllama.LlamaConfig.tiny(), None, opt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_train_state({"params": {}}, tgpt2.GPT2Config.tiny(), opt)


def test_flops_match_jax_and_peak_is_the_cards():
    for args in [(124_475_904, 12, 768, 1024), (1, 2, 64, 128), (10**9, 24, 2048, 2048)]:
        assert tflops.transformer_flops_per_token(*args) == jflops.transformer_flops_per_token(*args)
    jcfg, tcfg = jgpt2.GPT2Config.gpt2_small(), tgpt2.GPT2Config.gpt2_small(n_layers=1)
    n = tgpt2.num_params(tgpt2.init(tcfg, device="meta"))
    assert n == jgpt2.num_params(jax.eval_shape(
        lambda k: jgpt2.init(jgpt2.GPT2Config.gpt2_small(n_layers=1), k), jax.random.PRNGKey(0)))
    assert tflops.model_flops_per_token(tcfg, n) == jflops.model_flops_per_token(tcfg, n)
    assert tflops.model_flops_per_token(jcfg, n) == jflops.model_flops_per_token(jcfg, n)
    assert tflops.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert tflops.mfu(1000.0, 1e9, "NVIDIA H100 80GB HBM3") == pytest.approx(1e12 / 989e12)
    for kind in ("TPU v5 lite", "cpu", ""):
        with pytest.raises(KeyError):
            tflops.peak_flops(kind)


class _CountFullLayerOps(TorchDispatchMode):
    """Counts, by op name, the ops whose output is a whole stacked
    ``[L, ...]`` f32 tensor (one of ``shapes``)."""

    def __init__(self, shapes):
        super().__init__()
        self.shapes = shapes
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if (isinstance(t, torch.Tensor) and t.dtype == torch.float32
                    and tuple(t.shape) in self.shapes):
                name = func.overloadpacket.__name__
                self.counts[name] = self.counts.get(name, 0) + 1
        return out


def _select_per_layer(blocks):
    """The stack's former way to each layer's params: ``v[l]`` per layer."""
    n = next(iter(blocks.values())).shape[0]
    return [{k: v[l] for k, v in blocks.items()} for l in range(n)]


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("remat", ["off", "dots", "full"])
def test_stacked_leaves_get_their_gradients_without_full_size_adds(family, remat, monkeypatch):
    """One train step over 4 layers: with one unbind per stacked leaf no op
    writes a whole ``[L, ...]`` gradient per layer (no ``select_backward``)
    and none adds such gradients up (no ``add``); indexing each layer, as
    the step did before, does both.  The loss, every gradient and every
    updated param are bit-equal either way."""
    from ray_tpu_torch.models import transformer

    kw = dict(n_layers=4, remat=remat != "off")
    if remat != "off":
        kw["remat_policy"] = remat
    _, _, tmod, tcfg = _configs(family, **kw)
    toks = torch.from_numpy(_tokens(tcfg.vocab_size, seed=5)).long()
    runs = {}
    for way in ("unbind", "select"):
        if way == "select":
            monkeypatch.setattr(transformer, "layers", _select_per_layer)
            monkeypatch.setattr(tllama, "layers", _select_per_layer)
        opt = tgpt2.make_optimizer(**OPT)
        state = tmod.init_state(tcfg, torch.Generator().manual_seed(0), opt, device="cpu")
        shapes = {tuple(t.shape) for n, t in named_leaves(state["params"])
                  if n.startswith("blocks/")}
        with _CountFullLayerOps(shapes) as counter:
            state, metrics = tmod.make_train_step(tcfg, opt)(state, {"tokens": toks})
        runs[way] = (counter.counts, metrics["loss"],
                     {n: (t.grad, t.detach()) for n, t in named_leaves(state["params"])})
    counts = runs["unbind"][0]
    assert counts.get("select_backward", 0) == 0 and counts.get("add", 0) == 0, counts
    old = runs["select"][0]
    assert old["select_backward"] > 0 and old["add"] > 0, old
    assert torch.equal(runs["unbind"][1], runs["select"][1])
    for name, (grad, param) in runs["unbind"][2].items():
        assert torch.equal(grad, runs["select"][2][name][0]), name
        assert torch.equal(param, runs["select"][2][name][1]), name
