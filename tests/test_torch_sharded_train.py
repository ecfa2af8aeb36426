"""Sharded train steps of the port on a 4-rank gloo world on the CPU,
held to the port's unsharded step and to the JAX package's sharded step.

A module-scoped fixture draws each case's params with the JAX ``init``,
hands them to the ranks as numpy (``convert.from_jax_params``, then
``shard_params``) and runs ``torch_world_cases.sharded_train`` once; the
JAX sharded losses are computed here, on the same mesh shapes over 4 of
conftest's 8 virtual devices, while the world runs.  The cases: GPT-2
tiny over tp2 x sp2 and fsdp2 x dp2, the Switch-MoE GPT-2 over pp2 x ep2
with capacity factor 1.0 (and a router skewed by its init, so tokens are
dropped) and 2 microbatches, and over dp2 x ep2 and sp2 x ep2, where each
rank routes only its own tokens, and Llama tiny with GQA over tp2 x sp2.  The
token embedding's init is scaled up so that the gradient norm exceeds the
clip's 1.0, and the clip's global norm is put to the test.

Tolerances: the loss within 1e-5 relative of the unsharded step and
within 1e-4 of the JAX sharded step; each (clipped) gradient leaf within
1e-5 of its largest entry.  The params after the step are held, within
1e-5 of each leaf's largest entry, to the unsharded optimizer applied to
the sharded step's own gradients: Adam's first step divides each
gradient by its magnitude plus 1e-8, so where a gradient is near 1e-8 it
turns the reduction-order noise between two correct steps into updates
up to the learning rate apart.
"""

import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as JP

import torch_world_cases as cases
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.parallel import MeshSpec, create_mesh
from ray_tpu.parallel.sharding import rules_for_mesh
from ray_tpu_torch.parallel.spawn import run_world

W = cases.WORLD
CASES = sorted(cases.TRAIN_CASES)


def _jax_config(case, **over):
    model, kw, _ = cases.TRAIN_CASES[case]
    kw = {**kw, **over}
    if model == "gpt2":
        return jgpt2, jgpt2.GPT2Config.tiny(dtype=jnp.float32, **kw)
    return jllama, jllama.LlamaConfig.tiny(dtype=jnp.float32, **kw)


def _jax_params(case):
    model, cfg = _jax_config(case)
    params = jax.tree.map(np.asarray, model.init(cfg, jax.random.PRNGKey(3)))
    emb = "wte" if "wte" in params else "tok_emb"
    params[emb] = params[emb] * cases.EMBED_SCALE
    if "router" in params.get("blocks", {}):
        params["blocks"]["router"] = params["blocks"]["router"] * cases.ROUTER_SKEW
    return params


def _jax_sharded_loss(case, params):
    model, cfg = _jax_config(case)
    mesh = create_mesh(MeshSpec(**cases.TRAIN_CASES[case][2]), devices=jax.devices()[:W],
                       keep_unit_axes=True)
    shard = model.param_shardings(mesh, rules_for_mesh(mesh), cfg)
    batch = jax.device_put(cases.train_batch(cfg.vocab_size, cfg.max_seq_len),
                           NamedSharding(mesh, JP(("dp", "fsdp"), "sp")))
    loss = jax.jit(lambda p, b: model.loss_fn(p, b, cfg, mesh))(jax.device_put(params, shard),
                                                                batch)
    return float(loss)


@pytest.fixture(scope="module")
def runs():
    params = {case: _jax_params(case) for case in CASES}
    box = {}

    def go():
        try:
            box["world"] = run_world(cases.sharded_train, W, (params,), device="cpu",
                                     deadline=300)
        except BaseException as e:  # re-raised below, in the test's thread
            box["error"] = e

    t = threading.Thread(target=go)
    t.start()
    jax_losses = {case: _jax_sharded_loss(case, params[case]) for case in CASES}
    t.join()
    if "error" in box:
        raise box["error"]
    return box["world"], jax_losses, params


def _close_to_largest(got, want, name, tol=1e-5):
    for k in want:
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], atol=tol * scale, rtol=0,
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("case", CASES)
def test_sharded_loss_matches_unsharded(runs, case):
    res = runs[0][0][case]
    assert res["loss"] == pytest.approx(res["ref_loss"], rel=1e-5)
    for r in range(1, W):  # the loss comes back whole on every rank
        assert runs[0][r][case]["loss"] == res["loss"]


@pytest.mark.parametrize("case", CASES)
def test_sharded_loss_matches_jax_sharded_step(runs, case):
    assert runs[0][0][case]["loss"] == pytest.approx(runs[1][case], abs=1e-4)


@pytest.mark.parametrize("case", CASES)
def test_sharded_gradients_match_unsharded(runs, case):
    """The gradients after the step's clip to a global norm of 1.0: the
    clip binds (the unsharded norm ends at 1), and a clip by each rank's
    own norm would scale the sharded leaves differently."""
    res = runs[0][0][case]
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for g in res["ref_grads"].values()))
    assert norm == pytest.approx(1.0, abs=1e-5)
    _close_to_largest(res["grads"], res["ref_grads"], "grad")


@pytest.mark.parametrize("case", CASES)
def test_sharded_update_matches_unsharded_optimizer(runs, case):
    res = runs[0][0][case]
    _close_to_largest(res["params"], res["params_from_sharded_grads"], "param")
    start = _jax_params(case)
    moved = [k for k, v in res["params"].items()
             if np.abs(v - _leaf(start, k)).max() > 1e-4]
    assert len(moved) == len(res["params"])  # every leaf took a step


def _leaf(params, path):
    for part in path.split("/"):
        params = params[part]
    return params


def test_moe_capacity_binds():
    """With the skewed router, capacity factor 1.0 drops tokens: the JAX
    unsharded loss differs from the one with room for every token."""
    params = _jax_params("gpt2_moe_pp2_ep2")
    batch = cases.train_batch(512, 128)
    losses = []
    for cf in (1.0, 100.0):
        model, cfg = _jax_config("gpt2_moe_pp2_ep2", capacity_factor=cf)
        losses.append(float(model.loss_fn(params, batch, cfg)))
    assert abs(losses[0] - losses[1]) > 1e-3


def test_each_ep_rank_runs_its_own_experts(runs):
    """Every MoE call of the pp2 x ep2 step ran E / ep = 2 experts on each
    rank: the buffers and both expert weights it multiplied held 2 rows."""
    for r in range(W):
        seen = runs[0][r]["gpt2_moe_pp2_ep2"]["experts"]
        assert seen and all(s == (2, 2, 2) for s in seen), seen
        # 1 layer a stage x 3 ticks (M 2 + pp 1), recomputed in none
        assert len(seen) == 3
    for case in ("gpt2_tp2_sp2", "gpt2_fsdp2_dp2", "llama_tp2_sp2"):
        assert runs[0][0][case]["experts"] == []


MOE_CASES = sorted(c for c in CASES if "_moe_" in c)


@pytest.mark.parametrize("case", MOE_CASES)
def test_each_rank_routes_only_its_own_tokens(runs, case):
    """Every router call on every rank saw only the rank's own tokens: the
    microbatch's ``B * T`` over the axes that split the tokens (dp, fsdp,
    sp); the ep ranks hold the same tokens and each ran its 2 experts."""
    _, kw, sizes = cases.TRAIN_CASES[case]
    _, cfg = _jax_config(case)
    split = math.prod(sizes.get(a, 1) for a in ("dp", "fsdp", "sp"))
    want = cases.TRAIN_B // (kw.get("pp_microbatches") or 1) * cfg.max_seq_len // split
    for r in range(W):
        res = runs[0][r][case]
        assert res["routed"] and all(n == want for n in res["routed"]), (want, res["routed"])
        assert all(s == (2, 2, 2) for s in res["experts"]), res["experts"]


def test_world_of_one_matches_the_unsharded_step():
    """On a world of one every axis is a unit axis: the DTensors live on a
    mesh of ``pp`` alone, with the stacked leaves' layer axis ``Shard(0)``
    over it, which the stack unbinds per layer on the local tensor (the
    card's ``train_gpt2_sharded``).  The loss and gradients equal the
    unsharded step's."""
    res = run_world(cases.one_rank_train, 1, (_jax_params("gpt2_tp2_sp2"),), device="cpu",
                    deadline=120)[0]
    assert res["layer_placements"] == ["S(0)"]
    assert res["sharded"]["loss"] == res["unsharded"]["loss"]
    _close_to_largest(res["sharded"]["grads"], res["unsharded"]["grads"], "grad")
