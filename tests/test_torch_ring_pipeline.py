"""Ring and Ulysses attention and the GPipe pipeline of the port, on a
4-rank gloo world on the CPU.

A module-scoped fixture runs ``torch_world_cases.ring_pipeline`` once;
each case is its own test.  The attention functions are held to the JAX
package's in ``shard_map`` over 4 of conftest's 8 virtual devices (f32,
1e-5), and their q/k/v gradients to those of the JAX ``mha_reference``.
``gpipe`` at pp 2 and 4 with 2 and 4 microbatches is held to the same
layers run unpipelined: outputs, aux and gradients within 1e-5 (the
counterparts of ``test_pipeline_moe.py``'s gpipe tests).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

import torch_world_cases as cases
from ray_tpu.ops.attention import mha_reference
from ray_tpu.ops.ring_attention import ring_attention, ulysses_attention
from ray_tpu.parallel import MeshSpec, create_mesh
from ray_tpu_torch.parallel.spawn import run_world

W = cases.WORLD
TOL = 1e-5


@pytest.fixture(scope="module")
def world():
    return run_world(cases.ring_pipeline, W, device="cpu", deadline=240)


def _gather_t(world, key, i):
    """The full [B, H, T, D] tensor from the ranks' sequence chunks."""
    return np.concatenate([world[r][key][i] for r in range(W)], axis=2)


@pytest.mark.parametrize("fn", ["ring_attention", "ulysses_attention"])
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_parallel_attention_matches_jax(world, fn, causal):
    q, k, v, _ = cases.attention_inputs(int(causal))
    mesh = create_mesh(MeshSpec(sp=W), devices=jax.devices()[:W])
    spec = JP(None, None, "sp", None)
    jfn = {"ring_attention": ring_attention, "ulysses_attention": ulysses_attention}[fn]
    sm = jax.jit(jax.shard_map(lambda a, b, c: jfn(a, b, c, axis_name="sp", causal=causal),
                               mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                               check_vma=False))
    want = np.asarray(sm(q, k, v))
    np.testing.assert_allclose(_gather_t(world, (fn, causal), 0), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(want, np.asarray(mha_reference(q, k, v, causal=causal)),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("fn", ["ring_attention", "ulysses_attention"])
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_parallel_attention_grads_match_reference(world, fn, causal):
    """q/k/v gradients of ``sum(out * w)`` against ``jax.grad`` of the JAX
    ``mha_reference``."""
    q, k, v, w = cases.attention_inputs(int(causal))
    grads = jax.grad(lambda a, b, c: jnp.sum(mha_reference(a, b, c, causal=causal) * w),
                     argnums=(0, 1, 2))(q, k, v)
    for i, g in enumerate(grads, start=1):
        np.testing.assert_allclose(_gather_t(world, (fn, causal), i), np.asarray(g),
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", sorted(cases.PIPE_CASES))
def test_gpipe_matches_unpipelined_stack(world, case):
    """Outputs, the aux loss (its per-tick validity masks), and the
    gradients of ``sum(y**2) + aux`` for the blocks and the input."""
    y, aux, g_blocks, g_x = world[0][case]
    ry, raux, rg_blocks, rg_x = world[0]["unpipelined"]
    np.testing.assert_allclose(y, ry, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(aux, raux, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(g_blocks, rg_blocks, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(g_x, rg_x, atol=TOL, rtol=TOL)
    for r in range(1, W):  # the result is replicated over every rank
        np.testing.assert_array_equal(world[r][case][0], y)


def test_unpipelined_reference_is_jax_scan():
    """The reference stack itself against the JAX package's scan form."""
    import torch

    blocks, x = cases.pipe_inputs()

    def layer(h, w):
        h = jnp.tanh(h @ w)
        return h, jnp.mean(h * h)

    def jstage(b, h):
        h, auxs = jax.lax.scan(layer, h, b)
        return h, auxs.sum()

    jy, jaux = jstage(blocks, x)
    ty, taux = cases.pipe_stage({"w": torch.from_numpy(blocks)}, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=TOL, rtol=TOL)
