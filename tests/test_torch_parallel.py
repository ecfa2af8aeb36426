"""The port's parallelism layer against the JAX package's: meshes, sharding
rules, collectives and their gradients, layouts, and the sharded
train-step gate.

Single-process tests hold the pure parts (``MeshSpec``, axis order, rule
tables, ``rules_for_mesh``, ``infer_sharding``) to ``ray_tpu.parallel``.
The multi-rank cases run once, in a 4-rank gloo world on the CPU started
by a module-scoped fixture (``tests/torch_world_cases.py``); each case is
its own test against the JAX collective in ``shard_map`` over 4 of
conftest's 8 virtual devices.  The last test runs
``dryrun_multichip(4, device="cpu")`` from this process.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as JP

import torch_world_cases as cases
from ray_tpu.parallel import MeshSpec as JMeshSpec, create_mesh as jcreate_mesh
from ray_tpu.parallel import collective as jcol
from ray_tpu.parallel import mesh as jmesh_mod
from ray_tpu.parallel import sharding as jsh
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding as tsh
from ray_tpu_torch.parallel.dryrun import PARITY_ATOL, dryrun_multichip
from ray_tpu_torch.parallel.spawn import run_world

W = cases.WORLD


@pytest.fixture(scope="module")
def world():
    return run_world(cases.collectives, W, device="cpu", deadline=240)


def _fake_mesh(sizes):
    """What the port's rule functions read of a DeviceMesh."""
    names = tuple(sizes)
    return types.SimpleNamespace(mesh_dim_names=names, size=lambda i: sizes[names[i]])


# ---------------------------------------------------------------------------
# single process
# ---------------------------------------------------------------------------

def test_axis_order_matches_jax():
    assert tmesh.AXIS_ORDER == jmesh_mod.AXIS_ORDER


@pytest.mark.parametrize("spec,n", [(dict(dp=-1, tp=4), 8), (dict(pp=2, ep=-1), 8),
                                    (dict(fsdp=2, sp=2, tp=2), 8), ({}, 1)])
def test_mesh_spec_resolve_matches_jax(spec, n):
    assert tmesh.MeshSpec(**spec).resolve(n) == JMeshSpec(**spec).resolve(n)


def test_mesh_spec_resolve_errors():
    for spec, n in ((dict(dp=3, tp=4), 8), (dict(dp=-1, tp=-1), 8), (dict(dp=-1, tp=3), 8)):
        with pytest.raises(ValueError):
            tmesh.MeshSpec(**spec).resolve(n)
        with pytest.raises(ValueError):
            JMeshSpec(**spec).resolve(n)


@pytest.mark.parametrize("spec,keep", [(dict(dp=2, tp=4), False), (dict(pp=2, ep=2), True),
                                       ({}, False), ({}, True), (dict(sp=8), False)])
def test_mesh_axes_match_jax(spec, keep):
    """Names and shape, the unit-axis rule and the one-``dp`` fallback."""
    n = int(np.prod([v for v in spec.values()] or [1]))
    jm = jcreate_mesh(JMeshSpec(**spec), devices=jax.devices()[:n], keep_unit_axes=keep)
    names, shape = tmesh.mesh_axes(tmesh.MeshSpec(**spec), n, keep_unit_axes=keep)
    assert names == jm.axis_names and shape == jm.devices.shape


@pytest.mark.parametrize("spec", [dict(pp=2, dp=2, tp=2), dict(fsdp=2, ep=2, sp=2)])
def test_ici_and_dcn_axes_match_jax(spec):
    jm = jcreate_mesh(JMeshSpec(**spec), devices=jax.devices()[:8])
    fake = _fake_mesh(dict(zip(jm.axis_names, jm.devices.shape)))
    assert tmesh.ici_axes(fake) == jmesh_mod.ici_axes(jm)
    assert tmesh.dcn_axes(fake) == jmesh_mod.dcn_axes(jm)


RULE_TABLES = ("DP_RULES", "FSDP_RULES", "TP_RULES", "FSDP_TP_RULES", "SP_RULES", "EP_RULES")
LOGICAL = [("batch", "seq"), ("embed", "mlp"), ("layers", "embed", "heads"),
           ("layers", "expert", "embed", "mlp"), ("vocab", "embed"), (None, "kv"), ()]


@pytest.mark.parametrize("table", RULE_TABLES)
def test_rule_tables_give_jax_specs(table):
    for axes in LOGICAL:
        assert tuple(getattr(tsh, table).spec(axes)) == tuple(getattr(jsh, table).spec(axes))


def test_sharding_rules_spec_and_update():
    rules = tsh.ShardingRules(batch=("dp", "fsdp"), embed="fsdp", mlp="tp")
    assert rules.spec(("batch", None)) == tsh.P(("dp", "fsdp"), None)
    assert rules.spec(("embed", "mlp")) == tsh.P("fsdp", "tp")
    assert rules.update(mlp=None).spec(("embed", "mlp")) == tsh.P("fsdp", None)
    assert rules.spec(("embed", "mlp")) == tsh.P("fsdp", "tp")  # update copies


@pytest.mark.parametrize("spec", [dict(fsdp=2, tp=4), dict(dp=2, fsdp=2, sp=2),
                                  dict(pp=2, ep=4), dict(dp=8)])
def test_rules_for_mesh_matches_jax(spec):
    jm = jcreate_mesh(JMeshSpec(**spec), devices=jax.devices()[:8])
    got = tsh.rules_for_mesh(_fake_mesh(dict(zip(jm.axis_names, jm.devices.shape))))
    assert got.rules == jsh.rules_for_mesh(jm).rules


def test_infer_sharding_matches_jax():
    jm = jcreate_mesh(JMeshSpec(fsdp=8), devices=jax.devices()[:8])
    shapes = {"w": (16, 128), "b": (4,), "odd": (33, 35), "wide": (8, 256, 24)}
    jspecs = jsh.infer_sharding({k: jnp.zeros(s) for k, s in shapes.items()}, jm,
                                jsh.FSDP_TP_RULES)
    import torch

    tspecs = tsh.infer_sharding({k: torch.zeros(s) for k, s in shapes.items()},
                                _fake_mesh({"fsdp": 8}), tsh.FSDP_TP_RULES)
    for k in shapes:
        assert tuple(tspecs[k].spec) == tuple(jspecs[k].spec), k


def test_spec_must_name_mesh_axes_in_mesh_order():
    """DTensor splits a dim over several mesh axes in mesh order, so a spec
    naming them otherwise (or an axis the mesh lacks) raises."""
    mesh = _fake_mesh({"dp": 2, "fsdp": 2})
    assert tsh.spec_to_placements(tsh.P(("dp", "fsdp"), None), mesh) == (
        tsh.Shard(0), tsh.Shard(0))
    with pytest.raises(ValueError, match="order"):
        tsh.spec_to_placements(tsh.P(("fsdp", "dp")), mesh)
    with pytest.raises(ValueError, match="not in mesh"):
        tsh.spec_to_placements(tsh.P("tp"), mesh)


def test_entry_points_need_the_card_unless_asked_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for call in (lambda: tmesh.init_world(), lambda: run_world(cases.collectives, 2),
                 lambda: dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ---------------------------------------------------------------------------
# collectives and their gradients, against shard_map
# ---------------------------------------------------------------------------

def _jax_collective(name):
    """(jitted f, its gradient of sum(f(x) * w)) on 4 virtual devices."""
    mesh = jcreate_mesh(JMeshSpec(dp=W), devices=jax.devices()[:W])
    fns = {
        "psum": lambda x: jcol.allreduce(x, "dp"),
        "pmean": lambda x: jcol.allreduce(x, "dp", op="mean"),
        "allgather": lambda x: jcol.allgather(x, "dp"),
        "allgather_stacked": lambda x: jcol.allgather(x, "dp", tiled=False),
        "reducescatter": lambda x: jcol.reducescatter(x, "dp"),
        "reducescatter_mean": lambda x: jcol.reducescatter(x, "dp", op="mean"),
        "all_to_all": lambda x: jcol.all_to_all(x, "dp", split_axis=0, concat_axis=1),
        "ppermute_next": lambda x: jcol.ppermute_next(x, "dp"),
        "ppermute_next_shift2": lambda x: jcol.ppermute_next(x, "dp", shift=2),
        "send_recv": lambda x: jcol.send_recv(x, "dp", cases.SEND_RECV_PAIRS),
        "broadcast": lambda x: jcol.broadcast(x, "dp", root=3),
    }
    in_spec = JP("dp")
    if name == "psum_two_axes":
        mesh = jcreate_mesh(JMeshSpec(dp=2, tp=2), devices=jax.devices()[:W])
        fn, in_spec = (lambda x: jcol.allreduce(x, ("dp", "tp"))), JP(("dp", "tp"))
    else:
        fn = fns[name]
    out_spec = JP() if cases.COLLECTIVES[name][2] else JP("dp")
    f = jax.shard_map(fn, mesh=mesh, in_specs=in_spec, out_specs=out_spec)
    return jax.jit(f), jax.jit(jax.grad(lambda x, w: jnp.sum(f(x) * w)))


@pytest.mark.parametrize("name", sorted(cases.COLLECTIVES))
def test_collective_and_gradient_match_shard_map(world, name):
    x, w = cases.collective_inputs(name)
    f, g = _jax_collective(name)
    want_y, want_g = np.asarray(f(x)), np.asarray(g(x, w))
    got_y = [world[r][name][0] for r in range(W)]
    got_g = np.concatenate([world[r][name][1] for r in range(W)])
    if cases.COLLECTIVES[name][2]:  # replicated: every rank holds all of it
        for y in got_y:
            np.testing.assert_allclose(y, want_y, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(np.concatenate(got_y), want_y, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-6, atol=1e-6)


def test_max_min_grad_sync_and_axes(world):
    xs = np.stack([np.arange(cases.N, dtype=np.float32) * (r + 1) - r for r in range(W)])
    mesh = jcreate_mesh(JMeshSpec(dp=W), devices=jax.devices()[:W])
    jmax = jax.shard_map(lambda x: jcol.allreduce(x, "dp", op="max"), mesh=mesh,
                         in_specs=JP("dp"), out_specs=JP())
    jmin = jax.shard_map(lambda x: jcol.allreduce(x, "dp", op="min"), mesh=mesh,
                         in_specs=JP("dp"), out_specs=JP())
    jsync = jax.shard_map(lambda g: jcol.grad_sync(g, "dp"), mesh=mesh,
                          in_specs=JP("dp"), out_specs=JP("dp"))
    ws = jsync({"w": jnp.repeat(jnp.arange(W, dtype=jnp.float32), 3), "b": jnp.ones(2 * W)})
    for r in range(W):
        np.testing.assert_array_equal(world[r]["pmax"], np.asarray(jmax(xs.reshape(-1))))
        np.testing.assert_array_equal(world[r]["pmin"], np.asarray(jmin(xs.reshape(-1))))
        np.testing.assert_allclose(world[r]["grad_sync_mean"]["w"], np.asarray(ws["w"])[:3])
        np.testing.assert_allclose(world[r]["grad_sync_mean"]["b"], np.ones(2))
        np.testing.assert_allclose(world[r]["grad_sync_sum"], np.full(3, 6.0))
        assert world[r]["axis_index"] == (r, r // 2, r % 2)
        assert world[r]["axis_size"] == (W, W)
        # pvary's gradient is the sum of every rank's: 1 + 2 + 3 + 4
        np.testing.assert_allclose(world[r]["pvary"], np.full(cases.N, 10.0))
        assert world[r]["barrier"] == 7


# ---------------------------------------------------------------------------
# layouts: each rank's block is what NamedSharding gives its device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", sorted(cases.LAYOUT_MESHES))
def test_layouts_match_named_sharding(world, mesh_name):
    """The batch ``P(("dp", "fsdp"), "sp")`` (dp-major) and the param
    leaves under ``rules_for_mesh``: rank r's tensor is the block JAX's
    ``NamedSharding`` gives device r of the same mesh."""
    sizes = cases.LAYOUT_MESHES[mesh_name]
    jm = jcreate_mesh(JMeshSpec(**sizes), devices=jax.devices()[:W], keep_unit_axes=True)
    rules = jsh.rules_for_mesh(jm)
    want = {"batch": (np.arange(np.prod(cases.BATCH_SHAPE)).reshape(cases.BATCH_SHAPE),
                      JP(("dp", "fsdp"), "sp"))}
    for k, (axes, shape) in cases.LAYOUT_LEAVES.items():
        want[k] = (np.arange(float(np.prod(shape))).reshape(shape), rules.spec(axes))
    devices = list(jm.devices.reshape(-1))
    for k, (full, spec) in want.items():
        index = NamedSharding(jm, spec).devices_indices_map(full.shape)
        for r in range(W):
            np.testing.assert_array_equal(world[r]["layouts"][mesh_name][k],
                                          full[index[devices[r]]], err_msg=k)


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

def test_dryrun_multichip_on_four_gloo_ranks():
    """The four cases of ``__graft_entry__.dryrun_multichip(4)``: GPT-2
    tp x sp, the MoE pp x ep, Llama tp x sp in f32 within the JAX gate's
    atol of the unsharded step, and GPT-2 125M's widths in bf16 finite."""
    results = dryrun_multichip(4, device="cpu", deadline=300)
    assert [r["label"] for r in results] == [
        "gpt2 fsdp*sp*tp", "gpt2-moe pp*ep*dp", "llama tp*sp*fsdp", "gpt2-125m-shape fsdp*sp*tp"]
    assert results[0]["mesh"] == {"pp": 1, "dp": 1, "fsdp": 1, "ep": 1, "sp": 2, "tp": 2}
    assert results[1]["mesh"] == {"pp": 2, "dp": 1, "fsdp": 1, "ep": 2, "sp": 1, "tp": 1}
    for r in results[:3]:
        assert abs(r["loss"] - r["ref_loss"]) <= PARITY_ATOL
    assert np.isfinite(results[3]["loss"]) and results[3]["ref_loss"] is None
