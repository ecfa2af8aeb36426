"""Per-rank programs of the port's multi-rank tests.

``ray_tpu_torch.parallel.spawn.run_world`` runs these in 4-rank gloo
worlds on the CPU; each returns numpy results that the test module, in the
parent process, holds to the JAX package.  This module imports no JAX
(the ranks are fresh processes and do not load ``conftest.py``); its input
makers are shared with the tests, so both sides draw the same numpy
arrays from the same seeds.
"""

from __future__ import annotations

import numpy as np

N = 6            # per-rank length of the collective inputs
WORLD = 4


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

# name -> (per-rank input shape, per-rank output shape, output replicated?)
COLLECTIVES = {
    "psum": ((N,), (N,), True),
    "pmean": ((N,), (N,), True),
    "psum_two_axes": ((N,), (N,), True),
    "allgather": ((N,), (WORLD * N,), False),
    "allgather_stacked": ((N,), (WORLD, N), False),
    "reducescatter": ((WORLD * N,), (N,), False),
    "reducescatter_mean": ((WORLD * N,), (N,), False),
    "all_to_all": ((WORLD, N), (1, WORLD * N), False),
    "ppermute_next": ((N,), (N,), False),
    "ppermute_next_shift2": ((N,), (N,), False),
    "send_recv": ((N,), (N,), False),
    "broadcast": ((N,), (N,), True),
}
SEND_RECV_PAIRS = ((0, 2), (1, 0))


def collective_inputs(name: str):
    """``(x, w)``: x the global input (the ranks' blocks along dim 0), w the
    cotangent: one block a rank, or one array shared by all ranks when the
    output is replicated."""
    shape_in, shape_out, replicated = COLLECTIVES[name]
    rng = np.random.default_rng(sorted(COLLECTIVES).index(name))
    x = rng.standard_normal((WORLD * shape_in[0], *shape_in[1:])).astype(np.float32)
    w_shape = shape_out if replicated else (WORLD * shape_out[0], *shape_out[1:])
    return x, rng.standard_normal(w_shape).astype(np.float32)


def _block(a, r):
    n = a.shape[0] // WORLD
    return a[r * n:(r + 1) * n]


def collectives():
    """Each collective's output and the gradient of ``sum(out * w)`` on this
    rank; plus max/min, grad_sync, axis_index/axis_size, pvary and
    barrier."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel import MeshSpec, create_mesh
    from ray_tpu_torch.parallel import collective as col

    r = dist.get_rank()
    mesh = create_mesh(MeshSpec(dp=WORLD), device="cpu")
    mesh2 = create_mesh(MeshSpec(dp=2, tp=2), device="cpu")
    fns = {
        "psum": lambda x: col.allreduce(x, mesh, "dp"),
        "pmean": lambda x: col.allreduce(x, mesh, "dp", op="mean"),
        "psum_two_axes": lambda x: col.allreduce(x, mesh2, ("dp", "tp")),
        "allgather": lambda x: col.allgather(x, mesh, "dp"),
        "allgather_stacked": lambda x: col.allgather(x, mesh, "dp", tiled=False),
        "reducescatter": lambda x: col.reducescatter(x, mesh, "dp"),
        "reducescatter_mean": lambda x: col.reducescatter(x, mesh, "dp", op="mean"),
        "all_to_all": lambda x: col.all_to_all(x, mesh, "dp", split_axis=0, concat_axis=1),
        "ppermute_next": lambda x: col.ppermute_next(x, mesh, "dp"),
        "ppermute_next_shift2": lambda x: col.ppermute_next(x, mesh, "dp", shift=2),
        "send_recv": lambda x: col.send_recv(x, mesh, "dp", SEND_RECV_PAIRS),
        "broadcast": lambda x: col.broadcast(x, mesh, "dp", root=3),
    }
    out = {}
    for name, fn in fns.items():
        x_all, w_all = collective_inputs(name)
        x = torch.from_numpy(_block(x_all, r).copy()).requires_grad_()
        w = w_all if COLLECTIVES[name][2] else _block(w_all, r)
        y = fn(x)
        (y * torch.from_numpy(w)).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())
    x = torch.arange(N, dtype=torch.float32) * (r + 1) - r
    out["pmax"] = col.allreduce(x, mesh, "dp", op="max").numpy()
    out["pmin"] = col.allreduce(x, mesh, "dp", op="min").numpy()
    grads = {"w": torch.full((3,), float(r)), "b": torch.ones(2)}
    out["grad_sync_mean"] = {k: v.numpy().copy() for k, v in col.grad_sync(grads, mesh, "dp").items()}
    grads = {"w": torch.full((3,), float(r))}
    out["grad_sync_sum"] = col.grad_sync(grads, mesh2, ("dp", "tp"), mean=False)["w"].numpy()
    out["axis_index"] = (col.axis_index(mesh, "dp"), col.axis_index(mesh2, "dp"),
                         col.axis_index(mesh2, "tp"))
    out["axis_size"] = (col.axis_size(mesh, "dp"), col.axis_size(mesh2, ("dp", "tp")))
    # pvary: the identity, its gradient summed over the axis
    x = torch.ones(N, requires_grad=True)
    (col.pvary(x, mesh, "dp") * (r + 1)).sum().backward()
    out["pvary"] = x.grad.numpy()
    out["barrier"] = col.barrier(7, mesh, ("dp",))
    out["layouts"] = layouts()
    return out


# ---------------------------------------------------------------------------
# layouts: batches and params on meshes, against NamedSharding's indices
# ---------------------------------------------------------------------------

LAYOUT_MESHES = {"dp2_fsdp2": dict(dp=2, fsdp=2), "fsdp2_tp2": dict(fsdp=2, tp=2),
                 "sp2_tp2": dict(sp=2, tp=2), "pp2_ep2": dict(pp=2, ep=2)}
# (logical axes, global shape) of the param leaves laid out on each mesh
LAYOUT_LEAVES = {"wqkv": (("layers", "embed", "heads"), (4, 8, 12)),
                 "ew1": (("layers", "expert", "embed", "mlp"), (4, 4, 8, 6)),
                 "wte": (("vocab", "embed"), (16, 8))}
BATCH_SHAPE = (8, 12)


def layouts():
    """This rank's tensor of a ``(batch, seq)`` batch and of each leaf in
    ``LAYOUT_LEAVES`` under ``rules_for_mesh``, on each mesh (created
    with its unit axes, as the gate does)."""
    import torch

    from ray_tpu_torch.parallel import MeshSpec, create_mesh, shard_params
    from ray_tpu_torch.parallel.sharding import rules_for_mesh, shard_batch

    out = {}
    for name, sizes in LAYOUT_MESHES.items():
        mesh = create_mesh(MeshSpec(**sizes), device="cpu", keep_unit_axes=True)
        rules = rules_for_mesh(mesh)
        batch = torch.arange(int(np.prod(BATCH_SHAPE))).reshape(BATCH_SHAPE)
        leaves = {k: torch.arange(float(np.prod(s))).reshape(s)
                  for k, (_, s) in LAYOUT_LEAVES.items()}
        params = shard_params(leaves, mesh, rules, {k: a for k, (a, _) in LAYOUT_LEAVES.items()})
        out[name] = {"batch": shard_batch({"x": batch}, mesh, rules)["x"].to_local().numpy(),
                     **{k: v.to_local().numpy() for k, v in params.items()}}
    return out


# ---------------------------------------------------------------------------
# ring and Ulysses attention, GPipe
# ---------------------------------------------------------------------------

ATTN_SHAPE = (2, 4, 32, 16)   # B, H, T, D; T and H split over sp = 4


def attention_inputs(seed: int):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(ATTN_SHAPE).astype(np.float32) for _ in range(4)]  # q k v w


PIPE_CASES = {"pp2_m2": (2, 2), "pp2_m4": (2, 4), "pp4_m2": (4, 2), "pp4_m4": (4, 4)}
PIPE_L, PIPE_D, PIPE_B = 4, 16, 8


def pipe_inputs():
    rng = np.random.default_rng(7)
    blocks = (rng.standard_normal((PIPE_L, PIPE_D, PIPE_D)) * 0.3).astype(np.float32)
    return blocks, rng.standard_normal((PIPE_B, PIPE_D)).astype(np.float32)


def pipe_stage(local_blocks, h):
    """tanh layers; the aux is each layer's mean square activation, so the
    pipeline's per-tick masks decide it."""
    import torch

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for l in range(local_blocks["w"].shape[0]):
        h = torch.tanh(h @ local_blocks["w"][l])
        aux = aux + (h * h).mean()
    return h, aux


def ring_pipeline():
    """Ring and Ulysses attention over sp = 4, causal and not: this rank's
    output chunk and q/k/v gradient chunks of ``sum(out * w)``.  Then
    ``gpipe`` at pp 2 and 4 with 2 and 4 microbatches against the same
    layers run unpipelined: outputs, aux and the gradients of
    ``sum(y**2) + aux``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from ray_tpu_torch.ops.ring_attention import ring_attention, ulysses_attention
    from ray_tpu_torch.parallel import MeshSpec, create_mesh, gpipe

    r = dist.get_rank()
    mesh = create_mesh(MeshSpec(sp=WORLD), device="cpu")
    out = {}
    for fn in (ring_attention, ulysses_attention):
        for causal in (False, True):
            q, k, v, w = (torch.from_numpy(a.reshape(2, 4, WORLD, -1, 16)[:, :, r].copy())
                          for a in attention_inputs(int(causal)))
            for t in (q, k, v):
                t.requires_grad_()
            o = fn(q, k, v, mesh, causal=causal)
            (o * w).sum().backward()
            out[(fn.__name__, causal)] = [t.detach().numpy() for t in (o, q.grad, k.grad, v.grad)]

    blocks_np, x_np = pipe_inputs()
    for name, (pp, m) in PIPE_CASES.items():
        pmesh = create_mesh(MeshSpec(pp=pp, dp=WORLD // pp), device="cpu")
        on_dp = [Replicate()] + ([Shard(0)] if WORLD // pp > 1 else [])
        blocks = {"w": distribute_tensor(torch.from_numpy(blocks_np), pmesh,
                                         [Shard(0)] + [Replicate()] * (pmesh.ndim - 1))
                  .requires_grad_()}
        x = distribute_tensor(torch.from_numpy(x_np), pmesh, on_dp).requires_grad_()
        y, aux = gpipe(pipe_stage, blocks, x, mesh=pmesh, n_microbatches=m)
        ((y * y).sum() + aux).backward()
        out[name] = [y.full_tensor().detach().numpy(), float(aux.full_tensor()),
                     blocks["w"].grad.full_tensor().numpy(), x.grad.full_tensor().numpy()]
    if r == 0:
        rb = torch.from_numpy(blocks_np).requires_grad_()
        rx = torch.from_numpy(x_np).requires_grad_()
        y, aux = pipe_stage({"w": rb}, rx)
        ((y * y).sum() + aux).backward()
        out["unpipelined"] = [y.detach().numpy(), float(aux), rb.grad.numpy(), rx.grad.numpy()]
    return out


# ---------------------------------------------------------------------------
# sharded train steps
# ---------------------------------------------------------------------------

# case -> (model, config overrides, mesh sizes)
TRAIN_CASES = {
    "gpt2_tp2_sp2": ("gpt2", {}, dict(tp=2, sp=2)),
    "gpt2_fsdp2_dp2": ("gpt2", {}, dict(dp=2, fsdp=2)),
    "gpt2_moe_pp2_ep2": ("gpt2", dict(n_experts=4, capacity_factor=1.0, pp_microbatches=2),
                         dict(pp=2, ep=2)),
    "gpt2_moe_dp2_ep2": ("gpt2", dict(n_experts=4, capacity_factor=1.0), dict(dp=2, ep=2)),
    "gpt2_moe_sp2_ep2": ("gpt2", dict(n_experts=4, capacity_factor=1.0), dict(sp=2, ep=2)),
    "llama_tp2_sp2": ("llama", {}, dict(tp=2, sp=2)),
}
TRAIN_B = 8
ROUTER_SKEW = 25.0   # the MoE router's init scaled up, so capacity 1.0 binds
EMBED_SCALE = 10.0   # the token embedding's init scaled up, so the clip to 1.0 binds


def train_batch(vocab: int, seq: int):
    rng = np.random.default_rng(11)
    return {k: rng.integers(0, vocab, (TRAIN_B, seq)).astype(np.int32)
            for k in ("inputs", "targets")}


def port_config(case: str):
    import torch

    from ray_tpu_torch.models import gpt2, llama

    model, kw, _ = TRAIN_CASES[case]
    if model == "gpt2":
        return gpt2, gpt2.GPT2Config.tiny(dtype=torch.float32, **kw)
    return llama, llama.LlamaConfig.tiny(dtype=torch.float32, **kw)


def _leaves(params, fn):
    from ray_tpu_torch.models.transformer import named_leaves

    return {n: fn(t) for n, t in named_leaves(params)}


def sharded_train(np_params):
    """For each case: one sharded train step from the JAX init
    (``convert.from_jax_params`` then ``shard_params``), one unsharded
    step from the same init (for the pipelined MoE, the mean over its
    microbatches, which is the pipeline's math), and the unsharded
    optimizer applied to the sharded step's gradients.  Rank 0 returns
    losses, clipped gradients and updated params; every rank returns the
    expert counts its MoE layers ran and the tokens each of its routers
    saw."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.convert import from_jax_params
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models.transformer import train_state
    from ray_tpu_torch.ops import moe
    from ray_tpu_torch.parallel import MeshSpec, create_mesh, shard_params
    from ray_tpu_torch.parallel.sharding import rules_for_mesh

    seen, routed = [], []
    experts, router = moe._experts, moe._router

    def spy(expert_in, w1, b1, w2, b2):
        seen.append((expert_in.shape[0], w1.shape[0], w2.shape[0]))
        return experts(expert_in, w1, b1, w2, b2)

    def spy_router(xf, router_w):
        routed.append(xf.shape[0])
        return router(xf, router_w)

    moe._experts, moe._router = spy, spy_router
    out = {}
    for case, (_, _, sizes) in TRAIN_CASES.items():
        model, cfg = port_config(case)
        opt = gpt2.make_optimizer(lr=1e-3, warmup=0, total_steps=10)
        batch = {k: torch.from_numpy(v).long()
                 for k, v in train_batch(cfg.vocab_size, cfg.max_seq_len).items()}
        fresh = lambda: from_jax_params(np_params[case], cfg, device="cpu")
        mesh = create_mesh(MeshSpec(**sizes), device="cpu", keep_unit_axes=True)
        state = train_state(shard_params(fresh(), mesh, rules_for_mesh(mesh),
                                         model.logical_axes(cfg)), opt)
        seen.clear()
        routed.clear()
        _, metrics = model.make_train_step(cfg, opt, mesh)(state, batch)
        res = {"loss": float(metrics["loss"]), "experts": list(seen), "routed": list(routed)}
        grads = _leaves(state["params"], lambda t: t.grad.full_tensor())
        params = _leaves(state["params"], lambda t: t.full_tensor().detach())
        if dist.get_rank() == 0:
            ref = train_state(fresh(), opt)
            m = getattr(cfg, "pp_microbatches", 0) or 1
            opt.zero_grad(ref["opt_state"])
            loss = 0.0
            for i in range(m):
                rows = slice(i * TRAIN_B // m, (i + 1) * TRAIN_B // m)
                mb = {k: v[rows] for k, v in batch.items()}
                l = model.loss_fn(ref["params"], mb, cfg) / m
                l.backward()
                loss += float(l)
            opt.update(ref["opt_state"])
            chk = train_state(fresh(), opt)
            for name, t in _leaves(chk["params"], lambda t: t).items():
                t.grad = grads[name].clone()
            opt.update(chk["opt_state"])
            res.update(
                ref_loss=loss,
                grads={n: g.numpy() for n, g in grads.items()},
                ref_grads=_leaves(ref["params"], lambda t: t.grad.numpy()),
                params={n: p.numpy() for n, p in params.items()},
                params_from_sharded_grads=_leaves(chk["params"], lambda t: t.detach().numpy()))
        out[case] = res
    moe._experts, moe._router = experts, router
    return out


def one_rank_train(np_params):
    """GPT-2 tiny sharded on a world of one (every axis a unit axis, so
    the DTensors live on a mesh of ``pp`` alone, the layer axis
    ``Shard(0)`` over it) and unsharded, from the same params: both steps'
    losses and gradients."""
    import torch

    from ray_tpu_torch.convert import from_jax_params
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models.transformer import train_state
    from ray_tpu_torch.parallel import MeshSpec, create_mesh, shard_params
    from ray_tpu_torch.parallel.sharding import rules_for_mesh

    cfg = gpt2.GPT2Config.tiny(dtype=torch.float32)
    batch = {k: torch.from_numpy(v).long()
             for k, v in train_batch(cfg.vocab_size, cfg.max_seq_len).items()}
    out = {}
    for name, mesh in (("sharded", create_mesh(MeshSpec(), device="cpu", keep_unit_axes=True)),
                       ("unsharded", None)):
        opt = gpt2.make_optimizer(lr=1e-3, warmup=0, total_steps=10)
        params = from_jax_params(np_params, cfg, device="cpu")
        if mesh is not None:
            params = shard_params(params, mesh, rules_for_mesh(mesh), gpt2.logical_axes(cfg))
        state = train_state(params, opt)
        _, metrics = gpt2.make_train_step(cfg, opt, mesh)(state, batch)
        full = (lambda t: t.full_tensor()) if mesh is not None else (lambda t: t)
        out[name] = {"loss": float(metrics["loss"]),
                     "grads": _leaves(state["params"], lambda t: full(t.grad).numpy())}
        if mesh is not None:
            out["layer_placements"] = [str(p) for p in state["params"]["blocks"]["wqkv"].placements]
    return out


# ---------------------------------------------------------------------------
# util/collective's "torch" group over a world's default process group
# ---------------------------------------------------------------------------

def collective_group_inputs(rank: int) -> dict:
    """Each rank's inputs to the group ops (numpy, drawn from the rank)."""
    rng = np.random.default_rng(100 + rank)
    return {"x": rng.normal(size=(5, 3)).astype(np.float32),
            "p2p": rng.normal(size=(2, 4)).astype(np.float32)}


def collective_group_ops(group_name: str = "g"):
    """Every op of ``ray_tpu_torch.util.collective`` on the ``"torch"``
    group over this world; returns numpy results by op name."""
    import torch.distributed as dist

    from ray_tpu_torch.util import collective as col

    rank, world = dist.get_rank(), dist.get_world_size()
    col.init_collective_group(world, rank, backend="torch", group_name=group_name)
    assert col.get_group_backend(group_name) == "torch"
    inp = collective_group_inputs(rank)
    out = {f"allreduce_{op}": col.allreduce(inp["x"], group_name, op=op).numpy()
           for op in ("sum", "mean", "max", "min")}
    out["allgather"] = np.stack([t.numpy() for t in col.allgather(inp["x"], group_name)])
    out["reducescatter"] = col.reducescatter(inp["x"], group_name).numpy()
    out["broadcast"] = col.broadcast(inp["x"], src_rank=1, group_name=group_name).numpy()
    if rank == 0:
        col.send(inp["p2p"], 1, group_name)
        out["recv"] = col.recv((2, 4), np.float32, 1, group_name).numpy()
    else:
        out["recv"] = col.recv((2, 4), np.float32, 0, group_name).numpy()
        col.send(inp["p2p"], 0, group_name)
    col.barrier(group_name)
    # torch_utils.allreduce_grads: one flat round over the group, the means
    # back in the tree's shape, billed to the open step's collective phase
    import torch

    from ray_tpu_torch.train import torch_utils
    from ray_tpu_torch.util.perf import StepProfiler

    tree = {"w": torch.from_numpy(inp["x"]), "b": [torch.from_numpy(inp["p2p"])]}
    prof = StepProfiler(rank=rank).install()
    try:
        with prof.step():
            mean = torch_utils.allreduce_grads(tree, group_name)
    finally:
        prof.uninstall()
    out["grads_w"], out["grads_b"] = mean["w"].numpy(), mean["b"][0].numpy()
    out["grads_phases"] = sorted(prof.steps[-1]["phases"])
    col.destroy_collective_group(group_name)

    mesh = torch_utils.global_mesh(device="cpu")
    out["global_mesh"] = (tuple(mesh.mesh_dim_names), tuple(mesh.shape))
    return out
