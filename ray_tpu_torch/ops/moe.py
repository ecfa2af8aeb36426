"""Switch-style top-1 Mixture-of-Experts FFN, with expert parallelism over
the ``ep`` mesh axis.

Counterpart of ``ray_tpu/ops/moe.py``.  It computes the same function: an
f32 router and softmax, the top-1 expert and its probability as the gate
(the first index on ties), each token's arrival order in its expert's
queue by a running count, tokens past the capacity ``C = max(1, ceil(cf *
S / E))`` dropped (they pass through the residual connection), tanh-GELU
experts, the gate-weighted combine, and the Switch load-balance loss
``E * sum_e f_e * P_e``.

The JAX package dispatches and combines with dense ``[S, E, C]`` one-hot
einsums (the GShard form, which GSPMD turns into the ``ep`` all-to-all).
This module gathers instead: each kept token is copied into its slot of
``[E, C, D]`` expert buffers and each token reads its slot's output back,
scaled by its gate.  A token fills at most one slot and a slot holds at
most one token, so each einsum term that is not zero is the only one in
its sum, and the gather gives the einsums' values bit for bit, without
their ``S * E * C`` tensors.  Nothing here reads a value back to the host.

On DTensors (the sharded train step) each rank routes only the tokens it
holds, as GSPMD keeps the routing batch-sharded; capacity and arrival
order still count all ``S`` tokens of the batch, from per-expert counts
gathered over the token axes, and each rank of the ``ep`` axis runs only
its own ``E / ep`` experts.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.parallel.collective import allreduce, axis_index, pvary
from ray_tpu_torch.parallel.sharding import PartitionSpec as P
from ray_tpu_torch.parallel.sharding import from_local, local_tensor, spec_to_placements


def _router(xf: torch.Tensor, router_w: torch.Tensor):
    """(probs [S, E], expert, gate) of top-1 routing over the tokens of xf."""
    probs = torch.softmax(xf.float() @ router_w.float(), dim=-1)  # [S, E]
    expert = probs.argmax(dim=-1)                                 # first index on ties
    return probs, expert, probs.gather(1, expert[:, None])[:, 0]


def _route(xf: torch.Tensor, router_w: torch.Tensor, E: int, C: int):
    """(gate, keep, slot, aux) of top-1 routing over the tokens of xf."""
    probs, expert, gate = _router(xf, router_w)
    # each expert's queue as a contiguous row of its tokens, [E, S]: the
    # running count is a scan along the rows (along a [S, E] tensor's
    # first dim it runs one thread per expert down 6,144 tokens, about a
    # millisecond on an H100)
    queue = expert[None, :] == torch.arange(E, device=xf.device)[:, None]
    # arrival order within each expert's queue; tokens past C are dropped
    pos = queue.cumsum(dim=1).gather(0, expert[None, :])[0] - 1
    keep = pos < C
    # Switch load-balance loss: E * sum_e (token fraction)_e * (prob mass)_e
    aux = E * torch.sum(queue.float().mean(dim=1) * probs.mean(dim=0))
    return gate, keep, expert * C + pos, aux


def _dispatch(xf: torch.Tensor, keep: torch.Tensor, slot: torch.Tensor, E: int, C: int
              ) -> torch.Tensor:
    """Kept token s -> row slot[s] of the ``[E, C, D]`` buffers; a dropped
    token goes to a spare row of its own past E*C, so every index is
    distinct (a deterministic copy and backward)."""
    S, D = xf.shape
    rows = torch.where(keep, slot, E * C + torch.arange(S, device=xf.device))
    return xf.new_zeros(E * C + S, D).index_copy(0, rows, xf)[:E * C].view(E, C, D)


def _experts(expert_in, w1, b1, w2, b2) -> torch.Tensor:
    h = F.gelu(torch.bmm(expert_in, w1) + b1[:, None, :], approximate="tanh")
    return torch.bmm(h, w2) + b2[:, None, :]                      # [E, C, D]


def _combine(out: torch.Tensor, gate, keep, slot) -> torch.Tensor:
    """Each token reads its slot back, weighted by its gate (0 for a
    dropped token, whose row index is any valid one)."""
    E, C, D = out.shape
    weight = (gate * keep).to(out.dtype)
    return out.reshape(E * C, D).index_select(0, torch.where(keep, slot, 0)) * weight[:, None]


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
            w2: torch.Tensor, b2: torch.Tensor, *, capacity_factor: float = 2.0,
            mesh: Optional[object] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 (Switch) MoE feed-forward.

    x: ``[B, T, D]`` (compute dtype); router_w ``[D, E]`` (read in f32);
    w1, b1 ``[E, D, F]``, ``[E, F]``; w2, b2 ``[E, F, D]``, ``[E, D]``.
    Returns ``(y, aux)``: y ``[B, T, D]`` in x's dtype and the f32 scalar
    load-balance loss.  DTensor inputs take the expert-parallel path on
    their own mesh; ``mesh`` is accepted for the JAX package's signature
    and must then be that mesh (plain tensors with a mesh raise
    ``ValueError``)."""
    if isinstance(x, DTensor):
        if mesh is not None and mesh is not x.device_mesh:
            raise ValueError("moe_ffn: mesh is not the DTensors' own mesh")
        return _moe_ffn_sharded(x, router_w, w1, b1, w2, b2, capacity_factor)
    if mesh is not None:
        raise ValueError("moe_ffn with a mesh takes DTensors (see parallel.shard_params); "
                         "the ep axis shards their experts")
    B, T, D = x.shape
    E = w1.shape[0]
    C = max(1, math.ceil(capacity_factor * B * T / E))
    xf = x.reshape(B * T, D)
    gate, keep, slot, aux = _route(xf, router_w, E, C)
    out = _experts(_dispatch(xf, keep, slot, E, C), w1, b1, w2, b2)
    y = _combine(out, gate, keep, slot)
    return y.reshape(B, T, D).to(x.dtype), aux


def _gather(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``t`` of every rank over ``axes``, stacked in the order of the
    ranks' blocks (the first axis outermost): ``[n, *t.shape]``.  It
    carries counts, so it has no gradient."""
    out = t.detach()[None]
    for a in reversed(axes):
        parts = [torch.empty_like(out) for _ in range(mesh.size(mesh.mesh_dim_names.index(a)))]
        dist.all_gather(parts, out.contiguous(), group=mesh.get_group(a))
        out = torch.cat(parts)
    return out


def _block_index(mesh, axes) -> int:
    """This rank's block over ``axes`` taken together, the first outermost."""
    c = 0
    for a in axes:
        c = c * mesh.size(mesh.mesh_dim_names.index(a)) + axis_index(mesh, a)
    return c


def _moe_ffn_sharded(x: DTensor, router_w, w1, b1, w2, b2, capacity_factor: float):
    """The MoE on DTensors, its routing batch-sharded as under the JAX
    package's GSPMD.  Each rank routes only the tokens it holds: a block
    of rows over the batch axes (dp, fsdp) and of positions over ``sp``,
    ``S / (dp * fsdp * sp)`` of them.  Only these become global:

    - the per-expert counts, which give each token its arrival slot in the
      reference's row-major ``[B * T]`` order, and so the drops at
      capacity ``C = ceil(cf * S / E)``.  A token's slot counts its expert
      in every earlier row (those of earlier batch blocks, then this
      block's earlier rows, over all of ``sp``), in its own row on the
      ``sp`` ranks before this one, then in this rank's part of its row;
    - the load-balance loss's means over the ``S`` tokens.

    Each rank of ``ep`` copies its tokens bound for its own ``E / ep``
    experts into their buffers; a sum over the token axes fills in the
    other ranks' tokens.  Each rank then combines only its own tokens
    from its own experts, and the output is summed over ``ep``.

    The gradients keep the meaning each placement gives them.  The
    buffers, the router and the expert weights are replicated over the
    token axes, and each rank uses them for its own tokens: ``pvary``
    sums their gradients there.  The tokens and their gates reach the
    experts of one ``ep`` rank each, so their gradients through the
    buffers are summed over ``ep`` the same way.  The output and the
    loss's means are sums that every rank then uses alike: their
    gradients arrive whole (``allreduce``)."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    bax = tuple(a for a in ("dp", "fsdp") if a in names)
    sp = ("sp",) if "sp" in names else ()
    rows = bax + sp                           # the axes that split the tokens
    ep = ("ep",) if "ep" in names else ()
    xpl = spec_to_placements(P(bax or None, sp[0] if sp else None, None), mesh)
    rep = [Replicate()] * mesh.ndim
    on_ep = [Shard(0) if a == "ep" else Replicate() for a in names]

    B, T, D = x.shape
    E = w1.shape[0]
    S = B * T
    C = max(1, math.ceil(capacity_factor * S / E))
    xl = local_tensor(x, xpl)
    Bl, Tl, _ = xl.shape
    xf = xl.reshape(Bl * Tl, D)
    probs, expert, gate = _router(xf, pvary(local_tensor(router_w, rep), mesh, rows))
    queue = (expert[None, :] == torch.arange(E, device=xf.device)[:, None]).view(E, Bl, Tl)
    on_sp = _gather(queue.sum(-1).T, mesh, sp)          # [sp, Bl, E] counts a row part
    row_tot = on_sp.sum(0)                              # [Bl, E]
    blocks = _gather(row_tot.sum(0), mesh, bax)         # [blocks, E]
    before = (blocks[:_block_index(mesh, bax)].sum(0) + row_tot.cumsum(0) - row_tot
              + on_sp[:_block_index(mesh, sp)].sum(0))  # [Bl, E] before this part of each row
    pos = (queue.cumsum(-1) - 1 + before.T[:, :, None]).reshape(E, Bl * Tl)
    pos = pos.gather(0, expert[None, :])[0]
    frac = blocks.sum(0).float() / S
    aux = E * torch.sum(frac * allreduce(probs.sum(0), mesh, rows) / S)

    w = [pvary(local_tensor(t, on_ep), mesh, rows) for t in (w1, b1, w2, b2)]
    E_me = w[0].shape[0]
    first = axis_index(mesh, "ep") * E_me if ep else 0
    ours = (pos < C) & (expert >= first) & (expert < first + E_me)
    slot = (expert - first) * C + pos
    expert_in = _dispatch(pvary(xf, mesh, ep), ours, slot, E_me, C)
    expert_in = pvary(allreduce(expert_in, mesh, rows), mesh, rows)
    y = _combine(_experts(expert_in, *w), pvary(gate, mesh, ep), ours, slot)
    y = allreduce(y, mesh, ep).reshape(Bl, Tl, D).to(x.dtype)
    return from_local(y, mesh, xpl), from_local(aux, mesh, rep)


def init_moe_params(generator: torch.Generator, n_layers: int, d_model: int, d_ff: int,
                    n_experts: int, *, std: float = 0.02, res_std: Optional[float] = None,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Layer-stacked f32 expert params ``[L, E, ...]`` and the ``[L, D, E]``
    router (the JAX package's shapes and scales), drawn on the CPU from
    ``generator`` and moved to ``device`` (the card when None)."""
    dev = resolve_device(device)
    L, D, Fd, E = n_layers, d_model, d_ff, n_experts
    res_std = res_std if res_std is not None else std / (2 * L) ** 0.5

    def normal(shape, s):
        return torch.randn(shape, generator=generator) * s

    p = {
        "router": normal((L, D, E), std),
        "ew1": normal((L, E, D, Fd), std),
        "eb1": torch.zeros(L, E, Fd),
        "ew2": normal((L, E, Fd, D), res_std),
        "eb2": torch.zeros(L, E, D),
    }
    return {k: v.to(dev) for k, v in p.items()}


def moe_logical_axes() -> Dict[str, tuple]:
    """Logical axes for :func:`init_moe_params` (expert -> ep)."""
    return {
        "router": ("layers", "embed", None),
        "ew1": ("layers", "expert", "embed", "mlp"),
        "eb1": ("layers", "expert", "mlp"),
        "ew2": ("layers", "expert", "mlp", "embed"),
        "eb2": ("layers", "expert", "embed"),
    }
