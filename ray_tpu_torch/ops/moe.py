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

On DTensors (the sharded train step) the routing stays global, as it is
under GSPMD: capacity and arrival order count all ``S`` tokens of the
batch, so every rank routes the whole batch, and each rank of the ``ep``
axis runs only its own ``E / ep`` experts on its slice of the buffers.  A per-rank dispatch over local tokens would drop
other tokens.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.parallel.sharding import from_local, local_tensor


def _route(xf: torch.Tensor, router_w: torch.Tensor, E: int, C: int):
    """(gate, keep, slot, aux) of top-1 routing over the tokens of xf."""
    probs = torch.softmax(xf.float() @ router_w.float(), dim=-1)  # [S, E]
    expert = probs.argmax(dim=-1)                                 # first index on ties
    gate = probs.gather(1, expert[:, None])[:, 0]                 # [S]
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


def _moe_ffn_sharded(x: DTensor, router_w, w1, b1, w2, b2, capacity_factor: float):
    """The MoE on DTensors: every rank routes all tokens (their values are
    the same on every rank), and each rank of ``ep`` runs its own experts.
    The router, the ``[E, S]`` arrival-order cumsum, the dispatch and the
    combine are thus replicated over the data axes (dp, fsdp, sp): their
    memory and time on each rank grow with the global batch ``S = B * T``,
    where the JAX package's GSPMD keeps them batch-sharded.  Only the
    experts' FFN is split, over ``ep``.
    The buffers cross from the replicated routing to the expert shards and
    back by ``redistribute``, whose gradient is the matching gather or
    slice, so each local value keeps the meaning its placement gives it."""
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    ep = [Shard(0) if a == "ep" else Replicate() for a in mesh.mesh_dim_names]
    local = local_tensor

    def wrap(t, pl):
        return from_local(t, mesh, pl)

    B, T, D = x.shape
    E = w1.shape[0]
    C = max(1, math.ceil(capacity_factor * B * T / E))
    xf = local(x, rep).reshape(B * T, D)
    gate, keep, slot, aux = _route(xf, local(router_w, rep), E, C)
    expert_in = local(wrap(_dispatch(xf, keep, slot, E, C), rep), ep)
    out = _experts(expert_in, *(local(w, ep) for w in (w1, b1, w2, b2)))
    y = _combine(local(wrap(out, ep), rep), gate, keep, slot)
    return wrap(y.reshape(B, T, D).to(x.dtype), rep), wrap(aux, rep)


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
