"""Switch-style top-1 Mixture-of-Experts FFN, on one device.

Counterpart of ``ray_tpu/ops/moe.py`` without its ``ep`` mesh axis (a
``mesh`` raises ``NotImplementedError``; expert parallelism comes with the
parallelism slice).  It computes the same function: an f32 router and
softmax, the top-1 expert and its probability as the gate (the first
index on ties), each token's arrival order in its expert's queue by a
running count, tokens past the capacity ``C = max(1, ceil(cf * S / E))``
dropped (they pass through the residual connection), tanh-GELU experts,
the gate-weighted combine, and the Switch load-balance loss
``E * sum_e f_e * P_e``.

The JAX package dispatches and combines with dense ``[S, E, C]`` one-hot
einsums (the GShard form, which GSPMD turns into the ``ep`` all-to-all).
On one device this module gathers instead: each kept token is copied into
its slot of ``[E, C, D]`` expert buffers and each token reads its slot's
output back, scaled by its gate.  A token fills at most one slot and a
slot holds at most one token, so each einsum term that is not zero is the
only one in its sum, and the gather gives the einsums' values bit for
bit, without their ``S * E * C`` tensors.  Nothing here reads a value
back to the host.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import DeviceLike, resolve_device


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
            w2: torch.Tensor, b2: torch.Tensor, *, capacity_factor: float = 2.0,
            mesh: Optional[object] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 (Switch) MoE feed-forward.

    x: ``[B, T, D]`` (compute dtype); router_w ``[D, E]`` (read in f32);
    w1, b1 ``[E, D, F]``, ``[E, F]``; w2, b2 ``[E, F, D]``, ``[E, D]``.
    Returns ``(y, aux)``: y ``[B, T, D]`` in x's dtype and the f32 scalar
    load-balance loss."""
    if mesh is not None:
        raise NotImplementedError(
            "the expert-parallel (ep) MoE is not ported yet; run on one device")
    B, T, D = x.shape
    E = w1.shape[0]
    S = B * T
    C = max(1, math.ceil(capacity_factor * S / E))
    xf = x.reshape(S, D)

    probs = torch.softmax(xf.float() @ router_w.float(), dim=-1)  # [S, E]
    expert = probs.argmax(dim=-1)                                 # first index on ties
    gate = probs.gather(1, expert[:, None])[:, 0]                 # [S]
    # each expert's queue as a contiguous row of its tokens, [E, S]: the
    # running count is a scan along the rows (along a [S, E] tensor's
    # first dim it runs one thread per expert down 6,144 tokens, about a
    # millisecond on an H100)
    queue = expert[None, :] == torch.arange(E, device=x.device)[:, None]
    # arrival order within each expert's queue; tokens past C are dropped
    pos = queue.cumsum(dim=1).gather(0, expert[None, :])[0] - 1
    keep = pos < C
    slot = expert * C + pos

    # dispatch: kept token s -> row slot[s] of the [E*C, D] buffers; a
    # dropped token goes to a spare row of its own past E*C, so every
    # index is distinct (a deterministic copy and backward)
    rows = torch.where(keep, slot, E * C + torch.arange(S, device=x.device))
    expert_in = xf.new_zeros(E * C + S, D).index_copy(0, rows, xf)[:E * C].view(E, C, D)

    h = F.gelu(torch.bmm(expert_in, w1) + b1[:, None, :], approximate="tanh")
    out = torch.bmm(h, w2) + b2[:, None, :]                       # [E, C, D]

    # combine: each token reads its slot back, weighted by its gate (0 for
    # a dropped token, whose row index is any valid one)
    weight = (gate * keep).to(out.dtype)
    y = out.reshape(E * C, D).index_select(0, torch.where(keep, slot, 0)) * weight[:, None]

    # Switch load-balance loss: E * sum_e (token fraction)_e * (prob mass)_e
    aux = E * torch.sum(queue.float().mean(dim=1) * probs.mean(dim=0))
    return y.reshape(B, T, D).to(x.dtype), aux


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
