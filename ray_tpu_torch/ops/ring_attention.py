"""Sequence-parallel exact attention over the ``sp`` mesh axis.

Counterpart of ``ray_tpu/ops/ring_attention.py``.  Both functions are
per-rank code (the JAX package runs them inside ``shard_map``): q, k and v
are this rank's ``[B, H, t, D]`` chunks of ``[B, H, T, D]`` tensors whose
sequence is split over the axis in rank order (``t = T / n``), and the
result is this rank's chunk of the output.

- :func:`ring_attention` keeps q and passes k/v around the ring with
  :func:`~ray_tpu_torch.parallel.collective.ppermute_next`, folding each
  visiting chunk into an online-softmax accumulator (``_block_update``).
- :func:`ulysses_attention` re-shards heads for sequence with two
  all-to-alls around :func:`~ray_tpu_torch.ops.attention.blockwise_attention`.

Their gradients are autograd's through the collectives.  Neither calls the
flash kernel, as the JAX package's do not.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch.ops.attention import NEG_INF, _block_update, blockwise_attention
from ray_tpu_torch.parallel.collective import all_to_all, axis_index, axis_size, ppermute_next


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: DeviceMesh, *,
                   axis_name: str = "sp", causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over a ring of ``n`` ranks, in ``n`` steps; output in
    q's dtype."""
    *_, t, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    n = axis_size(mesh, axis_name)
    my = axis_index(mesh, axis_name)
    dev = q.device

    qf = q.float() * scale
    q_pos = my * t + torch.arange(t, device=dev)
    o = torch.zeros(*q.shape[:-1], d, dtype=torch.float32, device=dev)
    m = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=dev)
    k_cur, v_cur = k, v
    for i in range(n):
        # the chunk visiting at step i came from rank (my - i) % n
        s = qf @ k_cur.float().transpose(-1, -2)
        if causal:
            k_pos = ((my - i) % n) * t + torch.arange(t, device=dev)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
        o, m, l = _block_update((o, m, l), s, v_cur)
        if i < n - 1:
            k_cur = ppermute_next(k_cur, mesh, axis_name)
            v_cur = ppermute_next(v_cur, mesh, axis_name)
    # fully masked rows (causal, first chunk) have l == 0
    l = torch.where(l == 0.0, 1.0, l)
    return (o / l[..., None]).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: DeviceMesh,
                      *, axis_name: str = "sp", causal: bool = False,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Ulysses sequence parallelism: an all-to-all makes each rank hold the
    whole sequence for ``H / n`` heads, attention runs there, and the
    inverse all-to-all restores the sequence split."""
    h = q.shape[1]
    n = axis_size(mesh, axis_name)
    if h % n:
        raise ValueError(f"heads={h} not divisible by sp axis size {n}")

    def scatter_heads(x):  # [B, H, t, D] -> [B, H/n, T, D]
        return all_to_all(x, mesh, axis_name, split_axis=1, concat_axis=2)

    def gather_heads(x):
        return all_to_all(x, mesh, axis_name, split_axis=2, concat_axis=1)

    out = blockwise_attention(scatter_heads(q), scatter_heads(k), scatter_heads(v),
                              causal=causal, scale=scale, block_k=512)
    return gather_heads(out)
