"""Collectives over one axis of a device mesh, with gradients.

Counterpart of ``ray_tpu/parallel/collective.py``.  The JAX package calls
``jax.lax`` collectives inside ``shard_map``, where an axis name is bound;
here each function takes the ``DeviceMesh`` and the axis name and runs on
the process group of that mesh dim (``mesh.get_group(axis)``), over this
rank's plain tensor.  Each one is differentiable as its JAX transpose is:

- ``allreduce`` (sum) returns a value replicated over the axis and used
  so: its gradient arrives whole on every rank and passes through
  unchanged (the transpose of ``psum`` onto an invariant result);
- :func:`pvary` is its dual: the identity whose gradient is summed over
  the axis, for a replicated value that the ranks use differently;
- ``allgather`` and ``reducescatter`` transpose to each other;
- ``all_to_all`` transposes to the reverse all-to-all;
- ``ppermute_next`` and ``send_recv`` transpose to the inverse
  permutation.

Ranks that a permutation sends nothing to receive zeros, as in
``lax.ppermute``.
"""

from __future__ import annotations

import math
from typing import Any, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch.util.tree import tree_map

Axis = Union[str, Sequence[str]]


def _axes(axis: Axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (read from the mesh, with no
    collective)."""
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)]


def axis_size(mesh: DeviceMesh, axis: Axis) -> int:
    names = mesh.mesh_dim_names
    return math.prod(mesh.size(names.index(a)) for a in _axes(axis))


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op):
        y = x.detach().clone()
        dist.all_reduce(y, op=op, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def allreduce(x: torch.Tensor, mesh: DeviceMesh, axis: Axis, op: str = "sum"
              ) -> torch.Tensor:
    """All-reduce over one or more mesh axes: ``sum``, ``mean``, ``max`` or
    ``min`` (the last two carry no gradient)."""
    if op not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unsupported reduce op {op!r}")
    for a in _axes(axis):
        group = mesh.get_group(a)
        if op in ("max", "min"):
            x = x.detach().clone()
            dist.all_reduce(x, op=_OPS[op], group=group)
        else:
            x = _AllReduce.apply(x, group, _OPS["sum"])
    return x / axis_size(mesh, axis) if op == "mean" else x


def pvary(x: torch.Tensor, mesh: DeviceMesh, axis: Axis) -> torch.Tensor:
    """The identity, with its gradient summed over ``axis`` (``lax.pcast``
    to varying): for a value replicated over the axis that each rank uses
    in its own way."""
    for a in _axes(axis):
        x = _SumGrad.apply(x, mesh.get_group(a))
    return x


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.n, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _reduce_scatter(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, ctx.group, ctx.n, ctx.dim), None, None, None


def _reduce_scatter(x, group, n, dim):
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over {n} ranks")
    parts = [c.contiguous() for c in x.detach().chunk(n, dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def allgather(x: torch.Tensor, mesh: DeviceMesh, axis: str, *, tiled: bool = True,
              gather_axis: int = 0) -> torch.Tensor:
    """All-gather over a mesh axis: concatenated along ``gather_axis``
    (``tiled``) or stacked on a new axis there."""
    if not tiled:
        x = x.unsqueeze(gather_axis)
    return _AllGather.apply(x, mesh.get_group(axis), axis_size(mesh, axis),
                            gather_axis % x.ndim)


def reducescatter(x: torch.Tensor, mesh: DeviceMesh, axis: str, *, scatter_axis: int = 0,
                  op: str = "sum") -> torch.Tensor:
    """Reduce-scatter over a mesh axis (``psum_scatter``, tiled)."""
    if op not in ("sum", "mean"):
        raise ValueError(f"unsupported reduce op {op!r}")
    n = axis_size(mesh, axis)
    out = _ReduceScatter.apply(x, mesh.get_group(axis), n, scatter_axis % x.ndim)
    return out / n if op == "mean" else out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split, concat):
        ctx.group, ctx.n, ctx.split, ctx.concat = group, n, split, concat
        return _all_to_all(x, group, n, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_AllToAll.apply(g, ctx.group, ctx.n, ctx.concat, ctx.split),
                None, None, None, None)


def _all_to_all(x, group, n, split, concat):
    if x.shape[split] % n:
        raise ValueError(f"dim {split} of size {x.shape[split]} does not split over {n} ranks")
    send = torch.stack(x.detach().chunk(n, split))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), concat)


def all_to_all(x: torch.Tensor, mesh: DeviceMesh, axis: str, *, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Tiled all-to-all, the Ulysses primitive: ``split_axis`` is cut into
    one chunk per rank, chunk ``j`` goes to rank ``j``, and the chunks a
    rank receives are concatenated along ``concat_axis`` in rank order."""
    return _AllToAll.apply(x, mesh.get_group(axis), axis_size(mesh, axis),
                           split_axis % x.ndim, concat_axis % x.ndim)


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, me, pairs):
        ctx.group, ctx.me, ctx.pairs = group, me, pairs
        return _permute(x, group, me, pairs)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.pairs)
        return _Permute.apply(g, ctx.group, ctx.me, inverse), None, None, None


def _permute(x, group, me, pairs):
    x = x.detach()
    dst = [d for s, d in pairs if s == me]
    src = [s for s, d in pairs if d == me]
    if dst == [me] and src == [me]:
        return x.clone()
    ranks = dist.get_process_group_ranks(group)
    out = x.new_zeros(x.shape)
    ops = [dist.P2POp(dist.isend, x.contiguous(), ranks[d], group) for d in dst]
    ops += [dist.P2POp(dist.irecv, out, ranks[s], group) for s in src]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def send_recv(x: torch.Tensor, mesh: DeviceMesh, axis: str,
              pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Point-to-point permutation over the axis (``lax.ppermute``): each
    ``(source, destination)`` pair, by axis coordinate, moves the
    source's tensor to the destination; a rank that receives nothing gets
    zeros.  No coordinate may appear twice as a source or destination."""
    pairs = tuple((int(s), int(d)) for s, d in pairs)
    for side in (0, 1):
        seen = [p[side] for p in pairs]
        if len(set(seen)) != len(seen):
            raise ValueError(f"send_recv pairs {pairs} are not a permutation")
    return _Permute.apply(x, mesh.get_group(axis), axis_index(mesh, axis), pairs)


def ppermute_next(x: torch.Tensor, mesh: DeviceMesh, axis: str, *, shift: int = 1
                  ) -> torch.Tensor:
    """Rotate shards around the axis ring: rank ``i`` receives the tensor
    of rank ``(i - shift) % n``."""
    n = axis_size(mesh, axis)
    return send_recv(x, mesh, axis, [(i, (i + shift) % n) for i in range(n)])


def broadcast(x: torch.Tensor, mesh: DeviceMesh, axis: str, root: int = 0) -> torch.Tensor:
    """The root's tensor on every rank of the axis, as a masked sum (the
    JAX package's form, so the gradient goes to the root alone)."""
    return allreduce(x * float(axis_index(mesh, axis) == root), mesh, axis)


def barrier(x: Any, mesh: DeviceMesh, axis: Axis) -> Any:
    """Wait for every rank of the axes, then return ``x``."""
    for a in _axes(axis):
        dist.barrier(group=mesh.get_group(a))
    return x


def grad_sync(grads: Any, mesh: DeviceMesh, axis: Axis, *, mean: bool = True) -> Any:
    """All-reduce a tree of gradients over the data axes (DDP's allreduce),
    in place; returns the tree."""
    def sync(g: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            for a in _axes(axis):
                dist.all_reduce(g, group=mesh.get_group(a))
            if mean:
                g /= axis_size(mesh, axis)
        return g

    return tree_map(sync, grads)


__all__ = ["allreduce", "allgather", "reducescatter", "broadcast", "all_to_all",
           "ppermute_next", "send_recv", "axis_index", "axis_size", "barrier",
           "grad_sync", "pvary"]
