"""Logical-axis sharding rules, mapped onto DTensor placements.

Counterpart of ``ray_tpu/parallel/sharding.py``.  Parameters carry
*logical* axis names (``("embed", "mlp")``), a rule table maps them to
mesh axes, and the result is a :class:`PartitionSpec` equal element-wise
to the JAX package's ``P``.  Where the JAX package hands such specs to
``pjit`` as ``NamedSharding``s, the port turns them into DTensor
placements (one per mesh dim: ``Shard(tensor_dim)`` or ``Replicate()``),
and :func:`shard_params` / :func:`shard_batch` make the DTensors the
sharded train step runs on; DTensor's sharding propagation then inserts
the collectives, as GSPMD does.

DTensors live on :func:`placement_mesh`: the mesh without its unit axes.
DTensor's sharding propagation enumerates an op's strategies over every
mesh dim, a cost that grows exponentially with the number of dims (a
six-dim mesh of unit axes stalls on the first embedding lookup), and a
unit axis shards nothing.

A tensor dim sharded over several mesh axes (``("dp", "fsdp")``) is split
major-to-minor in the order the spec names them, as ``NamedSharding``
does; DTensor splits in mesh-dim order, so the spec must name them in
``AXIS_ORDER`` order (``ValueError`` otherwise).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor

from ray_tpu_torch.util.tree import tree_map

MeshAxis = Union[None, str, Tuple[str, ...]]
Placements = Tuple[Placement, ...]


class PartitionSpec(tuple):
    """A tuple of mesh axes per tensor dim (None replicates), the port's
    copy of ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts: MeshAxis) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class ShardingRules:
    """Maps logical axis names to mesh axes (or None = replicate)::

        rules = ShardingRules(batch=("dp", "fsdp"), embed="fsdp", mlp="tp")
        rules.spec(("embed", "mlp"))   # P("fsdp", "tp")
    """

    def __init__(self, **rules: MeshAxis):
        self.rules: Dict[str, MeshAxis] = dict(rules)

    def update(self, **rules: MeshAxis) -> "ShardingRules":
        new = dict(self.rules)
        new.update(rules)
        return ShardingRules(**new)

    def spec(self, logical_axes: Sequence[Optional[str]]) -> PartitionSpec:
        return P(*(self.rules.get(a) if a is not None else None for a in logical_axes))

    def sharding(self, mesh: DeviceMesh, logical_axes: Sequence[Optional[str]]
                 ) -> "NamedSharding":
        return NamedSharding(mesh, self.spec(logical_axes))


# Default rule tables for the canonical modes.  ``None`` replicates.
DP_RULES = ShardingRules(batch="dp", seq=None, embed=None, mlp=None, heads=None,
                         kv=None, vocab=None, expert=None)
FSDP_RULES = ShardingRules(batch=("dp", "fsdp"), seq=None, embed="fsdp", mlp=None,
                           heads=None, kv=None, vocab=None, expert=None)
TP_RULES = ShardingRules(batch="dp", seq=None, embed=None, mlp="tp", heads="tp",
                         kv="tp", vocab="tp", expert=None)
FSDP_TP_RULES = ShardingRules(batch=("dp", "fsdp"), seq=None, embed="fsdp",
                              mlp="tp", heads="tp", kv="tp", vocab="tp", expert=None)
# Long-context: sequence axis sharded over sp (ring attention), params fsdp+tp.
SP_RULES = ShardingRules(batch=("dp", "fsdp"), seq="sp", embed="fsdp", mlp="tp",
                         heads="tp", kv="tp", vocab="tp", expert=None)
# MoE: experts sharded over ep.
EP_RULES = ShardingRules(batch=("dp", "fsdp"), seq=None, embed="fsdp", mlp="tp",
                         heads="tp", kv="tp", vocab="tp", expert="ep")


def rules_for_mesh(mesh: DeviceMesh) -> ShardingRules:
    """Pick a sensible default rule table from the mesh's axes."""
    axes = set(mesh.mesh_dim_names)
    batch = tuple(a for a in ("dp", "fsdp") if a in axes) or None
    if batch is not None and len(batch) == 1:
        batch = batch[0]
    return ShardingRules(
        batch=batch,
        seq="sp" if "sp" in axes else None,
        embed="fsdp" if "fsdp" in axes else None,
        mlp="tp" if "tp" in axes else None,
        heads="tp" if "tp" in axes else None,
        kv="tp" if "tp" in axes else None,
        vocab="tp" if "tp" in axes else None,
        expert="ep" if "ep" in axes else None,
        # the stacked layer axis becomes the pipeline-stage axis
        layers="pp" if "pp" in axes else None,
    )


def placement_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The mesh DTensors live on: ``mesh``'s axes longer than 1, in order
    (its first axis when all are unit axes)."""
    names = mesh.mesh_dim_names
    keep = tuple(a for i, a in enumerate(names) if mesh.size(i) > 1) or names[:1]
    return mesh if keep == names else mesh[keep]


def spec_to_placements(spec: Sequence[MeshAxis], mesh: DeviceMesh) -> Placements:
    """One placement per dim of ``placement_mesh(mesh)`` for a tensor laid
    out by ``spec`` (axes of ``mesh`` of size 1 shard nothing)."""
    names = mesh.mesh_dim_names
    used: List[str] = []
    target = placement_mesh(mesh).mesh_dim_names
    out: List[Placement] = [Replicate()] * len(target)
    for dim, part in enumerate(spec):
        axes = (part,) if isinstance(part, str) else tuple(part or ())
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {tuple(spec)} names axis {a!r}, not in mesh {names}")
            if a in used:
                raise ValueError(f"spec {tuple(spec)} uses mesh axis {a!r} twice")
            used.append(a)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {tuple(spec)} splits dim {dim} over {axes}, against "
                             f"the mesh order {names}")
        for a in axes:
            if a in target:
                out[target.index(a)] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a mesh, the port's ``jax.sharding.NamedSharding``: its
    DTensors live on ``device_mesh`` (``placement_mesh(mesh)``) with
    ``placements``."""

    mesh: DeviceMesh
    spec: PartitionSpec

    @property
    def device_mesh(self) -> DeviceMesh:
        return placement_mesh(self.mesh)

    @property
    def placements(self) -> Placements:
        return spec_to_placements(self.spec, self.mesh)


def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def logical_to_sharding(logical_tree: Any, mesh: DeviceMesh, rules: ShardingRules) -> Any:
    """Map a tree of logical-axis tuples to a tree of ``NamedSharding``s."""
    return _map_axes(lambda axes: rules.sharding(mesh, axes), logical_tree)


def _map_axes(fn, tree):
    if _is_axes(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    raise TypeError(f"not a logical-axes tree: {tree!r}")


def infer_sharding(params: Any, mesh: DeviceMesh, rules: ShardingRules) -> Any:
    """Heuristic ``NamedSharding``s for an unannotated param tree.

    FSDP-style: shard the largest dim divisible by the first param axis
    present (``fsdp``, then ``tp``), replicate arrays under 1024 elements.
    """
    names = mesh.mesh_dim_names
    axes = [a for a in ("fsdp", "tp") if a in names]

    def _spec(x) -> NamedSharding:
        if not isinstance(x, torch.Tensor) or not axes or x.ndim == 0 or x.numel() < 1024:
            return NamedSharding(mesh, P())
        ax = axes[0]
        n = mesh.size(names.index(ax))
        # shard the largest dim divisible by the axis size
        for i in sorted(range(x.ndim), key=lambda i: -x.shape[i]):
            if x.shape[i] % n == 0:
                parts: list = [None] * x.ndim
                parts[i] = ax
                return NamedSharding(mesh, P(*parts))
        return NamedSharding(mesh, P())

    return tree_map(_spec, params)


def with_sharding_constraint(x: torch.Tensor, mesh: DeviceMesh, spec: Sequence[MeshAxis]
                             ) -> DTensor:
    """``x`` laid out by ``spec`` on ``mesh`` (a plain tensor is taken as
    replicated): DTensor's ``redistribute``, differentiable."""
    target = NamedSharding(mesh, P(*spec))
    dmesh = target.device_mesh
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, dmesh, [Replicate()] * dmesh.ndim, run_check=False)
    return x.redistribute(dmesh, target.placements)


def shard_params(params: Any, mesh: DeviceMesh, rules: ShardingRules, logical_axes: Any
                 ) -> Any:
    """The params as DTensors laid out by ``logical_axes`` under ``rules``:
    the counterpart of ``jax.jit(init, out_shardings=...)``.  Every rank
    passes the whole tensors; rank 0's values are scattered, so each rank
    holds its shard.  Leaves come back as fresh leaf tensors."""
    shardings = logical_to_sharding(logical_axes, mesh, rules)

    def go(p, sh):
        if isinstance(p, dict):
            return {k: go(v, sh[k]) for k, v in p.items()}
        return distribute_tensor(p.detach(), sh.device_mesh, sh.placements)

    return go(params, shardings)


def shard_batch(batch: Dict[str, torch.Tensor], mesh: DeviceMesh, rules: ShardingRules
                ) -> Dict[str, DTensor]:
    """Each tensor of ``batch`` (the whole batch, the same on every rank)
    as a DTensor laid out ``(batch, seq)``; one that is a DTensor already
    is kept as it is."""
    def put(v):
        sh = rules.sharding(mesh, ("batch", "seq", *(None,) * (v.ndim - 2))[:v.ndim])
        return distribute_tensor(v, sh.device_mesh, sh.placements)

    return {k: v if isinstance(v, DTensor) else put(v) for k, v in batch.items()}


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_tensor(t: DTensor, placements: Sequence[Placement]) -> torch.Tensor:
    """This rank's tensor of ``t`` laid out by ``placements`` on its own
    mesh: the way into per-rank code.  Differentiable; the gradient goes
    back contiguous, as DTensor's view rules read the global strides and
    refuse a local tensor laid out otherwise."""
    return _ContiguousGrad.apply(t.redistribute(t.device_mesh, placements).to_local())


def from_local(t: torch.Tensor, mesh: DeviceMesh, placements: Sequence[Placement]
               ) -> DTensor:
    """A DTensor of every rank's ``t`` under ``placements``: the way out of
    per-rank code (no check that replicated values agree)."""
    return DTensor.from_local(t.contiguous(), mesh, placements, run_check=False)
