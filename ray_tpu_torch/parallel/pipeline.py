"""GPipe microbatch pipelining over the ``pp`` mesh axis.

Counterpart of ``gpipe`` and ``pp_size`` in ``ray_tpu/parallel/pipeline.py``.
The JAX package runs the schedule in a partial-manual ``shard_map`` where
only ``pp`` is manual; here it is per-rank code over the ``pp`` axis while
every other axis stays DTensor on the mesh without ``pp``, so the stage
body keeps its global view of those axes.

- Each ``pp`` rank holds ``L / pp`` contiguous layers: its local shard of
  the stacked leaves, which lie ``Shard(0)`` over ``pp``.
- The batch is cut into ``M`` microbatches and the schedule runs
  ``M + pp - 1`` ticks; at each tick every stage runs its layers on what
  it holds and hands the result to the next stage
  (:func:`~ray_tpu_torch.parallel.collective.ppermute_next`).  Stage 0
  takes microbatch ``t``; the last stage keeps microbatch ``t - (pp - 1)``.
  These choices are masks, not branches, so that every rank records the
  same autograd graph and so runs the same collectives in the backward.
- A stage's aux loss counts only on the ticks where a microbatch is in
  flight there (``stage <= t < stage + M``).
- The finished microbatches and the aux sum are replicated over ``pp`` by
  a masked all-reduce, the aux divided by ``M``.

The backward is autograd through those collectives: there is no
hand-written reverse schedule.

:class:`MicrobatchPipeline` is the same schedule at actor granularity:
stage actors chained by a compiled execution graph (``dag/compiled.py``),
the shape used when stages are whole hosts.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from ray_tpu_torch.parallel.collective import allreduce, axis_index, ppermute_next, pvary


def pp_size(mesh: Optional[DeviceMesh]) -> int:
    """Size of the pipeline axis (1 when absent)."""
    if mesh is None or "pp" not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index("pp"))


def _on_local(fn: Callable, t):
    """``fn`` on this rank's tensor of ``t``, rewrapped as it was."""
    if not isinstance(t, DTensor):
        return fn(t)
    return DTensor.from_local(fn(t.to_local()), t.device_mesh, t.placements,
                              run_check=False)


def gpipe(stage_body: Callable[[Any, Any], Tuple[Any, Any]], blocks: Any, x: DTensor, *,
          mesh: DeviceMesh, n_microbatches: int = 0) -> Tuple[DTensor, Any]:
    """Run ``x`` through a pipeline of stages over the ``pp`` axis.

    Args:
        stage_body: ``(local_blocks, h) -> (h, aux)``, this stage's layers
            on one microbatch; ``aux`` a scalar loss (0 when unused).
        blocks: dict of stacked DTensor leaves laid out on ``mesh``, the
            leading layer axis ``Shard(0)`` over ``pp`` (``L % pp == 0``).
        x: ``[B, ...]`` DTensor on the blocks' device mesh
            (``B % n_microbatches == 0``).
        n_microbatches: ``M`` (default: ``pp``).

    Returns ``(y, aux)``: y like x, replicated over ``pp``, and the aux
    summed over the layers and averaged over the microbatches.
    """
    npp = pp_size(mesh)
    if npp == 1:
        return stage_body(blocks, x)
    M = n_microbatches or npp
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    mesh = x.device_mesh  # the mesh without unit axes (placement_mesh)
    names = mesh.mesh_dim_names
    ip = names.index("pp")
    rest = tuple(a for a in names if a != "pp")
    sub = mesh[rest] if rest else None
    stage = axis_index(mesh, "pp")

    def to_stage(t: DTensor):
        # this rank's tensor over pp, a DTensor over the other axes
        pl = t.placements[:ip] + t.placements[ip + 1:]
        return DTensor.from_local(t.to_local(), sub, pl, run_check=False) if sub else t.to_local()

    for k, v in blocks.items():
        if v.placements[ip] != Shard(0):
            raise ValueError(f"block leaf {k!r} must lie Shard(0) over pp, not {v.placements}")
    local_blocks = {k: to_stage(v) for k, v in blocks.items()}
    xpl = list(x.placements)
    xpl[ip] = Replicate()
    # x is replicated over pp and only stage 0 reads it: its gradient is
    # the sum over the stages
    xs = _on_local(lambda a: pvary(a, mesh, "pp"), to_stage(x.redistribute(mesh, xpl)))

    mb = B // M
    micro = [xs[m * mb:(m + 1) * mb] for m in range(M)]
    # every rank runs the same graph, the rank's part chosen by masks (as
    # in the JAX package): autograd runs a collective's backward only
    # where a gradient reaches it, and each must run on every rank
    on = lambda cond: torch.tensor(cond, device=x.device)
    state = torch.zeros_like(micro[0])
    outputs = [torch.zeros_like(micro[0]) for _ in range(M)]
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    with implicit_replication():
        for t in range(M + npp - 1):
            inp = torch.where(on(stage == 0), micro[min(t, M - 1)], state)
            y, aux = stage_body(local_blocks, inp)
            # microbatch t - stage is in flight here iff 0 <= t - stage < M
            aux_sum = aux_sum + torch.where(on(stage <= t < stage + M), aux, 0.0)
            idx = min(max(t - (npp - 1), 0), M - 1)
            outputs[idx] = torch.where(on(stage == npp - 1 and t >= npp - 1), y, outputs[idx])
            state = _on_local(lambda a: ppermute_next(a, mesh, "pp"), y)
        # the finished microbatches live on the last stage; the masked sum
        # replicates them (and the per-stage aux) over pp
        out = torch.where(on(stage == npp - 1), torch.cat(outputs), 0.0)
        out = _on_local(lambda a: allreduce(a, mesh, "pp"), out)
        aux = _on_local(lambda a: allreduce(a, mesh, "pp"), aux_sum) / M

    def to_mesh(t):
        if not isinstance(t, DTensor):
            return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        pl = list(t.placements)
        pl.insert(ip, Replicate())
        return DTensor.from_local(t.to_local(), mesh, pl, run_check=False)

    return to_mesh(out), to_mesh(aux)


# ---------------------------------------------------------------------------
# Actor-level microbatch pipelining over a compiled execution graph
# ---------------------------------------------------------------------------


class MicrobatchPipeline:
    """The GPipe microbatch schedule at ACTOR granularity, driven by a
    compiled execution graph (``dag/compiled.py``).

    :func:`gpipe` above pipelines *inside* one program over the ``pp``
    mesh axis; this class pipelines *between* stage actors — the shape
    used when stages are whole hosts (one model shard per node) rather
    than mesh slices.  The stage chain compiles once into per-actor
    execution loops connected by pre-allocated channels (shm rings on one
    node, streams between nodes), so streaming ``M`` microbatches keeps
    every stage busy: stage ``k`` processes microbatch ``i`` while stage
    ``k+1`` processes ``i-1`` — the classic ``(S-1)/(M+S-1)`` bubble, with
    per-hop cost a channel write instead of a scheduler round trip.

    ``stages`` are bound actor constructors (``Actor.bind(...)`` class
    nodes); each stage's ``method`` takes the previous stage's output.
    ``n_microbatches`` defaults to ``2 * len(stages)``, and the channels
    hold ``n_microbatches + len(stages)`` executions unless
    ``max_inflight`` is given; other keywords go to
    ``experimental_compile``.
    """

    def __init__(self, stages: Sequence[Any], *, method: str = "run",
                 n_microbatches: int = 0, **compile_kwargs):
        from ray_tpu_torch.dag import InputNode

        if not stages:
            raise ValueError("MicrobatchPipeline needs at least one stage")
        self.n_stages = len(stages)
        self.n_microbatches = n_microbatches or 2 * len(stages)
        with InputNode() as inp:
            h = inp
            for s in stages:
                h = getattr(s, method).bind(h)
        compile_kwargs.setdefault(
            "max_inflight", self.n_microbatches + len(stages))
        self._dag = h.experimental_compile(**compile_kwargs)

    @property
    def actors(self) -> List[Any]:
        return self._dag.actors

    def run(self, microbatches: Sequence[Any],
            timeout: Optional[float] = None) -> List[Any]:
        """Stream the microbatches through the stage chain; returns the
        last stage's outputs in order.  All microbatches are in flight
        together (channel slots bound the depth), which is the entire
        point — submit-then-drain would serialize the stages."""
        refs = [self._dag.execute(mb) for mb in microbatches]
        return [r.get(timeout=timeout) for r in refs]

    def teardown(self) -> None:
        self._dag.teardown()
