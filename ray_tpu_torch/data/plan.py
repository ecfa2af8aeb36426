"""Lazy execution plan over blocks — the ExecutionPlan analog.

The reference builds a deferred graph of stages and fuses compatible ones
before running tasks (``python/ray/data/_internal/plan.py:74``,
``_OneToOneStage``/``_AllToAllStage`` fusion): transforms on a Dataset
only record stages; execution happens once, at consumption.  Chains of
one-to-one stages (map/filter/flat_map/map_batches) are fused into a
single remote task per block — one serialization boundary and one
scheduling round-trip for the whole chain instead of one per stage.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.data.block import Block

# An AllToAll stage takes the realized block refs (+ row counts when
# known) and returns new refs (+ counts when known).
AllToAllFn = Callable[[List[Any], Optional[List[int]]],
                      Tuple[List[Any], Optional[List[int]]]]


@dataclass
class OneToOneStage:
    """block -> block transform; fusable with neighbors of the same kind."""

    name: str
    fn: Callable[[Block], Block]
    num_cpus: float = 1.0


@dataclass
class AllToAllStage:
    """Global reorganization (shuffle/sort/repartition): sees all refs."""

    name: str
    fn: AllToAllFn


@dataclass
class ActorPoolStage:
    """map_batches over a pool of stateful actors; not fusable."""

    name: str
    submit: Callable[[List[Any]], List[Any]]  # refs -> refs


Stage = Any  # OneToOneStage | AllToAllStage | ActorPoolStage


def _run_fused(block: Block, fns: List[Callable[[Block], Block]]) -> Block:
    for f in fns:
        block = f(block)
    return block


def fuse_one_to_one(stages: List["OneToOneStage"]):
    """(remote task, fns, fused name) for a run of one-to-one stages —
    shared by eager execution and the streaming iterator so fusion
    semantics can never diverge."""
    fns = [s.fn for s in stages]
    task = ray_tpu_torch.remote(num_cpus=max(s.num_cpus for s in stages))(_run_fused)
    return task, fns, "+".join(s.name for s in stages)


@dataclass
class ExecutionPlan:
    """Input block refs + recorded stages; executes at most once."""

    input_refs: List[Any]
    input_counts: Optional[List[int]] = None
    stages: List[Stage] = field(default_factory=list)
    _out: Optional[Tuple[List[Any], Optional[List[int]]]] = None
    _stats: List[Dict[str, Any]] = field(default_factory=list)

    def with_stage(self, stage: Stage) -> "ExecutionPlan":
        """New plan sharing this plan's prefix (and its cached result)."""
        child = ExecutionPlan(self.input_refs, self.input_counts,
                              self.stages + [stage])
        # share the cache of the executed prefix through the parent
        child._parent = self  # type: ignore[attr-defined]
        return child

    def execute(self) -> Tuple[List[Any], Optional[List[int]]]:
        if self._out is not None:
            return self._out
        parent = getattr(self, "_parent", None)
        if parent is not None and parent._out is not None and \
                self.stages[:-1] == parent.stages:
            refs, counts = parent._out
            start = len(parent.stages)
        else:
            refs, counts = self.input_refs, self.input_counts
            if not isinstance(refs, list):
                # streaming (ObjectRefGenerator) input forced by a stage or
                # a full materialization: drain the producer
                refs = list(refs)
                self.input_refs = refs
            start = 0
        i = start
        while i < len(self.stages):
            t0 = time.perf_counter()
            stage = self.stages[i]
            if isinstance(stage, OneToOneStage):
                # fuse the maximal run of one-to-one stages
                run = [stage]
                while i + 1 < len(self.stages) and isinstance(self.stages[i + 1], OneToOneStage):
                    i += 1
                    run.append(self.stages[i])
                task, fns, name = fuse_one_to_one(run)
                refs = [task.remote(r, fns) for r in refs]
                counts = None  # row counts unknown after a transform
            elif isinstance(stage, ActorPoolStage):
                refs = stage.submit(refs)
                counts = None
                name = stage.name
            else:
                refs, counts = stage.fn(refs, counts)
                name = stage.name
            self._stats.append({"stage": name,
                                "wall_s": round(time.perf_counter() - t0, 4),
                                "blocks": len(refs)})
            i += 1
        self._out = (refs, counts)
        return self._out

    def stats(self) -> List[Dict[str, Any]]:
        return list(self._stats)
