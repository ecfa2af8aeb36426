"""Physical operators for the streaming executor.

The logical plan records stages; this module lowers the streamable part of
a plan into three physical pieces (the reference's
``_internal/execution/operators`` reduced to its load-bearing core):

- an **input source**: an iterator of upstream block refs.  A barrier
  prefix (shuffle/sort/actor-pool) executes eagerly ONCE and is cached on
  the plan, exactly like the eager engine; an ``ObjectRefGenerator`` input
  streams refs as the producer task yields them.
- a **MapOperator**: the maximal fused run of trailing one-to-one stages,
  submitted one task per block.  Submission accepts a locality hint — the
  task dispatches with a soft node affinity toward the node that will
  consume the block, so the output materializes next to its consumer.
- an **output splitter policy**: which split the next block belongs to
  (row-balanced when counts are known, round-robin otherwise).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.data.plan import (
    ExecutionPlan,
    OneToOneStage,
    _run_fused,
)


class MapOperator:
    """Fused one-to-one transform: one remote task per input block."""

    def __init__(self, stages: List[OneToOneStage]):
        self.fns: List[Callable] = [s.fn for s in stages]
        self.name = "+".join(s.name for s in stages)
        self.num_cpus = max(s.num_cpus for s in stages)
        self._task = ray_tpu_torch.remote(num_cpus=self.num_cpus)(_run_fused)

    def submit(self, ref: Any, locality_hint: Optional[str] = None) -> Any:
        """Launch the fused task for one block; returns the output ref.

        ``locality_hint`` dispatches the task with SOFT node affinity: the
        block materializes on the consumer's node when it has capacity, and
        falls back to the default policy (rather than queueing) when not —
        a hint, never a constraint, matching the reference's locality-aware
        output splitting.
        """
        if locality_hint:
            from ray_tpu_torch.util.scheduling_strategies import (
                NodeAffinitySchedulingStrategy,
            )

            return self._task.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    locality_hint, soft=True)
            ).remote(ref, self.fns)
        return self._task.remote(ref, self.fns)


def resolve_streaming_input(
    plan: ExecutionPlan,
) -> Tuple[Any, Optional[List[int]], List[OneToOneStage]]:
    """Split ``plan`` at its last barrier: returns (input refs — a list or
    an ObjectRefGenerator, row counts when known, streamable one-to-one
    suffix stages).  The barrier prefix executes eagerly ONCE and is
    cached on the plan (a second epoch must not redo the shuffle)."""
    if plan._out is not None:
        refs, counts = plan._out
        return list(refs), counts, []
    barrier = -1
    for i, s in enumerate(plan.stages):
        if not isinstance(s, OneToOneStage):
            barrier = i
    suffix = list(plan.stages[barrier + 1:])
    if barrier >= 0:
        cached = getattr(plan, "_stream_prefix_out", None)
        if cached is None:
            prefix_plan = ExecutionPlan(
                plan.input_refs, plan.input_counts,
                plan.stages[:barrier + 1])
            cached = prefix_plan.execute()
            plan._stream_prefix_out = cached
            plan._stats.extend(prefix_plan.stats())
        refs_in, counts_in = cached
        if not suffix:
            # preserve the prefix's row counts in the cache: count() sums
            # them instead of launching a per-block count task
            plan._out = (list(refs_in), counts_in)
        # counts_in describes refs_in (the suffix's INPUT blocks) — the
        # right row weights for equal-mode split assignment either way
        return list(refs_in), counts_in, suffix
    return plan.input_refs, plan.input_counts, suffix


def build_streaming_topology(
    plan: ExecutionPlan,
) -> Tuple[Iterator[Any], Optional[List[int]], Optional[MapOperator]]:
    """Lower ``plan`` into (input ref iterator, input row counts if known,
    map operator or None).

    Mirrors the split the eager engine makes: everything up to the LAST
    barrier stage (AllToAll / actor pool) executes eagerly — and is cached
    on the plan so a second epoch does not redo the shuffle — while the
    trailing one-to-one suffix streams.  A plan with a cached result
    degenerates to a passthrough over its output refs.
    """
    from ray_tpu_torch._private.object_ref import ObjectRefGenerator

    refs_in, counts, suffix = resolve_streaming_input(plan)
    if isinstance(refs_in, ObjectRefGenerator):
        # blocks stream from a num_returns="dynamic" producer task; refs
        # are consumed AS THE PRODUCER YIELDS THEM (listing would block
        # until the producer finishes)
        source: Any = iter(refs_in)
        counts = None
    else:
        if not suffix and not plan.stages and plan._out is None:
            # stage-free list plan: executing just caches (refs, counts)
            refs_in, counts = plan.execute()
        # a LIST (not a bare iterator) tells the executor the source is
        # static, so equal-mode splits can be pre-assigned up front even
        # when row counts are unknown (e.g. after a barrier prefix)
        source = list(refs_in)
    return source, counts, MapOperator(suffix) if suffix else None


def pick_split(
    assigned_rows: List[int],
    assigned_blocks: List[int],
    open_splits: List[int],
    block_rows: Optional[int],
) -> int:
    """Output-splitter policy: the next block goes to the open split with
    the fewest assigned rows (row-balanced when counts are known), blocks
    otherwise — the ``equal``-ish block-granular assignment of the
    reference's OutputSplitter."""
    if block_rows is not None:
        return min(open_splits, key=lambda i: (assigned_rows[i],
                                               assigned_blocks[i], i))
    return min(open_splits, key=lambda i: (assigned_blocks[i], i))
