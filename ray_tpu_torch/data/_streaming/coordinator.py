"""Split coordinator: streaming shards for multiple consumer processes.

``Dataset.streaming_split(n)`` must hand each trainer worker a handle it
can iterate from ITS OWN process while one pipeline feeds all of them.
The reference solves this with a ``SplitCoordinator`` actor
(``_internal/execution/streaming_executor`` + ``split_coordinator.py``);
this is the same shape:

- a head-scheduled ``_SplitCoordinator`` actor owns the
  :class:`~ray_tpu_torch.data._streaming.executor.StreamingExecutor` for the
  plan's streamable suffix.  Map tasks dispatch with a soft node-affinity
  hint toward the consuming split's node, so blocks materialize on the
  node that eats them and the consumer's ``get`` is a local zero-copy
  attach — ONE coordinator round trip per block, none per batch.
- each consumer holds a picklable :class:`StreamSplitDataIterator`
  (actor handle + split index) exposing the same ``iter_batches`` surface
  as a Dataset.

Epoch contract (same as the reference): every consumer drains its split
fully per epoch.  The first epoch streams; the coordinator records each
split's block refs (and keeps them pinned), so later epochs replay the
recorded refs in one round trip without re-running the map tasks.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterator, List, Optional

import ray_tpu_torch
from ray_tpu_torch.data._streaming.executor import StreamingExecutor
from ray_tpu_torch.data._streaming.iterator import batches_from_block_iter


class _SplitCoordinator:
    """Actor owning one streaming run fanned out to N splits."""

    def __init__(self, refs: List[Any], counts: Optional[List[int]],
                 stages_blob: bytes, num_splits: int,
                 locality_hints: Optional[List[Optional[str]]],
                 max_in_flight_blocks: Optional[int],
                 equal: bool = True):
        import cloudpickle

        from ray_tpu_torch.data.plan import ExecutionPlan, OneToOneStage

        stages = [OneToOneStage(name, fn, num_cpus)
                  for name, fn, num_cpus in cloudpickle.loads(stages_blob)]
        self._plan = ExecutionPlan(list(refs), counts, stages)
        self._n = num_splits
        self._exec = StreamingExecutor(
            self._plan, num_splits=num_splits,
            locality_hints=locality_hints,
            max_in_flight_blocks=max_in_flight_blocks,
            preassign=equal,
        )
        self._lock = threading.Lock()
        self._recorded: List[List[Any]] = [[] for _ in range(num_splits)]
        self._finished = [False] * num_splits

    def get_block_at(self, split: int, i: int):
        """The split's ``i``-th block (pulling the pipeline forward as
        needed), or None past the end.  INDEX-based on purpose: every
        consumer iteration walks i = 0, 1, 2, ... over the recorded list,
        so a re-iteration after a mid-epoch abandonment replays the full
        shard, and a stale abandoned prefetch thread's concurrent call can
        never make a block vanish — whatever it pulls lands in
        ``_recorded`` where the live iteration's index reaches it."""
        while True:
            with self._lock:
                if i < len(self._recorded[split]):
                    return self._recorded[split][i]
                if self._finished[split]:
                    return None
            ref = self._exec.get_next(split)  # blocking; outside the lock
            with self._lock:
                if ref is None:
                    self._finished[split] = True
                else:
                    self._recorded[split].append(ref)

    def get_replay(self, split: int) -> Optional[List[Any]]:
        """The split's full block list once its first epoch finished
        (later epochs iterate these refs with zero coordinator round
        trips per block), else None."""
        with self._lock:
            if self._finished[split]:
                return list(self._recorded[split])
        return None

    def stats(self) -> Dict[str, Any]:
        return self._exec.stats()


class StreamSplitDataIterator:
    """One consumer's shard of a streaming split (picklable: an actor
    handle plus a split index).  The ``DataIterator`` analog
    (``python/ray/data/iterator.py``): iterate-only — batches stream
    through the coordinator's pipeline; there is no plan to mutate."""

    def __init__(self, coordinator, split: int, world_size: int):
        self._coord = coordinator
        self._split = split
        self._world = world_size

    # -- block plumbing ------------------------------------------------
    def _iter_block_refs(self) -> Iterator[Any]:
        replay = ray_tpu_torch.get(self._coord.get_replay.remote(self._split))
        if replay is not None:
            yield from replay
            return
        # index-walk from 0: a fresh iteration always sees the FULL shard,
        # even if a previous iteration of this split abandoned mid-epoch
        i = 0
        while True:
            ref = ray_tpu_torch.get(
                self._coord.get_block_at.remote(self._split, i))
            if ref is None:
                return
            yield ref
            i += 1

    # -- the Dataset-compatible consumption surface --------------------
    def iter_batches(
        self, *, batch_size: int = 256, batch_format: str = "numpy",
        drop_last: bool = False, prefetch_blocks: int = 2,
    ) -> Iterator[Any]:
        return batches_from_block_iter(
            self._iter_block_refs(), batch_size=batch_size,
            batch_format=batch_format, drop_last=drop_last,
            prefetch_blocks=prefetch_blocks,
        )

    def iter_rows(self) -> Iterator[Any]:
        from ray_tpu_torch.data.block import BlockAccessor

        for ref in self._iter_block_refs():
            yield from BlockAccessor(ray_tpu_torch.get(ref)).iter_rows()

    def iter_torch_batches(self, *, batch_size: Optional[int] = None,
                           prefetch_blocks: int = 1, drop_last: bool = False):
        import numpy as np
        import torch

        for batch in self.iter_batches(
            batch_size=batch_size or 256, batch_format="numpy",
            prefetch_blocks=prefetch_blocks, drop_last=drop_last,
        ):
            if isinstance(batch, dict):
                yield {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
            else:
                yield torch.as_tensor(np.asarray(batch))

    def count(self) -> int:
        from ray_tpu_torch.data.block import BlockAccessor

        return sum(BlockAccessor(ray_tpu_torch.get(ref)).num_rows()
                   for ref in self._iter_block_refs())

    def world_size(self) -> int:
        return self._world

    def stats(self) -> Dict[str, Any]:
        return ray_tpu_torch.get(self._coord.stats.remote())

    def __repr__(self):
        return (f"StreamSplitDataIterator(split={self._split}, "
                f"world_size={self._world})")


def make_split_iterators(
    ds,
    n: int,
    *,
    equal: bool = True,
    locality_hints: Optional[List[Optional[str]]] = None,
    max_in_flight_blocks: Optional[int] = None,
) -> List[StreamSplitDataIterator]:
    """Build the coordinator actor + per-consumer iterators for
    ``Dataset.streaming_split``.

    The barrier prefix (shuffle/sort/actor-pool stages) executes in the
    CALLING process first — driver-side caching applies — and only block
    refs plus the picklable one-to-one suffix ship to the coordinator.
    ``equal`` balances splits at block granularity (row-weighted when
    counts are known); rows are never re-sliced, so splits differ by at
    most one block's rows.
    """
    import cloudpickle

    from ray_tpu_torch._private.object_ref import ObjectRefGenerator
    from ray_tpu_torch.data._streaming.operators import resolve_streaming_input

    if n < 1:
        raise ValueError(f"streaming_split needs n >= 1, got {n}")
    if locality_hints is not None and len(locality_hints) != n:
        raise ValueError(
            f"locality_hints has {len(locality_hints)} entries for {n} splits")
    refs, counts, suffix = resolve_streaming_input(ds._plan)
    if isinstance(refs, ObjectRefGenerator):
        # a dynamic-generator input cannot ship to another process; drain
        # it (the producer's blocks are materialized either way once every
        # split must see a stable assignment)
        refs = list(refs)
        counts = None
    stages_blob = cloudpickle.dumps(
        [(s.name, s.fn, s.num_cpus) for s in suffix])
    Coordinator = ray_tpu_torch.remote(
        num_cpus=0, max_concurrency=n + 2)(_SplitCoordinator)
    coord = Coordinator.remote(list(refs), counts, stages_blob, n,
                               locality_hints, max_in_flight_blocks, equal)
    return [StreamSplitDataIterator(coord, i, n) for i in range(n)]
