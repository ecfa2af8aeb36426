"""Streaming data-plane executor (the ``_internal/streaming_executor``
analog).

An execution layer between the lazy :class:`~ray_tpu_torch.data.plan.ExecutionPlan`
and the object plane: the plan's one-to-one suffix runs as a pipeline of
operators with a bounded in-flight block budget (backpressure), blocks are
assigned to output splits locality-aware (map tasks dispatch with a soft
node-affinity hint toward the consuming trainer's node, so blocks
materialize where they are eaten and ``get`` attaches them zero-copy
instead of pulling), and batches slice sealed store segments without
copying.

Layers:

- :mod:`.operators` — the physical operator descriptors built from a plan
  (input source, fused map operator, output splitter policy).
- :mod:`.executor` — ``StreamingExecutor``: the driver-side pump that runs
  the operator pipeline under a block budget and feeds per-split queues.
- :mod:`.coordinator` — the head-scheduled coordinator actor behind
  ``Dataset.streaming_split`` plus the picklable per-consumer
  ``StreamSplitDataIterator`` handed to trainer workers.
"""

from ray_tpu_torch.data._streaming.executor import StreamingExecutor
from ray_tpu_torch.data._streaming.iterator import batches_from_block_iter
from ray_tpu_torch.data._streaming.coordinator import (
    StreamSplitDataIterator,
    make_split_iterators,
)

__all__ = [
    "StreamingExecutor",
    "StreamSplitDataIterator",
    "batches_from_block_iter",
    "make_split_iterators",
]
