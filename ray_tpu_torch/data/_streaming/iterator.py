"""Shared batch-iteration engine over a stream of block refs.

One implementation feeds every consumption surface — ``Dataset.iter_batches``,
``StreamSplitDataIterator.iter_batches`` (trainer shards), and the bench's
ingest loop — so batching, prefetch, and zero-copy slicing semantics can
never diverge between the driver path and the per-worker shard path.

Zero-copy contract: a fetched block is a deserialized view over its sealed
store segment (mmap/arena slice); batch slicing stays columnar
(``BlockAccessor.slice`` — numpy views / ``pa.Table.slice``), so the bytes
of a batch are never copied between the producing task's seal and the
training loop, except at the block-boundary carry concat.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Any, Callable, Iterator, Optional

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor


def format_batch(block: Block, batch_format: str):
    acc = BlockAccessor(block)
    if batch_format == "rows":
        return acc.to_rows()
    if batch_format == "pandas":
        import pandas as pd

        return pd.DataFrame(acc.to_rows())
    if batch_format in ("pyarrow", "arrow"):
        return acc.to_arrow()
    if batch_format != "numpy":
        raise ValueError(f"unknown batch_format {batch_format!r}")
    batch = acc.to_batch()
    if set(batch) == {"value"}:
        return batch["value"]
    return batch


def batches_from_block_iter(
    refs: Iterator[Any],
    *,
    batch_size: int = 256,
    batch_format: str = "numpy",
    drop_last: bool = False,
    prefetch_blocks: int = 2,
    on_abandon: Optional[Callable[[], None]] = None,
) -> Iterator[Any]:
    """Stream batches from an iterator of block refs.

    A background thread keeps up to ``prefetch_blocks`` blocks materialized
    ahead of consumption, so object fetch (incl. cross-node pulls) overlaps
    compute; abandoning the iterator stops the fetcher promptly.

    ``on_abandon`` (e.g. the producing executor's ``shutdown``) runs at
    cleanup: while the fetcher thread is suspended INSIDE the ``refs``
    generator frame, ``refs.close()`` cannot run (``ValueError: generator
    already executing``), so the producer must be stopped out-of-band —
    shutdown wakes the fetcher, the generator exits, and nothing leaks.
    """
    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=max(1, prefetch_blocks))
    SENTINEL = object()
    stop = threading.Event()

    def put_or_stop(item) -> bool:
        """Stop-aware put; True if delivered."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue_mod.Full:
                continue
        return False

    def fetcher():
        from ray_tpu_torch._private.worker import global_worker

        if global_worker.mode == "worker":
            # task_depth is THREAD-local; without inheriting it here this
            # thread's blocking gets never notify the head, so the worker's
            # CPU lease is not released and tasks pipelined behind the
            # consuming task cannot be reclaimed — if one of those produces
            # the very block this get waits on, that's a deadlock
            global_worker.task_depth = 1
        try:
            for ref in refs:
                block = ray_tpu_torch.get(ref)
                if not put_or_stop(block):
                    return  # consumer abandoned the iterator
        except BaseException as e:  # surfaced on the consumer side
            put_or_stop(e)
            return
        put_or_stop(SENTINEL)

    t = threading.Thread(target=fetcher, daemon=True,
                         name="iter-batches-prefetch")
    t.start()
    from ray_tpu_torch._private import events as _events

    ingest_wait_counter = None
    if _events.ENABLED:
        from ray_tpu_torch.util.metrics import Counter

        ingest_wait_counter = Counter(
            "ray_tpu_torch_data_ingest_wait_s_total",
            "consumer seconds blocked waiting for the next block "
            "(train ingest-wait)")
    try:
        # the carry and all slicing stay columnar for table blocks —
        # numpy views, no per-row python objects on the hot path
        carry: Optional[Block] = None
        import time as _time

        while True:
            t0 = _time.perf_counter() if ingest_wait_counter else 0.0
            item = q.get()
            if ingest_wait_counter is not None:
                waited = _time.perf_counter() - t0
                if waited > 1e-4:
                    ingest_wait_counter.inc(waited)
            if item is SENTINEL:
                break
            if isinstance(item, BaseException):
                raise item
            block = item if carry is None else BlockAccessor.concat([carry, item])
            carry = None
            acc = BlockAccessor(block)
            n, pos = acc.num_rows(), 0
            while n - pos >= batch_size:
                yield format_batch(acc.slice(pos, pos + batch_size), batch_format)
                pos += batch_size
            if pos < n:
                carry = acc.slice(pos, n)
        if carry is not None and BlockAccessor(carry).num_rows() and not drop_last:
            yield format_batch(carry, batch_format)
    finally:
        # unblocks (and ends) the fetcher if the consumer broke early
        stop.set()
        if on_abandon is not None:
            on_abandon()  # stop the producer first so the fetcher wakes
        close = getattr(refs, "close", None)
        if close is not None:
            try:
                close()
            except ValueError:
                # the fetcher is mid-next() inside the generator frame;
                # on_abandon already stopped the producer, so the frame
                # unwinds on its own and close() is unnecessary
                pass
