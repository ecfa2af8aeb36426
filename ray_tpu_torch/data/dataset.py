"""Dataset: distributed data over object-store blocks, lazily planned.

Analog of ``python/ray/data/dataset.py:139``: a Dataset is an
:class:`~ray_tpu_torch.data.plan.ExecutionPlan` — input block refs plus
recorded stages.  Transforms are lazy; chains of per-block stages fuse
into one task per block (``_internal/plan.py:74``); global ops
(``random_shuffle``/``sort``/``repartition``) run as distributed
map-partition/reduce shuffles (``_internal/push_based_shuffle.py``) that
never materialize rows on the driver.  Stateful batch transforms run on
an actor pool (``ActorPoolStrategy``, ``_internal/compute.py:176``) —
e.g. a model on ``num_gpus=1`` actors (or a share of a card) for batch
inference.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.plan import ActorPoolStage, ExecutionPlan, OneToOneStage


def _apply_batches(block: Block, fn: Callable, batch_size: Optional[int],
                   batch_format: str) -> Block:
    acc = BlockAccessor(block)
    n = acc.num_rows()
    if n == 0:
        return block
    size = batch_size or n
    outs = []
    for start in range(0, n, size):
        sub = BlockAccessor(acc.slice(start, min(start + size, n)))
        if batch_format == "numpy":
            batch = sub.to_batch()
            if set(batch) == {"value"}:
                batch = batch["value"]
        elif batch_format == "rows":
            batch = sub.to_rows()
        else:
            raise ValueError(f"unknown batch_format {batch_format!r}")
        outs.append(BlockAccessor.from_batch(fn(batch)))
    return BlockAccessor.concat(outs)


def _map_rows(block: Block, fn: Callable) -> Block:
    return [fn(r) for r in BlockAccessor(block).iter_rows()]


def _flat_map(block: Block, fn: Callable) -> Block:
    out: List[Any] = []
    for r in BlockAccessor(block).iter_rows():
        out.extend(fn(r))
    return out


def _filter(block: Block, fn: Callable) -> Block:
    return [r for r in BlockAccessor(block).iter_rows() if fn(r)]


def _partial_agg(block: Block, on: Optional[str]):
    """Per-block partial aggregate: (count, sum, min, max, sumsq)."""
    batch = BlockAccessor(block).to_batch()
    if not batch:
        return (0, 0.0, None, None, 0.0)
    col = on or ("value" if "value" in batch else next(iter(batch)))
    arr = np.asarray(batch[col], dtype=np.float64)
    if arr.size == 0:
        return (0, 0.0, None, None, 0.0)
    return (int(arr.size), float(arr.sum()), float(arr.min()),
            float(arr.max()), float((arr ** 2).sum()))


class _BatchWorker:
    """ActorPoolStrategy worker: holds a callable-class instance."""

    def __init__(self, fn_cls_blob: bytes, args: tuple, kwargs: dict):
        import cloudpickle

        cls = cloudpickle.loads(fn_cls_blob)
        self.fn = cls(*args, **kwargs)

    def apply(self, block: Block, batch_size: Optional[int], batch_format: str) -> Block:
        return _apply_batches(block, self.fn, batch_size, batch_format)


def _release_pool(pool: List[Any], out: List[Any]) -> None:
    """Kill the pool's actors once every output block is sealed (a
    failed ``apply`` counts: its error is sealed in its place), so their
    grants return to the head.  The blocks stay in the object store."""
    try:
        ray_tpu_torch.wait(out, num_returns=len(out))
        for actor in pool:
            ray_tpu_torch.kill(actor)
    except Exception:
        if ray_tpu_torch.is_initialized():
            raise
        # else the runtime shut down first, and the pool went with it


class ActorPoolStrategy:
    def __init__(self, size: int = 2, min_size: Optional[int] = None,
                 max_size: Optional[int] = None):
        self.size = max_size or size


class Dataset:
    def __init__(self, blocks_or_plan, num_rows: Optional[List[int]] = None):
        from ray_tpu_torch._private.object_ref import ObjectRefGenerator

        if isinstance(blocks_or_plan, ExecutionPlan):
            self._plan = blocks_or_plan
        elif isinstance(blocks_or_plan, ObjectRefGenerator):
            # blocks stream from a num_returns="dynamic" producer task;
            # iter_batches consumes them as yielded (listing would block
            # until the producer finishes)
            self._plan = ExecutionPlan(blocks_or_plan, None)
        else:
            self._plan = ExecutionPlan(list(blocks_or_plan), num_rows)

    # -- plan plumbing -------------------------------------------------
    @property
    def _blocks(self) -> List[Any]:
        """Realized block refs (executes the plan)."""
        return self._plan.execute()[0]

    @property
    def _counts(self) -> Optional[List[int]]:
        return self._plan.execute()[1]

    def _with_stage(self, stage) -> "Dataset":
        return Dataset(self._plan.with_stage(stage))

    def _iter_block_refs(self):
        """Block refs in order, through the streaming executor
        (``data/_streaming`` — the streaming_executor analog):

        - a stage-free plan over an ObjectRefGenerator yields refs AS THE
          PRODUCER TASK YIELDS THEM (never materializing the block list)
        - a plan whose trailing stages are all one-to-one streams them:
          the pump submits fused map tasks up to a bounded in-flight block
          budget ahead of consumption (backpressure), so reads/transforms
          overlap training ingest instead of materializing stage-by-stage
        - a trailing shuffle/actor-pool stage executes eagerly first (and
          is cached on the plan), then the remainder streams

        Fully draining the iterator caches the refs as the plan's result,
        so re-iteration and count()/take() reuse them.
        """
        from ray_tpu_torch.data._streaming import StreamingExecutor

        executor = StreamingExecutor(self._plan)
        try:
            yield from executor.iter_refs()
        finally:
            executor.shutdown()

    def stats(self) -> List[Dict[str, Any]]:
        """Per-stage execution stats (the _internal/stats.py analog)."""
        return self._plan.stats()

    # -- basics --------------------------------------------------------
    def num_blocks(self) -> int:
        return len(self._blocks)

    def count(self) -> int:
        from ray_tpu_torch.data.shuffle import compute_counts

        refs, counts = self._plan.execute()
        if counts is None:
            counts = compute_counts(refs, None)
            self._plan._out = (refs, counts)
        return sum(counts)

    def schema(self) -> Optional[Dict[str, str]]:
        for b in self._blocks:
            s = BlockAccessor(ray_tpu_torch.get(b)).schema()
            if s:
                return s
        return None

    def take(self, limit: int = 20) -> List[Any]:
        out: List[Any] = []
        for ref in self._blocks:
            out.extend(BlockAccessor(ray_tpu_torch.get(ref)).to_rows())
            if len(out) >= limit:
                break
        return out[:limit]

    def take_all(self) -> List[Any]:
        out: List[Any] = []
        for ref in self._blocks:
            out.extend(BlockAccessor(ray_tpu_torch.get(ref)).to_rows())
        return out

    def show(self, limit: int = 20) -> None:
        for row in self.take(limit):
            print(row)

    # -- transforms (lazy one-to-one stages; fused at execution) -------
    def map(self, fn: Callable) -> "Dataset":
        return self._with_stage(OneToOneStage("map", lambda b, fn=fn: _map_rows(b, fn)))

    def flat_map(self, fn: Callable) -> "Dataset":
        return self._with_stage(OneToOneStage("flat_map", lambda b, fn=fn: _flat_map(b, fn)))

    def filter(self, fn: Callable) -> "Dataset":
        return self._with_stage(OneToOneStage("filter", lambda b, fn=fn: _filter(b, fn)))

    def map_batches(
        self,
        fn: Union[Callable, type],
        *,
        batch_size: Optional[int] = None,
        batch_format: str = "numpy",
        compute: Optional[ActorPoolStrategy] = None,
        fn_constructor_args: tuple = (),
        fn_constructor_kwargs: Optional[dict] = None,
        num_gpus: float = 0,
    ) -> "Dataset":
        """Batch transform (dataset.py:323).  Pass a class + ActorPoolStrategy
        for stateful fns (model inference on card actors).

        Each pool actor asks for ``{"num_cpus": 1, "num_gpus": num_gpus}``:
        a whole card, or a share of one (``0 < num_gpus < 1``, several
        actors on card 0); its grant is its ``CUDA_VISIBLE_DEVICES``, so
        the class makes its CUDA context in its own constructor.  The pool
        is killed once every block it was given is sealed, which gives its
        cards back for the next pool."""
        if isinstance(fn, type):
            if compute is None:
                compute = ActorPoolStrategy()
            import cloudpickle

            blob = cloudpickle.dumps(fn)
            opts = {"num_cpus": 1}
            if num_gpus:
                opts["num_gpus"] = num_gpus
            size = compute.size
            ctor_args = (blob, fn_constructor_args, fn_constructor_kwargs or {})

            def submit(refs: List[Any]) -> List[Any]:
                Worker = ray_tpu_torch.remote(**opts)(_BatchWorker)
                pool = [Worker.remote(*ctor_args)
                        for _ in range(min(size, len(refs) or 1))]
                out = [pool[i % len(pool)].apply.remote(ref, batch_size, batch_format)
                       for i, ref in enumerate(refs)]
                threading.Thread(target=_release_pool, args=(pool, out), daemon=True,
                                 name="actor-pool-release").start()
                return out

            return self._with_stage(ActorPoolStage("map_batches(actors)", submit))
        return self._with_stage(OneToOneStage(
            "map_batches",
            lambda b, fn=fn: _apply_batches(b, fn, batch_size, batch_format),
        ))

    # -- global reorgs (distributed shuffles; driver touches refs only) -
    def repartition(self, num_blocks: int) -> "Dataset":
        from ray_tpu_torch.data.shuffle import repartition_stage

        return self._with_stage(repartition_stage(num_blocks))

    def random_shuffle(self, *, seed: Optional[int] = None,
                       num_blocks: Optional[int] = None) -> "Dataset":
        from ray_tpu_torch.data.shuffle import random_shuffle_stage

        return self._with_stage(random_shuffle_stage(seed, num_blocks))

    def sort(self, key: Optional[Union[str, Callable]] = None,
             descending: bool = False) -> "Dataset":
        from ray_tpu_torch.data.shuffle import sort_stage

        return self._with_stage(sort_stage(key, descending))

    def split(self, n: int, *, equal: bool = True) -> List["Dataset"]:
        """n shards for n training workers (dataset.py:1017) — block-level
        re-slicing through tasks; rows never surface on the driver."""
        from ray_tpu_torch.data.shuffle import _reduce_concat, compute_counts, range_partition

        refs, counts = self._plan.execute()
        if n == 1:
            return [Dataset(refs, counts)]
        counts = compute_counts(refs, counts)
        total = sum(counts)
        per = total // n
        if equal:
            bounds_all = [per * j for j in range(1, n)]
            if per * n < total:
                bounds_all.append(per * n)  # remainder goes to a dropped part
        else:
            base = [per + (1 if j < total % n else 0) for j in range(n)]
            bounds_all = list(np.cumsum(base)[:-1])
        parts = range_partition(refs, counts, bounds_all)
        reducer = ray_tpu_torch.remote(num_cpus=1)(_reduce_concat)
        return [Dataset([reducer.remote(None, False, *parts[j])]) for j in range(n)]

    def split_at_indices(self, indices: Sequence[int]) -> List["Dataset"]:
        rows = self.take_all()
        out, prev = [], 0
        for idx in list(indices) + [len(rows)]:
            chunk = rows[prev:idx]
            out.append(Dataset([ray_tpu_torch.put(chunk)], [len(chunk)]))
            prev = idx
        return out

    def union(self, *others: "Dataset") -> "Dataset":
        refs = list(self._blocks)
        counts = self._counts
        all_counts: Optional[List[int]] = list(counts) if counts is not None else None
        for o in others:
            refs.extend(o._blocks)
            oc = o._counts
            if all_counts is not None and oc is not None:
                all_counts.extend(oc)
            else:
                all_counts = None
        return Dataset(refs, all_counts)

    def zip(self, other: "Dataset") -> "Dataset":
        """Row-aligned zip: both datasets are sliced at the SAME global row
        boundaries (truncated to the shorter), so row i always pairs with
        row i regardless of each side's block layout."""
        from ray_tpu_torch.data.shuffle import _reduce_concat, compute_counts, range_partition

        a_refs, a_counts = self._plan.execute()
        b_refs, b_counts = other._plan.execute()
        a_counts = compute_counts(a_refs, a_counts)
        b_counts = compute_counts(b_refs, b_counts)
        total = min(sum(a_counts), sum(b_counts))
        n = max(1, max(len(a_refs), len(b_refs)))
        per = [total // n + (1 if j < total % n else 0) for j in range(n)]
        bounds = list(np.cumsum(per)[:-1]) + ([total] if total < max(sum(a_counts), sum(b_counts)) else [])
        reducer = ray_tpu_torch.remote(num_cpus=1)(_reduce_concat)
        a_parts = range_partition(a_refs, a_counts, bounds)
        b_parts = range_partition(b_refs, b_counts, bounds)
        a_refs = [reducer.remote(None, False, *a_parts[j]) for j in range(n)]
        b_refs = [reducer.remote(None, False, *b_parts[j]) for j in range(n)]

        def zip_blocks(x: Block, y: Block) -> Block:
            rows = []
            for rx, ry in zip(BlockAccessor(x).iter_rows(), BlockAccessor(y).iter_rows()):
                dx = rx if isinstance(rx, dict) else {"left": rx}
                dy = ry if isinstance(ry, dict) else {"right": ry}
                rows.append({**dx, **{(f"right_{k}" if k in dx else k): v
                                      for k, v in dy.items()}})
            return rows

        task = ray_tpu_torch.remote(num_cpus=1)(zip_blocks)
        return Dataset([task.remote(x, y) for x, y in zip(a_refs, b_refs)])

    # -- aggregates (per-block partials; only scalars reach the driver) -
    def _agg(self, on: Optional[str]):
        task = ray_tpu_torch.remote(num_cpus=1)(_partial_agg)
        parts = ray_tpu_torch.get([task.remote(r, on) for r in self._blocks])
        count = sum(p[0] for p in parts)
        if count == 0:
            return None
        total = sum(p[1] for p in parts)
        mn = min(p[2] for p in parts if p[0])
        mx = max(p[3] for p in parts if p[0])
        sumsq = sum(p[4] for p in parts)
        return count, total, mn, mx, sumsq

    def _agg_nonempty(self, on: Optional[str], op: str):
        agg = self._agg(on)
        if agg is None:
            raise ValueError(f"cannot compute {op}() of an empty dataset")
        return agg

    def sum(self, on: Optional[str] = None):
        agg = self._agg(on)
        return agg[1] if agg else 0

    def min(self, on: Optional[str] = None):
        return self._agg_nonempty(on, "min")[2]

    def max(self, on: Optional[str] = None):
        return self._agg_nonempty(on, "max")[3]

    def mean(self, on: Optional[str] = None):
        count, total, *_ = self._agg_nonempty(on, "mean")
        return total / count

    def std(self, on: Optional[str] = None):
        count, total, _, _, sumsq = self._agg_nonempty(on, "std")
        return float(np.sqrt(max(0.0, sumsq / count - (total / count) ** 2)))

    def groupby(self, key: Union[str, Callable]) -> "GroupedData":
        return GroupedData(self, key)

    # -- consumption ---------------------------------------------------
    def iter_rows(self) -> Iterator[Any]:
        for ref in self._blocks:
            yield from BlockAccessor(ray_tpu_torch.get(ref)).iter_rows()

    def iter_batches(
        self, *, batch_size: int = 256, batch_format: str = "numpy",
        drop_last: bool = False, prefetch_blocks: int = 2,
    ) -> Iterator[Any]:
        """Stream batches (dataset.py:2624) through the streaming executor:
        trailing map stages run as a backpressured pipeline overlapping
        consumption, a background thread keeps up to ``prefetch_blocks``
        blocks materialized ahead, and batch slicing is zero-copy over the
        fetched blocks' sealed store segments."""
        from ray_tpu_torch.data._streaming import (
            StreamingExecutor,
            batches_from_block_iter,
        )

        # the executor is created here (not inside a ref generator) so the
        # batch iterator can shut it down on abandonment even while the
        # prefetch thread is suspended inside the generator frame
        executor = StreamingExecutor(self._plan)
        return batches_from_block_iter(
            executor.iter_refs(), batch_size=batch_size,
            batch_format=batch_format, drop_last=drop_last,
            prefetch_blocks=prefetch_blocks, on_abandon=executor.shutdown,
        )

    def streaming_split(
        self, n: int, *, equal: bool = True,
        locality_hints: Optional[List[Optional[str]]] = None,
        max_in_flight_blocks: Optional[int] = None,
    ) -> List[Any]:
        """``n`` disjoint streaming shards over ONE shared pipeline
        (``Dataset.streaming_split`` analog): each returned
        ``StreamSplitDataIterator`` is picklable and is iterated from its
        consumer's own process; the coordinator assigns blocks to shards
        as they are produced (row-balanced with ``equal``), dispatches
        each shard's map tasks toward ``locality_hints[i]`` (a node id —
        blocks materialize on the consuming trainer's node), and bounds
        in-flight blocks per shard (backpressure).  Contrast ``split()``:
        no eager plan execution, no reducer tasks, no per-batch head
        round trip."""
        from ray_tpu_torch.data._streaming import make_split_iterators

        return make_split_iterators(
            self, n, equal=equal, locality_hints=locality_hints,
            max_in_flight_blocks=max_in_flight_blocks)

    @staticmethod
    def _format_batch(block: Block, batch_format: str):
        from ray_tpu_torch.data._streaming.iterator import format_batch

        return format_batch(block, batch_format)

    def to_numpy(self, column: Optional[str] = None) -> np.ndarray:
        vals: List[np.ndarray] = []
        for ref in self._blocks:
            batch = BlockAccessor(ray_tpu_torch.get(ref)).to_batch()
            if not batch:
                continue
            col = column or ("value" if "value" in batch else next(iter(batch)))
            vals.append(np.asarray(batch[col]))
        return np.concatenate(vals) if vals else np.asarray([])

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame(self.take_all())

    def materialize(self) -> "Dataset":
        ray_tpu_torch.get(self._blocks)
        return self

    def to_torch(
        self,
        *,
        label_column: Optional[str] = None,
        feature_columns: Optional[List[str]] = None,
        batch_size: int = 1,
        prefetch_blocks: int = 1,
        drop_last: bool = False,
        unsqueeze_label_tensor: bool = True,
    ):
        """Torch IterableDataset over this Dataset (``dataset.py:2835``
        analog) — each item is ``(features, label)`` (or just features with
        no ``label_column``), batched to ``batch_size``."""
        import torch
        from torch.utils.data import IterableDataset

        outer = self

        class _TorchIterable(IterableDataset):
            def __iter__(self):
                for batch in outer.iter_batches(
                    batch_size=batch_size,
                    batch_format="numpy",
                    prefetch_blocks=prefetch_blocks,
                    drop_last=drop_last,
                ):
                    if isinstance(batch, dict):
                        if label_column is not None:
                            label = torch.as_tensor(batch[label_column])
                            if unsqueeze_label_tensor and label.dim() == 1:
                                label = label.unsqueeze(1)
                            cols = feature_columns or [
                                c for c in batch if c != label_column
                            ]
                            if not cols:
                                raise ValueError(
                                    "to_torch: no feature columns left after "
                                    f"excluding label {label_column!r}"
                                )
                            # always (N, C) float32 — shape/dtype must not
                            # flip when the feature list grows past one
                            flat = [
                                torch.as_tensor(
                                    np.asarray(batch[c], np.float32)
                                ).reshape(len(label), -1)
                                for c in cols
                            ]
                            feats = torch.cat(flat, dim=1)
                            yield feats, label
                        else:
                            if feature_columns is not None:
                                batch = {c: batch[c] for c in feature_columns}
                            yield {k: torch.as_tensor(np.asarray(v))
                                   for k, v in batch.items()}
                    else:
                        if label_column is not None or feature_columns is not None:
                            raise ValueError(
                                "to_torch: label_column/feature_columns need "
                                "named columns, but this dataset yields plain "
                                "arrays (e.g. from_numpy)"
                            )
                        yield torch.as_tensor(np.asarray(batch))

        return _TorchIterable()

    def iter_torch_batches(
        self, *, batch_size: Optional[int] = None, prefetch_blocks: int = 1,
        drop_last: bool = False,
    ) -> Iterator[Any]:
        """Batches as torch tensors (``iter_torch_batches`` analog)."""
        import torch

        for batch in self.iter_batches(
            batch_size=batch_size or 256, batch_format="numpy",
            prefetch_blocks=prefetch_blocks, drop_last=drop_last,
        ):
            if isinstance(batch, dict):
                yield {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
            else:
                yield torch.as_tensor(np.asarray(batch))

    # -- pipeline ------------------------------------------------------
    def window(self, *, blocks_per_window: int = 1) -> "DatasetPipeline":
        from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline

        # one pass over the data; .repeat() is the API for more epochs
        return DatasetPipeline.from_dataset(self, blocks_per_window, repeat=1)

    def repeat(self, times: Optional[int] = None) -> "DatasetPipeline":
        from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline

        return DatasetPipeline.from_dataset(self, self.num_blocks() or 1, repeat=times)

    # -- io (one write task per block -> part files) -------------------
    def _write(self, datasource_cls, path: str, **kw) -> List[str]:
        import os

        os.makedirs(path, exist_ok=True)
        ds = datasource_cls([])

        def write_one(block: Block, index: int) -> str:
            return ds.write_block(block, path, index, **kw)

        task = ray_tpu_torch.remote(num_cpus=1)(write_one)
        return ray_tpu_torch.get([task.remote(r, i) for i, r in enumerate(self._blocks)])

    def write_csv(self, path: str) -> List[str]:
        from ray_tpu_torch.data.datasource import CSVDatasource

        return self._write(CSVDatasource, path)

    def write_json(self, path: str) -> List[str]:
        from ray_tpu_torch.data.datasource import JSONDatasource

        return self._write(JSONDatasource, path)

    def write_parquet(self, path: str) -> List[str]:
        from ray_tpu_torch.data.datasource import ParquetDatasource

        return self._write(ParquetDatasource, path)

    def write_numpy(self, path: str) -> List[str]:
        from ray_tpu_torch.data.datasource import NumpyDatasource

        return self._write(NumpyDatasource, path)

    def __repr__(self):
        n_stages = len(self._plan.stages)
        if self._plan._out is None and n_stages:
            return f"Dataset(num_stages={n_stages}, unexecuted)"
        return f"Dataset(num_blocks={self.num_blocks()}, num_rows={self.count()})"


def _group_block(block: Block, key) -> Dict[Any, List[Any]]:
    from ray_tpu_torch.data.shuffle import _key_fn

    kf = _key_fn(key)
    out: Dict[Any, List[Any]] = {}
    for r in BlockAccessor(block).iter_rows():
        out.setdefault(kf(r), []).append(r)
    return out


class GroupedData:
    """Minimal groupby: count/sum/mean over a key (reference
    ``grouped_dataset.py``); per-block grouping tasks + driver combine of
    the (small) per-key partials."""

    def __init__(self, ds: Dataset, key):
        self._ds = ds
        self._key = key

    def _partials(self, value_of: Callable[[List[Any]], Any]) -> Dict[Any, Any]:
        task = ray_tpu_torch.remote(num_cpus=1)(_group_block)
        merged: Dict[Any, List[Any]] = {}
        for part in ray_tpu_torch.get([task.remote(r, self._key) for r in self._ds._blocks]):
            for k, rows in part.items():
                merged.setdefault(k, []).append(value_of(rows))
        return merged

    def count(self) -> Dataset:
        merged = self._partials(len)
        rows = [{"key": k, "count": sum(v)} for k, v in sorted(merged.items())]
        return Dataset([ray_tpu_torch.put(rows)], [len(rows)])

    def sum(self, on: str) -> Dataset:
        merged = self._partials(lambda rows: sum(r[on] for r in rows))
        rows = [{"key": k, "sum": sum(v)} for k, v in sorted(merged.items())]
        return Dataset([ray_tpu_torch.put(rows)], [len(rows)])

    def mean(self, on: str) -> Dataset:
        task = ray_tpu_torch.remote(num_cpus=1)(_group_block)
        sums: Dict[Any, float] = {}
        counts: Dict[Any, int] = {}
        for part in ray_tpu_torch.get([task.remote(r, self._key) for r in self._ds._blocks]):
            for k, rows in part.items():
                sums[k] = sums.get(k, 0.0) + sum(r[on] for r in rows)
                counts[k] = counts.get(k, 0) + len(rows)
        rows = [{"key": k, "mean": sums[k] / counts[k]} for k in sorted(sums)]
        return Dataset([ray_tpu_torch.put(rows)], [len(rows)])
