"""Distributed shuffle ops: map-side partition + reduce.

The reference's push-based shuffle
(``python/ray/data/_internal/push_based_shuffle.py``): every input block
is partitioned into N sub-blocks by a map task (``num_returns=N``), and N
reduce tasks each concatenate their partition from every map output.  The
driver only ever touches refs — no row materialization — so a shuffle of
1 GiB moves 1 GiB through the object store, not through the driver.

``sort`` uses sample-based range partitioning (the reference's
``sort.py`` sample stage): sample keys -> pick N-1 boundaries -> range
partition -> per-partition local sort.
"""

from __future__ import annotations

import random
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.plan import AllToAllStage


def _columnar(block: Block) -> Block:
    """Arrow blocks take the columnar fast paths as dict tables (a copy,
    but row-wise Python bucketing would be far worse); other layouts pass
    through untouched."""
    acc = BlockAccessor(block)
    return acc.to_batch() if acc.is_arrow else block


def _partition_random(block: Block, n: int, seed: Optional[int]):
    """Assign each row to a random partition (map side of the shuffle)."""
    block = _columnar(block)
    acc = BlockAccessor(block)
    rows = acc.num_rows()
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, n, rows)
    parts = []
    if acc.is_table:
        idx = np.arange(rows)
        for j in range(n):
            sel = idx[assign == j]
            parts.append({k: np.asarray(v)[sel] for k, v in block.items()})
    else:
        buckets: List[List[Any]] = [[] for _ in range(n)]
        for r, j in zip(acc.iter_rows(), assign):
            buckets[j].append(r)
        parts = buckets
    return tuple(parts) if n > 1 else parts[0]


def _reduce_concat(shuffle_seed: Optional[int], local_shuffle: bool, *parts: Block) -> Block:
    merged = BlockAccessor.concat(list(parts))
    if not local_shuffle:
        return merged
    acc = BlockAccessor(merged)
    rows = acc.num_rows()
    rng = np.random.default_rng(shuffle_seed)
    order = rng.permutation(rows)
    if acc.is_table:
        return {k: np.asarray(v)[order] for k, v in merged.items()}
    return [merged[i] for i in order]


def random_shuffle_stage(seed: Optional[int], num_blocks: Optional[int] = None) -> AllToAllStage:
    def run(refs: List[Any], counts):
        n = num_blocks or max(1, len(refs))
        mapper = ray_tpu_torch.remote(num_cpus=1, num_returns=n)(_partition_random)
        reducer = ray_tpu_torch.remote(num_cpus=1)(_reduce_concat)
        parts = []
        for i, r in enumerate(refs):
            out = mapper.remote(r, n, None if seed is None else seed + i)
            parts.append([out] if n == 1 else list(out))
        new_refs = [
            reducer.remote(None if seed is None else seed * 31 + j, True,
                           *[p[j] for p in parts])
            for j in range(n)
        ]
        return new_refs, None

    return AllToAllStage("random_shuffle", run)


def _slice_ranges(block: Block, bounds: List[int]):
    """Split a block at row indices (map side of repartition)."""
    acc = BlockAccessor(block)
    parts = [acc.slice(lo, hi) for lo, hi in zip([0] + bounds, bounds + [acc.num_rows()])]
    return tuple(parts) if len(parts) > 1 else parts[0]


def _count_rows(block: Block) -> int:
    return BlockAccessor(block).num_rows()


def compute_counts(refs: List[Any], counts: Optional[List[int]]) -> List[int]:
    """Per-block row counts, via tasks when not already known."""
    if counts is not None:
        return counts
    task = ray_tpu_torch.remote(num_cpus=1)(_count_rows)
    return ray_tpu_torch.get([task.remote(r) for r in refs])


def range_partition(refs: List[Any], counts: List[int],
                    g_bounds: List[int]) -> List[List[Any]]:
    """Slice blocks at global row boundaries.  Returns, for each of the
    ``len(g_bounds)+1`` output ranges, the list of sub-block refs from
    every input block (the map side shared by repartition/split/zip)."""
    n_parts = len(g_bounds) + 1
    mapper = ray_tpu_torch.remote(num_cpus=1, num_returns=n_parts)(_slice_ranges)
    per_block, offset = [], 0
    for r, c in zip(refs, counts):
        local = [int(min(max(b - offset, 0), c)) for b in g_bounds]
        out = mapper.remote(r, local)
        per_block.append(list(out) if n_parts > 1 else [out])
        offset += c
    return [[p[j] for p in per_block] for j in range(n_parts)]


def repartition_stage(num_blocks: int) -> AllToAllStage:
    """Even re-split without a full shuffle: each input block is sliced
    into ``num_blocks`` ranges proportionally; reducer j concatenates the
    j-th slice of every block."""

    def run(refs: List[Any], counts):
        n = num_blocks
        counts = compute_counts(refs, counts)
        total = sum(counts)
        per = [total // n + (1 if j < total % n else 0) for j in range(n)]
        g_bounds = list(np.cumsum(per)[:-1])
        parts = range_partition(refs, counts, g_bounds)
        reducer = ray_tpu_torch.remote(num_cpus=1)(_reduce_concat)
        new_refs = [reducer.remote(None, False, *parts[j]) for j in range(n)]
        return new_refs, per

    return AllToAllStage("repartition", run)


def _key_fn(key):
    if isinstance(key, str):
        return lambda r: r[key]
    if key is None:
        return lambda r: r
    return key


def _sample_keys(block: Block, key, k: int):
    acc = BlockAccessor(block)
    rows = acc.to_rows()
    if not rows:
        return []
    kf = _key_fn(key)
    sample = random.Random(0).sample(rows, min(k, len(rows)))
    return [kf(r) for r in sample]


def _partition_by_range(block: Block, key, boundaries: List[Any]):
    acc = BlockAccessor(block)
    kf = _key_fn(key)
    n = len(boundaries) + 1
    buckets: List[List[Any]] = [[] for _ in range(n)]
    import bisect

    for r in acc.iter_rows():
        buckets[bisect.bisect_right(boundaries, kf(r))].append(r)
    return tuple(buckets) if n > 1 else buckets[0]


def _sort_block(key, descending: bool, *parts: Block) -> Block:
    merged = BlockAccessor.concat(list(parts))
    rows = BlockAccessor(merged).to_rows()
    rows.sort(key=_key_fn(key), reverse=descending)
    if rows and isinstance(rows[0], dict):
        return BlockAccessor.from_batch(
            {k: np.asarray([r[k] for r in rows]) for k in rows[0]}
        )
    return rows


def sort_stage(key, descending: bool) -> AllToAllStage:
    """Sample-based range partition + per-partition sort (sort.py analog).
    Only a bounded key sample ever reaches the driver."""

    def run(refs: List[Any], counts):
        n = max(1, len(refs))
        sampler = ray_tpu_torch.remote(num_cpus=1)(_sample_keys)
        samples: List[Any] = []
        for s in ray_tpu_torch.get([sampler.remote(r, key, 32) for r in refs]):
            samples.extend(s)
        samples.sort()
        if samples and n > 1:
            step = max(1, len(samples) // n)
            boundaries = samples[step::step][: n - 1]
        else:
            boundaries = []
        n_out = len(boundaries) + 1
        mapper = ray_tpu_torch.remote(num_cpus=1, num_returns=n_out)(_partition_by_range)
        reducer = ray_tpu_torch.remote(num_cpus=1)(_sort_block)
        parts = []
        for r in refs:
            out = mapper.remote(r, key, boundaries)
            parts.append([out] if n_out == 1 else list(out))
        new_refs = [reducer.remote(key, descending, *[p[j] for p in parts])
                    for j in range(n_out)]
        if descending:
            new_refs.reverse()
        return new_refs, None

    return AllToAllStage("sort", run)
