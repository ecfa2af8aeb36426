"""Dataset creation / read connectors (``python/ray/data/read_api.py``).

All file/range reads go through :func:`read_datasource`
(``read_api.py:233``): the datasource splits into ReadTasks, each runs as
one remote task producing one block.
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.dataset import Dataset
from ray_tpu_torch.data.datasource import (
    BinaryDatasource,
    CSVDatasource,
    Datasource,
    JSONDatasource,
    NumpyDatasource,
    ParquetDatasource,
    RangeDatasource,
    TextDatasource,
)

DEFAULT_BLOCKS = 4
# Size-aware splitting for in-memory arrays (the reference's
# target_max_block_size): blocks near this size keep the streaming
# pipeline's overlap granularity fine enough that the first batch is
# ready after ONE block's transform, not the whole dataset's.
TARGET_BLOCK_BYTES = 32 << 20
_MAX_AUTO_BLOCKS = 512


def read_datasource(datasource: Datasource, *, parallelism: int = DEFAULT_BLOCKS,
                    **read_args) -> Dataset:
    """One remote task per ReadTask; returns a lazy Dataset over the
    resulting blocks."""
    from ray_tpu_torch._private.usage import record_feature
    record_feature("data")
    tasks = datasource.prepare_read(parallelism, **read_args)
    runner = ray_tpu_torch.remote(num_cpus=1)(lambda t: t())
    refs = [runner.remote(t) for t in tasks]
    counts = [t.num_rows for t in tasks]
    return Dataset(refs, None if any(c is None for c in counts) else counts)


def _put_blocks(rows: List[Any], parallelism: int) -> Dataset:
    import builtins

    parallelism = max(1, min(parallelism, len(rows) or 1))
    per = math.ceil(len(rows) / parallelism)
    # builtins.range: this module exports a `range` Dataset constructor
    blocks = [rows[i * per:(i + 1) * per] for i in builtins.range(parallelism)]
    blocks = [b for b in blocks if b] or [[]]
    return Dataset([ray_tpu_torch.put(b) for b in blocks], [len(b) for b in blocks])


def from_items(items: Sequence[Any], *, parallelism: int = DEFAULT_BLOCKS) -> Dataset:
    return _put_blocks(list(items), parallelism)


def range(n: int, *, parallelism: int = DEFAULT_BLOCKS) -> Dataset:  # noqa: A001
    return read_datasource(RangeDatasource(n), parallelism=parallelism)


def range_tensor(n: int, *, shape: tuple = (1,), parallelism: int = DEFAULT_BLOCKS) -> Dataset:
    return read_datasource(RangeDatasource(n, tensor_shape=shape), parallelism=parallelism)


def from_numpy(arr: Union[np.ndarray, List[np.ndarray]], *,
               parallelism: Optional[int] = None) -> Dataset:
    if isinstance(arr, list):
        refs = [ray_tpu_torch.put({"value": a}) for a in arr]
        return Dataset(refs, [len(a) for a in arr])
    if parallelism is None:
        # size-aware default: ~TARGET_BLOCK_BYTES blocks (floor
        # DEFAULT_BLOCKS) so big arrays stream at fine granularity
        parallelism = max(DEFAULT_BLOCKS,
                          min(_MAX_AUTO_BLOCKS,
                              int(arr.nbytes // TARGET_BLOCK_BYTES)))
    chunks = np.array_split(arr, min(parallelism, max(1, len(arr))))
    refs = [ray_tpu_torch.put({"value": c}) for c in chunks if len(c)]
    return Dataset(refs, [len(c) for c in chunks if len(c)])


def from_block_generator(gen) -> Dataset:
    """Dataset over blocks streamed by a ``num_returns="dynamic"`` task:
    ``iter_batches`` consumes each block AS THE PRODUCER YIELDS IT —
    the full block list is never materialized (reference counterpart:
    streaming Data blocks over ObjectRefGenerator, ``worker.py:2924``)."""
    from ray_tpu_torch._private.object_ref import ObjectRefGenerator

    if not isinstance(gen, ObjectRefGenerator):
        raise TypeError(
            f"from_block_generator expects an ObjectRefGenerator "
            f"(a num_returns=\"dynamic\" task's handle), got {type(gen)}")
    return Dataset(gen)


def from_pandas(df) -> Dataset:
    block = {c: df[c].to_numpy() for c in df.columns}
    return Dataset([ray_tpu_torch.put(block)], [len(df)])


def from_arrow(tables) -> Dataset:
    """Dataset over Arrow table block(s) — zero-copy into the store
    (``from_arrow``, ``python/ray/data/read_api.py`` analog)."""
    import pyarrow as pa

    if isinstance(tables, pa.Table):
        tables = [tables]
    for t in tables:
        if not isinstance(t, pa.Table):
            raise TypeError(f"from_arrow expects pyarrow.Table(s), got {type(t)}")
    return Dataset([ray_tpu_torch.put(t) for t in tables],
                   [t.num_rows for t in tables])


def read_csv(paths: Union[str, List[str]], *, parallelism: int = DEFAULT_BLOCKS, **kw) -> Dataset:
    return read_datasource(CSVDatasource(paths, **kw), parallelism=parallelism)


def read_json(paths: Union[str, List[str]], *, parallelism: int = DEFAULT_BLOCKS, **kw) -> Dataset:
    return read_datasource(JSONDatasource(paths, **kw), parallelism=parallelism)


def read_parquet(paths: Union[str, List[str]], *, parallelism: int = DEFAULT_BLOCKS, **kw) -> Dataset:
    return read_datasource(ParquetDatasource(paths, **kw), parallelism=parallelism)


def read_numpy(paths: Union[str, List[str]], *, parallelism: int = DEFAULT_BLOCKS) -> Dataset:
    return read_datasource(NumpyDatasource(paths), parallelism=parallelism)


def read_text(paths: Union[str, List[str]], *, parallelism: int = DEFAULT_BLOCKS) -> Dataset:
    return read_datasource(TextDatasource(paths), parallelism=parallelism)


def read_binary_files(paths: Union[str, List[str]], *, parallelism: int = DEFAULT_BLOCKS) -> Dataset:
    return read_datasource(BinaryDatasource(paths), parallelism=parallelism)
