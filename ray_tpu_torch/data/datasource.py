"""Datasource framework: pluggable parallel readers/writers.

Analog of ``python/ray/data/datasource/`` (``Datasource.prepare_read`` ->
``ReadTask`` list, ``read_datasource`` at ``read_api.py:233``): a
datasource splits itself into independent read tasks; each runs as a
remote task producing one block, so reads parallelize across the cluster
and compose with the lazy plan.  Writes mirror it: one write task per
block producing part files.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import numpy as np

from ray_tpu_torch.data.block import Block

# A ReadTask is a zero-arg callable returning one block, plus optional
# row-count metadata known up front.


@dataclass
class ReadTask:
    read_fn: Callable[[], Block]
    num_rows: Optional[int] = None

    def __call__(self) -> Block:
        return self.read_fn()


class Datasource:
    """Subclass and implement ``prepare_read``; optionally ``write_block``."""

    def prepare_read(self, parallelism: int, **read_args) -> List[ReadTask]:
        raise NotImplementedError

    def write_block(self, block: Block, path: str, index: int, **write_args) -> str:
        raise NotImplementedError(f"{type(self).__name__} does not support writes")


class RangeDatasource(Datasource):
    """ds.range / range_tensor backing (reference range_datasource.py)."""

    def __init__(self, n: int, tensor_shape: Optional[tuple] = None):
        self.n = n
        self.tensor_shape = tensor_shape

    def prepare_read(self, parallelism: int, **_) -> List[ReadTask]:
        n = self.n
        parallelism = max(1, min(parallelism, n or 1))
        per = math.ceil(n / parallelism) if n else 0
        tasks = []
        for i in range(parallelism):
            lo, hi = i * per, min((i + 1) * per, n)
            if lo >= hi:
                continue
            shape = self.tensor_shape

            def read(lo=lo, hi=hi, shape=shape) -> Block:
                if shape is None:
                    return {"value": np.arange(lo, hi)}
                data = np.arange(lo, hi).reshape(-1, *([1] * len(shape))) * np.ones(shape)
                return {"data": data}

            tasks.append(ReadTask(read, num_rows=hi - lo))
        return tasks or [ReadTask(lambda: {"value": np.asarray([])}, num_rows=0)]


def _expand_paths(paths: Union[str, List[str]], suffix: Optional[str] = None) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for name in sorted(os.listdir(p)):
                if suffix is None or name.endswith(suffix):
                    out.append(os.path.join(p, name))
        else:
            out.append(p)
    return out


class FileBasedDatasource(Datasource):
    """One read task per file (the reference's FileBasedDatasource)."""

    suffix: Optional[str] = None

    def __init__(self, paths: Union[str, List[str]], **read_args):
        self.paths = _expand_paths(paths, self.suffix)
        self.read_args = read_args

    def read_file(self, path: str, **read_args) -> Block:
        raise NotImplementedError

    def prepare_read(self, parallelism: int, **_) -> List[ReadTask]:
        return [
            ReadTask(lambda p=p: self.read_file(p, **self.read_args))
            for p in self.paths
        ]


class CSVDatasource(FileBasedDatasource):
    suffix = ".csv"

    def read_file(self, path: str, **kw) -> Block:
        import pandas as pd

        df = pd.read_csv(path, **kw)
        return {c: df[c].to_numpy() for c in df.columns}

    def write_block(self, block: Block, path: str, index: int, **kw) -> str:
        import pandas as pd

        from ray_tpu_torch.data.block import BlockAccessor

        out = os.path.join(path, f"part-{index:05d}.csv")
        pd.DataFrame(BlockAccessor(block).to_batch()).to_csv(out, index=False, **kw)
        return out


class JSONDatasource(FileBasedDatasource):
    suffix = ".json"

    def read_file(self, path: str, **kw) -> Block:
        import pandas as pd

        df = pd.read_json(path, orient="records", lines=True, **kw)
        return {c: df[c].to_numpy() for c in df.columns}

    def write_block(self, block: Block, path: str, index: int, **kw) -> str:
        import pandas as pd

        from ray_tpu_torch.data.block import BlockAccessor

        out = os.path.join(path, f"part-{index:05d}.json")
        pd.DataFrame(BlockAccessor(block).to_batch()).to_json(
            out, orient="records", lines=True, **kw)
        return out


class ParquetDatasource(FileBasedDatasource):
    suffix = ".parquet"

    def read_file(self, path: str, **kw) -> Block:
        try:
            import pyarrow.parquet as pq

            # native Arrow blocks: zero-copy into the store (pickle-5
            # out-of-band buffers), zero-copy slicing downstream
            return pq.read_table(path, **kw)
        except ImportError:
            import pandas as pd

            df = pd.read_parquet(path, **kw)
            return {c: df[c].to_numpy() for c in df.columns}

    def write_block(self, block: Block, path: str, index: int, **kw) -> str:
        from ray_tpu_torch.data.block import BlockAccessor

        out = os.path.join(path, f"part-{index:05d}.parquet")
        try:
            import pyarrow.parquet as pq

            pq.write_table(BlockAccessor(block).to_arrow(), out, **kw)
        except ImportError:
            import pandas as pd

            pd.DataFrame(BlockAccessor(block).to_batch()).to_parquet(out, **kw)
        return out


class NumpyDatasource(FileBasedDatasource):
    suffix = ".npy"

    def read_file(self, path: str, **kw) -> Block:
        return {"value": np.load(path, **kw)}

    def write_block(self, block: Block, path: str, index: int, **kw) -> str:
        from ray_tpu_torch.data.block import BlockAccessor

        out = os.path.join(path, f"part-{index:05d}.npy")
        batch = BlockAccessor(block).to_batch()
        col = batch.get("value", next(iter(batch.values())) if batch else np.asarray([]))
        np.save(out, col)
        return out


class TextDatasource(FileBasedDatasource):
    def read_file(self, path: str, **kw) -> Block:
        with open(path) as f:
            return [line.rstrip("\n") for line in f]


class BinaryDatasource(FileBasedDatasource):
    def read_file(self, path: str, **kw) -> Block:
        with open(path, "rb") as f:
            return [{"path": path, "bytes": f.read()}]
