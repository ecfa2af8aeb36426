"""DatasetPipeline: windowed/repeating streaming over a Dataset.

Analog of ``python/ray/data/dataset_pipeline.py`` — *data* pipelining
(overlap ingest with consumption), the reference's tool for
bulk-ingest-while-training.
"""

from __future__ import annotations

import itertools
from typing import Callable, Iterator, Optional

from ray_tpu_torch.data.dataset import Dataset


class DatasetPipeline:
    def __init__(self, windows_fn: Callable[[], Iterator[Dataset]]):
        self._windows_fn = windows_fn
        self._transforms = []

    @classmethod
    def from_dataset(cls, ds: Dataset, blocks_per_window: int,
                     repeat: Optional[int] = None) -> "DatasetPipeline":
        def windows() -> Iterator[Dataset]:
            epochs = itertools.count() if repeat is None else range(repeat)
            for _ in epochs:
                for i in range(0, ds.num_blocks(), blocks_per_window):
                    yield Dataset(ds._blocks[i:i + blocks_per_window])

        return cls(windows)

    def map_batches(self, fn, **kw) -> "DatasetPipeline":
        pipe = DatasetPipeline(self._windows_fn)
        pipe._transforms = self._transforms + [lambda ds: ds.map_batches(fn, **kw)]
        return pipe

    def map(self, fn) -> "DatasetPipeline":
        pipe = DatasetPipeline(self._windows_fn)
        pipe._transforms = self._transforms + [lambda ds: ds.map(fn)]
        return pipe

    def iter_windows(self) -> Iterator[Dataset]:
        for ds in self._windows_fn():
            for t in self._transforms:
                ds = t(ds)
            yield ds

    def iter_batches(self, *, batch_size: int = 256, batch_format: str = "numpy"):
        for ds in self.iter_windows():
            yield from ds.iter_batches(batch_size=batch_size, batch_format=batch_format)

    def iter_rows(self):
        for ds in self.iter_windows():
            yield from ds.iter_rows()

    def take(self, limit: int = 20):
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= limit:
                break
        return out
