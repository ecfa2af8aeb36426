"""Offline IO: write rollouts to JSON-lines files, read them back.

Counterpart of ``ray_tpu/rllib/offline.py`` (the reference's
``rllib/offline/json_writer.py`` and ``json_reader.py:199``): each line is
one SampleBatch with columns encoded as nested lists + dtype tags
(human-greppable, like the reference; numpy round-trips exactly for
float32/int64/bool).  The files are the JAX package's, name for name and
line for line, so either package reads what the other wrote; a tensor
column is written from a host copy, never as a tensor.  ``config.output``
plugs the writer into every RolloutWorker; a reader feeds replay-based
algorithms for offline training (``config.input``).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Iterator, List, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.sample_batch import SampleBatch


def _encode(batch: SampleBatch) -> str:
    payload = {}
    for k, v in batch.items():
        arr = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        payload[k] = {"data": arr.tolist(), "dtype": str(arr.dtype)}
    return json.dumps(payload)


def _decode(line: str) -> SampleBatch:
    payload = json.loads(line)
    return SampleBatch({
        k: np.asarray(spec["data"], dtype=np.dtype(spec["dtype"]))
        for k, spec in payload.items()
    })


class JsonWriter:
    """One ``output-worker_<i>-<n>.json`` file per worker, rolled at
    ``max_file_size`` bytes (``json_writer.py`` analog)."""

    def __init__(self, path: str, *, worker_index: int = 0,
                 max_file_size: int = 64 * 1024 * 1024):
        self._dir = path
        os.makedirs(path, exist_ok=True)
        self._worker = worker_index
        self._max_bytes = max_file_size
        # resume after existing files from a prior run of this worker so
        # the roll threshold accounts for bytes already on disk
        existing = sorted(
            glob.glob(os.path.join(path, f"output-worker_{worker_index}-*.json")),
            key=lambda p: int(p.rsplit("-", 1)[1].removesuffix(".json")),
        )
        if existing:
            last = existing[-1]
            self._file_idx = int(last.rsplit("-", 1)[1].removesuffix(".json"))
            self._bytes = os.path.getsize(last)
        else:
            self._file_idx = 0
            self._bytes = 0

    def _path(self) -> str:
        return os.path.join(
            self._dir, f"output-worker_{self._worker}-{self._file_idx}.json"
        )

    def write(self, batch: SampleBatch) -> None:
        line = _encode(batch)
        if self._bytes and self._bytes + len(line) > self._max_bytes:
            self._file_idx += 1
            self._bytes = 0
        with open(self._path(), "a") as f:
            f.write(line + "\n")
        self._bytes += len(line) + 1


class JsonReader:
    """Cycles through every ``*.json`` under a path, yielding SampleBatches
    (``json_reader.py:199`` analog — loops forever like the reference, so
    offline training can draw unlimited batches)."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            self._files: List[str] = sorted(glob.glob(os.path.join(path, "*.json")))
        else:
            self._files = sorted(glob.glob(path))
        if not self._files:
            raise FileNotFoundError(f"no .json batch files under {path!r}")
        self._iter: Optional[Iterator[SampleBatch]] = None

    def _lines(self) -> Iterator[SampleBatch]:
        while True:  # cycle
            yielded = 0
            for fp in self._files:
                with open(fp) as f:
                    for line in f:
                        line = line.strip()
                        if line:
                            yielded += 1
                            yield _decode(line)
            if yielded == 0:
                raise RuntimeError(
                    f"offline input files contain no batches: {self._files}"
                )

    def next(self) -> SampleBatch:
        if self._iter is None:
            self._iter = self._lines()
        return next(self._iter)

    def read_all(self) -> SampleBatch:
        """Every batch in the files, concatenated once (no cycling)."""
        out = []
        for fp in self._files:
            with open(fp) as f:
                for line in f:
                    if line.strip():
                        out.append(_decode(line))
        return SampleBatch.concat_samples(out)
