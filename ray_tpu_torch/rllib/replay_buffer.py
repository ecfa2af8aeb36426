"""Uniform replay buffer for off-policy algorithms.

The port's own copy of ``ray_tpu/rllib/replay_buffer.py`` (numpy only): a
preallocated numpy ring over transition columns, O(1) add, vectorized
sample from a numpy ``Generator`` seeded as the JAX package seeds it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ray_tpu_torch.rllib.sample_batch import SampleBatch


class ReplayBuffer:
    def __init__(self, capacity: int = 50_000, seed: int = 0):
        self.capacity = capacity
        self._cols: Optional[Dict[str, np.ndarray]] = None
        self._idx = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add_batch(self, batch: SampleBatch) -> None:
        n = batch.count
        if n == 0:
            return
        if self._cols is None:
            self._cols = {
                k: np.zeros((self.capacity, *np.asarray(v).shape[1:]),
                            dtype=np.asarray(v).dtype)
                for k, v in batch.items()
            }
        for k, buf in self._cols.items():
            v = np.asarray(batch[k])
            take = min(n, self.capacity)
            v = v[-take:]  # a fragment larger than capacity keeps its tail
            end = self._idx + take
            if end <= self.capacity:
                buf[self._idx:end] = v
            else:
                split = self.capacity - self._idx
                buf[self._idx:] = v[:split]
                buf[:end - self.capacity] = v[split:]
        self._idx = (self._idx + min(n, self.capacity)) % self.capacity
        self._size = min(self._size + n, self.capacity)

    def sample(self, batch_size: int) -> SampleBatch:
        idx = self._rng.integers(0, self._size, batch_size)
        return SampleBatch({k: buf[idx] for k, buf in self._cols.items()})
