"""Head dispatch shards: N independent lock domains for the hot paths.

The reference head dispatches from a C++ ``ClusterTaskManager`` built for
1M+ queued tasks and 10k+ actors
(``src/ray/raylet/scheduling/cluster_task_manager.h:41``); our fused
Python head serialized every dispatch on one registry RLock.  This module
splits the *dispatch key space* into shards:

- **actor tasks** shard by actor id: an actor's method queue, in-flight
  window, and concurrency-group windows live entirely inside its shard,
  so submissions and completions for different actors (different tenant
  connections, different reader threads) proceed in parallel and never
  touch the head lock on the hot path.
- **plain leased tasks** shard by target node: a node's runnable (ready)
  queue belongs to its shard; resource accounting stays under the head
  lock, the queue structure itself under the shard lock.

Lock ordering is fixed and witness-verified: the head ``node.registry``
lock always precedes any shard lock, and no thread ever holds two shard
locks at once.  Cross-shard operations — gang scheduling, slice repair,
actor death sweeps, cancel scans — take the head lock first and then
each shard lock one at a time, so the lockwitness graph stays acyclic;
``RAY_TPU_TORCH_LOCKWITNESS=1`` proves it live (the locks come from
``locks.make_lock`` like every other head lock).

Shard count: ``RAY_TPU_TORCH_HEAD_SHARDS`` (default 4; 1 restores the fused
behavior — useful for bisecting shard-sensitive bugs).
"""

from __future__ import annotations

import os
from typing import List

from ray_tpu_torch._private.locks import make_lock

DEFAULT_SHARDS = 4


def shard_count() -> int:
    try:
        n = int(os.environ.get("RAY_TPU_TORCH_HEAD_SHARDS", DEFAULT_SHARDS))
    except ValueError:
        n = DEFAULT_SHARDS
    return max(1, min(n, 64))


class Shard:
    """One dispatch lock domain."""

    __slots__ = ("index", "lock")

    def __init__(self, index: int):
        self.index = index
        # named per shard so the lockwitness order graph distinguishes
        # them (an ABBA between two shards must be visible as a cycle)
        self.lock = make_lock(f"node.shard{index}")


class ShardSet:
    """The head's shard table with stable key -> shard assignment."""

    def __init__(self, n: int = 0):
        self.n = n or shard_count()
        self.shards: List[Shard] = [Shard(i) for i in range(self.n)]

    def for_actor(self, actor_id: bytes) -> Shard:
        """An actor's home shard — stable for the actor's lifetime, so
        its FIFO queue and concurrency windows never migrate.  Keyed on
        the TAIL of the id: ids are a per-process random prefix + a
        counter (object_ref.new_id), so the head bytes are identical for
        every actor one driver creates — sharding on them would pile a
        whole tenant onto one shard."""
        # big-endian: the id's final byte (the counter's low byte, the
        # fastest-changing bit of entropy) must land in the LSB so
        # consecutive actors round-robin shards instead of aliasing
        return self.shards[int.from_bytes(actor_id[-4:], "big") % self.n]

    def for_node(self, node_id: str) -> Shard:
        """A node's home shard for its runnable queue.  Stable string
        hash (not ``hash()``: PYTHONHASHSEED must not move queues between
        head restarts that share persisted state)."""
        h = 0
        for ch in node_id:
            h = (h * 131 + ord(ch)) & 0xFFFFFFFF
        return self.shards[h % self.n]
