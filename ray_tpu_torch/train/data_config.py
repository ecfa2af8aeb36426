"""DataConfig: how Trainer datasets become per-worker shards.

Analog of ``python/ray/train/_internal/data_config.py`` (``DataConfig``):
the trainer hands its datasets plus this config to the BackendExecutor,
which — knowing where each rank's actor actually landed — wires every
worker a shard of each dataset:

- datasets in ``datasets_to_split`` go through ``Dataset.streaming_split``:
  one shared streaming pipeline, block-level shard assignment, soft
  node-affinity locality hints so each rank's blocks materialize on ITS
  node, and a bounded in-flight block budget (backpressure).
- other Datasets are passed whole to every worker (the reference's
  un-split datasets, e.g. a small validation set each rank scans fully).
- plain sequences fall back to even slicing.

A single-worker run hands the dataset over WITH its lazy plan so the
worker's ``iter_batches`` streams read+transform — splitting would execute
the plan eagerly.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union


class DataConfig:
    def __init__(
        self,
        datasets_to_split: Union[str, List[str]] = "all",
        *,
        locality: bool = True,
        equal: bool = True,
        max_in_flight_blocks: Optional[int] = None,
    ):
        if datasets_to_split != "all" and not isinstance(datasets_to_split, list):
            raise TypeError(
                "datasets_to_split should be 'all' or a list of dataset "
                f"names, got {datasets_to_split!r}")
        self._to_split = datasets_to_split
        self.locality = locality
        self.equal = equal
        self.max_in_flight_blocks = max_in_flight_blocks

    def _should_split(self, name: str) -> bool:
        return self._to_split == "all" or name in self._to_split

    def configure(
        self,
        datasets: Dict[str, Any],
        world_size: int,
        worker_node_ids: Optional[List[str]] = None,
    ) -> List[Dict[str, Any]]:
        """Per-worker shard dicts for ``datasets`` (one dict per rank).

        ``worker_node_ids[i]`` is rank i's node — the streaming split's
        locality hint, so rank i's blocks are produced on rank i's node.
        """
        shards: List[Dict[str, Any]] = [dict() for _ in range(world_size)]
        hints: Optional[List[Optional[str]]] = None
        if self.locality and worker_node_ids is not None \
                and len(worker_node_ids) == world_size:
            hints = list(worker_node_ids)
        for name, ds in datasets.items():
            if world_size == 1 and hasattr(ds, "iter_batches"):
                # single worker: hand over the dataset WITH its lazy plan —
                # splitting would execute it eagerly and the worker's
                # iter_batches could no longer stream read+transform
                parts = [ds]
            elif hasattr(ds, "streaming_split") and self._should_split(name):
                parts = ds.streaming_split(
                    world_size, equal=self.equal, locality_hints=hints,
                    max_in_flight_blocks=self.max_in_flight_blocks)
            elif hasattr(ds, "iter_batches"):
                # un-split dataset: every rank sees the whole thing
                parts = [ds] * world_size
            elif hasattr(ds, "split"):
                parts = ds.split(world_size)
            else:  # plain sequence: even slices
                per = len(ds) // world_size
                parts = [ds[i * per:(i + 1) * per] for i in range(world_size)]
            for i in range(world_size):
                shards[i][name] = parts[i]
        return shards
