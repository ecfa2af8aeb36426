"""Placement groups (analog of ``python/ray/util/placement_group.py``).

``placement_group()`` (reference ``placement_group.py:128``) reserves gangs
of resource bundles; strategies STRICT_PACK/PACK/SPREAD/STRICT_SPREAD map to
the head's bundle policies.  STRICT_PACK is the gang lease: all bundles on
one node, or — when no single node holds them — all within ONE slice
(hosts sharing a ``slice_id`` failure domain), leased atomically with a
deterministic rank→host mapping.  A bundle may hold ``"GPU"``: an actor
placed in it gets that many of the node's cards as its
``CUDA_VISIBLE_DEVICES`` (the Train gang's bundles do).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch._private.object_ref import ObjectRef, new_id
from ray_tpu_torch._private.worker import global_worker

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: bytes, bundles: List[Dict[str, float]], ready_ref: ObjectRef):
        self.id = pg_id
        self._bundles = bundles
        self._ready_ref = ready_ref

    def ready(self) -> ObjectRef:
        """ObjectRef sealed once all bundles are reserved."""
        return self._ready_ref

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return list(self._bundles)

    @property
    def bundle_count(self) -> int:
        return len(self._bundles)

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        import ray_tpu_torch

        try:
            ray_tpu_torch.get(self._ready_ref, timeout=timeout_seconds)
            return True
        except Exception:
            return False

    def __reduce__(self):
        return (PlacementGroup, (self.id, self._bundles, self._ready_ref))


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: Optional[str] = None,
    lifetime: Optional[str] = None,
) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"Invalid strategy {strategy!r}; must be one of {VALID_STRATEGIES}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty dicts")
    w = global_worker
    if not w.connected:
        import ray_tpu_torch

        ray_tpu_torch.init()
    pg_id = new_id()
    ready_oid = new_id()
    w.client.create_pg({
        "pg_id": pg_id,
        "bundles": [dict(b) for b in bundles],
        "strategy": strategy,
        "name": name,
        "ready_oid": ready_oid,
    })
    return PlacementGroup(pg_id, bundles, ObjectRef(ready_oid))


def remove_placement_group(pg: PlacementGroup) -> None:
    global_worker.client.remove_pg(pg.id)


def placement_group_table() -> dict:
    snap = global_worker.client.state_snapshot()
    return {
        pg.pg_id.hex(): {
            "state": pg.state,
            "strategy": pg.strategy,
            "bundles": pg.bundles,
            "bundle_nodes": pg.bundle_nodes,
        }
        for pg in snap["placement_groups"]
    }
