"""Experimental APIs (reference ``python/ray/experimental``)."""

from __future__ import annotations

from typing import Dict


def broadcast_object(ref, timeout: float = 120.0) -> Dict:
    """Proactively replicate ``ref``'s payload onto every alive cluster
    node (the PushManager 1->N distribution,
    ``src/ray/object_manager/push_manager.h:29``, as a user-facing
    primitive).  Doubling fan-out: completed copies serve later waves.

    Returns ``{"replicas": n, "error": ...}``.  Subsequent consumers pull
    from the nearest/least-loaded copy via the head's location set, and the
    object survives the origin node's death without lineage reconstruction.
    """
    from ray_tpu_torch._private.object_ref import ObjectRef
    from ray_tpu_torch._private.worker import global_worker

    if not isinstance(ref, ObjectRef):
        raise TypeError(f"broadcast_object expects an ObjectRef, got {type(ref)}")
    return global_worker.client.broadcast(ref.binary(), timeout=timeout)
