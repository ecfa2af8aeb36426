"""NodeProvider interface (``python/ray/autoscaler/node_provider.py:13``;
the port's copy of ``ray_tpu/autoscaler/node_provider.py``).

A provider owns the lifecycle of worker nodes for one cluster: create,
terminate, enumerate.  Providers are dumb — all scaling *decisions* live
in :class:`~ray_tpu_torch.autoscaler.autoscaler.StandardAutoscaler`.

Slice semantics: a provider node MAY be a whole slice of hosts (one create
call = N hosts that live and die together).  ``slice_members`` exposes
the member host ids and ``replace_slice`` swaps a degraded slice
atomically — the replacement is created BEFORE the old slice is
terminated, so fleet capacity never dips below N−1 healthy slices, and a
failed creation leaves the old slice untouched.
"""

from __future__ import annotations

from typing import Dict, List, Optional


class NodeProvider:
    def __init__(self, provider_config: Optional[dict] = None,
                 cluster_name: str = "default"):
        self.provider_config = provider_config or {}
        self.cluster_name = cluster_name

    def non_terminated_nodes(self) -> List[str]:
        """IDs of nodes that are launching or running."""
        raise NotImplementedError

    def is_running(self, node_id: str) -> bool:
        raise NotImplementedError

    def create_node(self, node_config: Dict, count: int = 1) -> List[str]:
        """Launch ``count`` nodes; returns their ids (async startup).

        Must be all-or-nothing per node: a partial provision (some hosts
        of a slice up, the rest failed) is rolled back and raised — a
        half slice can never serve a gang and would leak otherwise."""
        raise NotImplementedError

    def terminate_node(self, node_id: str) -> None:
        raise NotImplementedError

    def slice_members(self, node_id: str) -> List[str]:
        """Cluster-level node ids of the hosts behind one provider node.
        Single-host providers return ``[node_id]``; slice providers
        return every member host (what the autoscaler's idle reasoning
        and slice repair iterate over)."""
        return [node_id]

    def replace_slice(self, node_id: str,
                      node_config: Optional[Dict] = None) -> str:
        """Atomically swap one (degraded) slice for a fresh one.

        Ordering is the contract: the replacement is provisioned FIRST —
        only once it exists is the old slice terminated.  If creation
        fails (quota, partial provision), the old slice is left exactly
        as it was and the error propagates; there is no state in which
        the fleet holds fewer slices than it started with."""
        created = self.create_node(dict(node_config or {}), 1)
        if not created:
            raise RuntimeError(
                f"replace_slice: provider created no replacement for {node_id}")
        self.terminate_node(node_id)
        return created[0]

    def shutdown(self) -> None:
        for nid in list(self.non_terminated_nodes()):
            self.terminate_node(nid)
