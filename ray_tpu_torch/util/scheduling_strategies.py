"""Scheduling strategies (analog of ``python/ray/util/scheduling_strategies.py``)."""

from __future__ import annotations

from typing import Optional


class PlacementGroupSchedulingStrategy:
    """Schedule onto a reserved placement-group bundle
    (reference ``util/scheduling_strategies.py:15``)."""

    def __init__(
        self,
        placement_group,
        placement_group_bundle_index: int = -1,
        placement_group_capture_child_tasks: bool = False,
    ):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = placement_group_capture_child_tasks


class NodeAffinitySchedulingStrategy:
    """Pin to a node (reference ``util/scheduling_strategies.py:41``)."""

    def __init__(self, node_id: str, soft: bool = False):
        self.node_id = node_id
        self.soft = soft
