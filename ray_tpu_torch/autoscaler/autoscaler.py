"""StandardAutoscaler: the demand-driven reconcile loop.

The port's copy of ``ray_tpu/autoscaler/autoscaler.py``, with ``"GPU"``
where the JAX package counts ``"TPU"``.  Analog of
``python/ray/autoscaler/_private/autoscaler.py:167`` +
``ResourceDemandScheduler`` (``resource_demand_scheduler.py:103``) +
``Monitor`` (``monitor.py:126``): each pass reads the head's pending
resource demand and per-node utilization, bin-packs unmet demand onto the
worker node type, launches up to ``max_workers`` nodes through the
provider, and terminates nodes idle past ``idle_timeout_s``.
"""

from __future__ import annotations

import logging
import threading
import time
from itertools import islice
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ray_tpu_torch._private import events as _events
from ray_tpu_torch.autoscaler.node_provider import NodeProvider

logger = logging.getLogger(__name__)


@dataclass
class AutoscalingConfig:
    min_workers: int = 0
    max_workers: int = 2
    idle_timeout_s: float = 30.0
    # resources of one worker node (the single node-type config)
    worker_node: Dict[str, float] = field(default_factory=lambda: {"num_cpus": 1})
    upscaling_speed: int = 2  # max launches per pass


def _fits(req: Dict[str, float], avail: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) + 1e-9 >= v for k, v in req.items())


class StandardAutoscaler:
    def __init__(self, head_node, provider: NodeProvider,
                 config: Optional[AutoscalingConfig] = None):
        self.head = head_node
        self.provider = provider
        self.config = config or AutoscalingConfig()
        self._idle_since: Dict[str, float] = {}

    # -- demand / utilization views ------------------------------------
    # per-tick demand sample bound: to_launch is clamped by
    # upscaling_speed each pass, so any backlog sample big enough to
    # saturate that clamp yields the identical launch decision — and the
    # tick stays O(cap) under head.lock instead of O(backlog) (the 1M
    # queued-task envelope would otherwise copy a dict per parked task
    # while dispatch waits on the lock)
    DEMAND_SAMPLE_CAP = 1024

    def pending_demand(self) -> List[Dict[str, float]]:
        """Resource requests with no node that can fit them now (the
        LoadMetrics pending-demand feed)."""
        head = self.head
        cap_n = self.DEMAND_SAMPLE_CAP
        demands: List[Dict[str, float]] = []
        with head.lock:
            avail = {nid: dict(ns.available) for nid, ns in head.nodes.items()
                     if ns.alive}
            for spec in islice(head.pending_tasks, cap_n):
                demands.append(dict(spec.get("resources", {})))
            # resource-starved backlog: the scheduler parks unplaceable
            # shapes in per-shape queues (node._starved) — exactly the
            # demand that should trigger scale-up, so it MUST feed load
            # metrics (a GPU task waiting for a card lives here within
            # one scheduler pass of submission).  Every shape gets one
            # representative OUTSIDE the cap (shape count is O(shapes) by
            # design) so a flood of one shape can't hide another's demand;
            # the rest of the budget then samples queue depth.
            starved = [q for q in getattr(head, "_starved", {}).values() if q]
            for q in starved:
                demands.append(dict(q[0].get("resources", {})))
            for q in starved:
                take = min(len(q) - 1, cap_n - len(demands))
                if take <= 0:
                    if len(demands) >= cap_n:
                        break
                    continue
                for spec in islice(q, 1, 1 + take):
                    demands.append(dict(spec.get("resources", {})))
            # tasks leased into a busy worker's pipeline are queued work
            # too (the reference reports lease BACKLOGS to load metrics —
            # resource_demand_scheduler feeds on them); without this, fast
            # worker dispatch hides all queued demand inside pipelines and
            # the autoscaler never sees a reason to scale
            for w in head.workers.values():
                if len(demands) >= cap_n:
                    break
                for spec in islice(w.pipeline, cap_n - len(demands)):
                    demands.append(dict(spec.get("resources", {})))
            for art in head.actors.values():
                if art.info.state == "PENDING_CREATION" and art.worker is None:
                    demands.append(dict(art.info.creation_spec.get("resources", {})))
        unmet = []
        for req in demands:
            placed = False
            for nid, a in avail.items():
                if _fits(req, a):
                    for k, v in req.items():
                        a[k] = a.get(k, 0.0) - v
                    placed = True
                    break
            if not placed:
                unmet.append(req)
        return unmet

    def _slice_members(self, provider_node_id: str) -> List[str]:
        """The cluster node ids behind one provider node (a slice's
        member hosts; ``[provider_node_id]`` for single-host providers).

        When the provider can't map its node to member hosts (a cloud
        API knows VMs, not our node ids), fall back to the HEAD's
        slice index — hosts join tagged with ``slice_id`` set to the
        provider node name (``--slice-id`` / RAY_TPU_TORCH_SLICE_ID in the
        startup script).  Without this, a multi-host slice's provider id
        has no head-side NodeState, every member check returns 'idle',
        and idle scale-down deletes a live slice out from under its gang."""
        members_fn = getattr(self.provider, "slice_members", None)
        if members_fn is not None:
            try:
                members = list(members_fn(provider_node_id))
                if members and members != [provider_node_id]:
                    return members
            except Exception:
                pass
        with self.head.lock:
            tagged = [ns.node_id for ns in self.head.nodes.values()
                      if ns.slice_id == provider_node_id]
        return tagged or [provider_node_id]

    def _node_is_idle(self, node_id: str) -> bool:
        """Idle means EVERY member host of the provider node is idle.

        A slice is one failure domain AND one lease unit: scale-down may
        terminate the whole slice or nothing — it must never shrink a
        slice below its gang size.  Reasoning per-host here (the old
        behavior) would have called a slice 'idle' whenever its id had no
        head-side NodeState (the slice id is not a host id!) and killed
        all N hosts under a running gang."""
        return all(self._member_is_idle(m) for m in self._slice_members(node_id))

    def _member_is_idle(self, member_id: str) -> bool:
        """A host that has not joined the head yet is launching, not idle:
        its idle clock starts only once it has registered, so a node whose
        agent takes longer to boot than ``idle_timeout_s`` is not reaped
        before it can take the demand it was launched for."""
        head = self.head
        with head.lock:
            ns = head.nodes.get(member_id)
            if ns is None:
                return False
            if not ns.alive:
                return True
            if ns.ready_queue:
                return False
            if any(abs(ns.available.get(k, 0.0) - v) > 1e-9
                   for k, v in ns.total.items()):
                return False
            return True

    # -- one reconcile pass --------------------------------------------
    def update(self) -> None:
        cfg = self.config
        nodes = self.provider.non_terminated_nodes()

        # scale up: unmet demand -> bin-pack onto new worker nodes
        unmet = self.pending_demand()
        to_launch = 0
        if unmet:
            # one provider node may be a whole slice: its capacity is
            # slice_hosts x one host's resources, or the bin-pack
            # over-launches slices by up to slice_hosts x
            hosts = max(1, int(cfg.worker_node.get("slice_hosts", 1)))
            node_res = {
                "CPU": float(cfg.worker_node.get("num_cpus", 1)) * hosts,
                "GPU": float(cfg.worker_node.get("num_gpus", 0)) * hosts,
            }
            cap: Dict[str, float] = {}
            for req in unmet:
                if not _fits(req, cap):
                    to_launch += 1
                    for k, v in node_res.items():
                        cap[k] = cap.get(k, 0.0) + v
                for k, v in req.items():
                    cap[k] = cap.get(k, 0.0) - v
        want = max(cfg.min_workers - len(nodes), 0)
        to_launch = max(to_launch, want)
        to_launch = min(to_launch, cfg.upscaling_speed,
                        cfg.max_workers - len(nodes))
        if to_launch > 0:
            logger.info("autoscaler: launching %d worker node(s) for %d unmet "
                        "demands", to_launch, len(unmet))
            created = self.provider.create_node(dict(cfg.worker_node), to_launch)
            _events.emit("autoscaler", "scale up: launched nodes",
                         count=to_launch, nodes=list(created or ()),
                         unmet_demands=len(unmet), reason="pending_demand")

        # scale down: nodes idle past the timeout (never below min_workers).
        # A multi-host slice terminates as ONE unit — and is marked
        # draining at the head first so its member deaths read as a
        # deliberate scale-down, not a degraded slice.
        now = time.time()
        removable = len(nodes) - cfg.min_workers
        for nid in nodes:
            if not self._node_is_idle(nid):
                self._idle_since.pop(nid, None)
                continue
            first = self._idle_since.setdefault(nid, now)
            if removable > 0 and now - first >= cfg.idle_timeout_s:
                logger.info("autoscaler: terminating idle node %s", nid)
                members = self._slice_members(nid)
                if len(members) > 1 and hasattr(self.head, "mark_slice_draining"):
                    self.head.mark_slice_draining(nid)
                self.provider.terminate_node(nid)
                _events.emit("autoscaler", "scale down: terminated idle node",
                             entity_id=nid, idle_s=round(now - first, 1),
                             member_hosts=len(members))
                self._idle_since.pop(nid, None)
                removable -= 1


class Monitor:
    """Background reconcile loop (``_private/monitor.py:126`` analog)."""

    def __init__(self, autoscaler: StandardAutoscaler, interval_s: float = 5.0):
        self.autoscaler = autoscaler
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Monitor":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autoscaler-monitor")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.autoscaler.update()
            except Exception:
                logger.exception("autoscaler pass failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
