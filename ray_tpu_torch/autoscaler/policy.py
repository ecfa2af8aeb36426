"""Trend-driven autoscaling: scale on slopes, not on incidents (the
port's copy of ``ray_tpu/autoscaler/policy.py``).

``StandardAutoscaler`` reacts to *unmet demand* — work that already can't
be placed.  This module reads the head's metrics TSDB and acts on
*trends* so capacity arrives BEFORE the cluster degrades into something
``ray_tpu_torch doctor`` would flag:

- a scheduler queue whose depth keeps climbing (sustained positive slope,
  growth past ``queue_ratio``) scales worker nodes up — thresholds sit
  deliberately BELOW doctor's ``queue_depth_climb`` trend rule (ratio 2.0
  + never-drained), so the scale-up fires first and the incident never
  forms;
- a serve deployment whose router queue stays backed up scales replicas
  up ahead of doctor's ``router_saturation`` (which needs observed
  stalls);
- per-process RSS growing steadily scales nodes before doctor's
  ``rss_growth`` leak rule (64 MB floor) would fire, spreading the
  working set while the leak is found.

Every decision is emitted to the flight recorder (source ``autoscaler``)
with its evidence — ``ray_tpu_torch events --source autoscaler`` IS the audit
log of why the fleet changed size.

:class:`TrendAutoscaler` folds the policy into the reconcile loop and
adds **slice repair**: a slice with a dead member and no replacement in
flight is swapped atomically through ``provider.replace_slice``
(create-before-terminate), closing the loop doctor's ``slice_degraded``
rule watches.
"""

from __future__ import annotations

import logging
import time
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, List, Optional

from ray_tpu_torch._private import events as _events
from ray_tpu_torch.autoscaler.autoscaler import AutoscalingConfig, StandardAutoscaler
from ray_tpu_torch.util.doctor import _monotone_frac, _slope_per_min

logger = logging.getLogger(__name__)

# TSDB metrics the policy queries each pass
POLICY_METRICS = (
    "ray_tpu_sched_queue_depth",
    "ray_tpu_serve_router_queue_len",
    "ray_tpu_proc_rss_mb",
)


@dataclass
class TrendPolicyConfig:
    window_s: float = 300.0
    min_points: int = 6           # samples before any slope is trusted
    # queue trend → scale_up_nodes.  Doctor's queue_depth_climb needs the
    # queue to NEVER drain below 1 AND to double; the policy fires on
    # sustained growth alone — earlier by construction.
    queue_depth_min: float = 1.0
    queue_slope_per_min: float = 1.0
    queue_ratio: float = 1.5
    # router backlog → scale_up_replicas (doctor's router_saturation
    # needs a stall event; a standing queue is the precursor)
    router_queue_mean: float = 1.0
    # RSS trend → scale_up_nodes (doctor's rss_growth flags at 64 MB
    # growth; act at half that)
    rss_slope_mb_per_min: float = 5.0
    rss_growth_min_mb: float = 32.0
    rss_monotone_frac: float = 0.8
    cooldown_s: float = 60.0      # per action+entity
    max_step: int = 2             # nodes/replicas added per decision


@dataclass
class Decision:
    action: str                   # scale_up_nodes | scale_up_replicas
    reason: str                   # which trend fired
    amount: int = 1
    deployment: Optional[str] = None
    evidence: Dict = field(default_factory=dict)


class TrendPolicy:
    """Pure series→decisions function plus per-action cooldowns.

    ``series_map`` has the ``query_metric`` shape —
    ``{name: [{"tags": {...}, "points": [[ts, v], ...]}, ...]}`` — so the
    policy runs identically over a live TSDB and synthetic fixtures."""

    def __init__(self, cfg: Optional[TrendPolicyConfig] = None):
        self.cfg = cfg or TrendPolicyConfig()
        self._last_fired: Dict[str, float] = {}

    def _cooled(self, key: str, now: float) -> bool:
        last = self._last_fired.get(key, 0.0)
        if now - last < self.cfg.cooldown_s:
            return False
        self._last_fired[key] = now
        return True

    def decide(self, series_map: Dict[str, list],
               now: Optional[float] = None) -> List[Decision]:
        if now is None:
            now = time.time()
        out: List[Decision] = []
        d = self._queue_trend(series_map)
        if d is not None and self._cooled("nodes/queue", now):
            out.append(d)
        for d in self._router_trend(series_map):
            if self._cooled(f"replicas/{d.deployment}", now):
                out.append(d)
        d = self._rss_trend(series_map)
        if d is not None and self._cooled("nodes/rss", now):
            out.append(d)
        return out

    # -- trends --------------------------------------------------------
    def _queue_trend(self, series_map) -> Optional[Decision]:
        cfg = self.cfg
        for s in series_map.get("ray_tpu_sched_queue_depth", ()):
            pts = s.get("points") or []
            if len(pts) < cfg.min_points:
                continue
            slope = _slope_per_min(pts)
            first = max(pts[0][1], cfg.queue_depth_min)
            last = pts[-1][1]
            if (last >= cfg.queue_depth_min
                    and slope >= cfg.queue_slope_per_min
                    and last >= first * cfg.queue_ratio):
                return Decision(
                    "scale_up_nodes", "queue_depth_slope",
                    amount=min(cfg.max_step,
                               max(1, int(slope // cfg.queue_slope_per_min))),
                    evidence={"slope_per_min": round(slope, 2),
                              "start_depth": pts[0][1], "end_depth": last,
                              "tags": s.get("tags", {})})
        return None

    def _router_trend(self, series_map) -> List[Decision]:
        cfg = self.cfg
        out: List[Decision] = []
        for s in series_map.get("ray_tpu_serve_router_queue_len", ()):
            pts = s.get("points") or []
            if len(pts) < cfg.min_points:
                continue
            mean = sum(p[1] for p in pts) / len(pts)
            if mean >= cfg.router_queue_mean and _slope_per_min(pts) >= 0.0:
                dep = (s.get("tags") or {}).get("deployment", "?")
                out.append(Decision(
                    "scale_up_replicas", "router_backlog",
                    amount=min(cfg.max_step, max(1, int(mean))),
                    deployment=dep,
                    evidence={"mean_queue": round(mean, 2),
                              "window_points": len(pts)}))
        return out

    def _rss_trend(self, series_map) -> Optional[Decision]:
        cfg = self.cfg
        worst = None
        for s in series_map.get("ray_tpu_proc_rss_mb", ()):
            pts = s.get("points") or []
            if len(pts) < cfg.min_points:
                continue
            slope = _slope_per_min(pts)
            growth = pts[-1][1] - pts[0][1]
            if (slope >= cfg.rss_slope_mb_per_min
                    and growth >= cfg.rss_growth_min_mb
                    and _monotone_frac(pts) >= cfg.rss_monotone_frac):
                row = {"slope_mb_per_min": round(slope, 2),
                       "growth_mb": round(growth, 1),
                       "tags": s.get("tags", {})}
                if worst is None or slope > worst["slope_mb_per_min"]:
                    worst = row
        if worst is None:
            return None
        return Decision("scale_up_nodes", "rss_trend", amount=1,
                        evidence=worst)


def serve_replica_scaler(controller=None) -> Callable[[str, int], None]:
    """A ``replica_scaler`` bound to the serve controller's
    ``scale_deployment`` RPC — the glue that lets a TrendAutoscaler act
    on router-backlog slope (``scale_up_replicas`` decisions) by growing
    the deployment's replica goal.  Clamping to autoscaling bounds
    happens controller-side, so this scaler and the controller's own
    demand autoscaler can coexist without fighting."""
    import ray_tpu_torch

    def scale(deployment: str, delta: int) -> None:
        nonlocal controller
        if controller is None:
            from ray_tpu_torch.serve._private.controller import (
                CONTROLLER_NAME, SERVE_NAMESPACE)

            controller = ray_tpu_torch.get_actor(CONTROLLER_NAME,
                                           namespace=SERVE_NAMESPACE)
        ray_tpu_torch.get(
            controller.scale_deployment.remote(deployment, delta=delta),
            timeout=30)

    return scale


class TrendAutoscaler(StandardAutoscaler):
    """StandardAutoscaler + TSDB-trend decisions + slice repair.

    ``replica_scaler(deployment, delta)`` applies serve scale-ups; when
    None, replica decisions are still emitted (audit trail) but only
    logged — the serve controller's own autoscaler may also be active.
    """

    def __init__(self, head_node, provider,
                 config: Optional[AutoscalingConfig] = None,
                 policy: Optional[TrendPolicy] = None,
                 replica_scaler: Optional[Callable[[str, int], None]] = None):
        super().__init__(head_node, provider, config)
        self.policy = policy or TrendPolicy()
        self.replica_scaler = replica_scaler

    # -- TSDB plumbing -------------------------------------------------
    def query_series(self) -> Dict[str, list]:
        tsdb = getattr(self.head, "tsdb", None)
        if tsdb is None:
            return {}
        out: Dict[str, list] = {}
        for name in POLICY_METRICS:
            try:
                out[name] = tsdb.query(
                    name, window_s=self.policy.cfg.window_s).get("series", [])
            except (ValueError, KeyError):
                out[name] = []
        return out

    # -- reconcile -----------------------------------------------------
    def update(self) -> None:
        self.repair_slices()
        try:
            decisions = self.policy.decide(self.query_series())
        except Exception:
            logger.exception("trend policy pass failed")
            decisions = []
        for d in decisions:
            self.apply(d)
        super().update()

    def apply(self, decision: Decision) -> None:
        d = asdict(decision)
        _events.emit("autoscaler", f"scale decision: {decision.action}",
                     severity="WARNING", entity_id=decision.deployment,
                     **d)
        logger.info("autoscaler trend decision: %s", d)
        if decision.action == "scale_up_nodes":
            cfg = self.config
            room = cfg.max_workers - len(self.provider.non_terminated_nodes())
            n = min(decision.amount, max(room, 0))
            if n > 0:
                self.provider.create_node(dict(cfg.worker_node), n)
        elif decision.action == "scale_up_replicas":
            if self.replica_scaler is not None and decision.deployment:
                try:
                    self.replica_scaler(decision.deployment, decision.amount)
                except Exception:
                    logger.exception("replica scale-up failed")

    # -- slice repair ----------------------------------------------------
    def repair_slices(self) -> List[tuple]:
        """Replace every slice with a dead member, atomically.

        A slice is one failure domain: one dead host wedges any gang on
        it, and per-host replacement cannot restore the lease (the
        paper's slice-atomic claim).  Ordering per slice: emit
        'slice replacement started' (doctor's in-flight marker), mark the
        old slice draining at the head (its surviving members' deaths are
        deliberate), create-then-terminate through
        ``provider.replace_slice``, emit 'slice replaced'.  A failed
        creation emits 'slice replacement failed' and leaves the old
        slice as it was (doctor re-opens the degraded finding).  Runs
        serially from the Monitor thread; replace_slice is synchronous,
        so one pass never sees its own replacement target again."""
        members_of = getattr(self.provider, "slice_members", None)
        if members_of is None:
            return []
        replaced: List[tuple] = []
        for sid in list(self.provider.non_terminated_nodes()):
            try:
                members = list(members_of(sid))
            except Exception:
                continue
            if len(members) <= 1:
                continue
            with self.head.lock:
                states = {m: self.head.nodes.get(m) for m in members}
            dead = [m for m, ns in states.items()
                    if ns is not None and not ns.alive]
            if not dead:
                continue
            _events.emit(
                "autoscaler", "slice replacement started",
                severity="WARNING", entity_id=sid, dead_members=dead,
                gang_size=len(members))
            if hasattr(self.head, "mark_slice_draining"):
                self.head.mark_slice_draining(sid)
            cfg = dict(self.config.worker_node)
            cfg.setdefault("slice_hosts", len(members))
            try:
                new_sid = self.provider.replace_slice(sid, cfg)
            except Exception as e:  # noqa: BLE001 — surfaced as event
                if hasattr(self.head, "mark_slice_draining"):
                    # the old slice lives on; future member deaths are
                    # real degradations again
                    self.head.mark_slice_draining(sid, draining=False)
                _events.emit(
                    "autoscaler", "slice replacement failed",
                    severity="ERROR", entity_id=sid,
                    error=f"{type(e).__name__}: {e}"[:200])
                continue
            _events.emit(
                "autoscaler", "slice replaced", severity="WARNING",
                entity_id=sid, replacement=new_sid,
                gang_size=len(members))
            replaced.append((sid, new_sid))
        return replaced
