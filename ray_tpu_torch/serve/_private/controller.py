"""ServeController: the serve control plane, as a named actor.

Analog of ``python/ray/serve/controller.py:61`` (ServeController) plus the
``DeploymentState`` reconciler (``serve/_private/deployment_state.py:958``):
holds declarative deployment goal state, diffs it against live replica
actors, and converges — creating replicas, replacing dead ones (detected by
a background health loop pinging each replica), scaling up/down, and
propagating ``user_config`` via ``reconfigure``.  Routers and proxies get
routing tables via ``listen_for_change`` — a LongPollHost-style blocking
poll (``serve/_private/long_poll.py:185``) parked on the controller's
threaded executor — with a TTL pull as fallback.  Demand-driven replica
autoscaling (``_private/autoscaling_policy.py`` analog) sizes deployments
from router-reported ongoing-request counts.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import math

from ray_tpu_torch._private import events as _events
from ray_tpu_torch.serve.config import (
    MAX_CONSECUTIVE_START_FAILURES,
    DeploymentConfig,
    ReplicaState,
)

logger = logging.getLogger(__name__)

CONTROLLER_NAME = "SERVE_CONTROLLER"
HTTP_PROXY_NAME = "SERVE_HTTP_PROXY"
# Cluster-singleton serve infrastructure lives in a FIXED system
# namespace: named-actor lookups are namespace-scoped per tenant, and a
# controller registered in the deploying driver's namespace would be
# invisible to other tenants (and a second tenant's serve.start() would
# boot a second controller + proxy on the same port).
SERVE_NAMESPACE = "serve"
# graceful_shutdown waits at most this long for the replicas' drains (the
# caller, serve.shutdown(), waits 30 s for the reply)
SHUTDOWN_WAIT_S = 25.0


class _Replica:
    __slots__ = ("tag", "handle", "state")

    def __init__(self, tag: str, handle, state: str = ReplicaState.STARTING):
        self.tag = tag
        self.handle = handle
        self.state = state


class _DeploymentState:
    """Goal + actual state for one deployment (deployment_state.py:958)."""

    def __init__(self, name: str, goal: dict):
        self.name = name
        self.goal = goal  # serialized_def/init_args/init_kwargs/config/route_prefix
        self.replicas: List[_Replica] = []
        # replicas out of the routing set, finishing in-flight requests
        # before termination (visible as DRAINING in get_status)
        self.draining: List[_Replica] = []
        self.version = 1
        self.deleting = False
        self.consecutive_failures = 0  # replica deaths with no RUNNING between
        self.unhealthy_reason: Optional[str] = None
        self.last_probe = 0.0
        # autoscaling: per-router ongoing-request reports + decision smoothing
        self.handle_metrics: Dict[str, Tuple[float, float]] = {}  # router -> (count, ts)
        self.scale_direction = 0  # sign of the pending decision
        self.scale_pending_since = 0.0

    @property
    def config(self) -> DeploymentConfig:
        return self.goal["config"]


class ServeController:
    def __init__(self, http_config: Optional[dict] = None):
        self._deployments: Dict[str, _DeploymentState] = {}
        # deleted deployments whose replicas may still be draining
        self._retired: List[_DeploymentState] = []
        self._lock = threading.RLock()
        # LongPollHost analog: routers park in listen_for_change on this
        # condition; every version bump notifies it (requires the controller
        # actor to run with max_concurrency > #parked listeners)
        self._changed = threading.Condition(self._lock)
        self._stopped = threading.Event()
        self._http_config = http_config or {}
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True, name="serve-health"
        )
        self._health_thread.start()
        self._autoscale_thread = threading.Thread(
            target=self._autoscale_loop, daemon=True, name="serve-autoscale"
        )
        self._autoscale_thread.start()

    # ------------------------------------------------------------------
    # control-plane API (called by serve.api / proxies / handles)
    # ------------------------------------------------------------------
    def deploy(self, name: str, goal: dict) -> bool:
        """Set/replace a deployment's goal state and converge toward it
        (``controller.py`` deploy -> DeploymentState.deploy analog)."""
        goal["config"].validate()
        auto = goal["config"].autoscaling_config
        with self._lock:
            state = self._deployments.get(name)
            if auto is not None:
                # the autoscaler owns num_replicas: new deployments start at
                # the floor; a redeploy keeps the current autoscaled size
                # (clamped to the new bounds) so config tweaks don't collapse
                # live capacity
                prev = state.config if state is not None else None
                if prev is not None and prev.autoscaling_config is not None:
                    goal["config"].num_replicas = max(
                        auto.min_replicas,
                        min(auto.max_replicas, prev.num_replicas),
                    )
                else:
                    goal["config"].num_replicas = auto.min_replicas
            if state is None:
                self._deployments[name] = state = _DeploymentState(name, goal)
            else:
                old = state.goal
                code_changed = (
                    old["serialized_def"] != goal["serialized_def"]
                    or old["init_args"] != goal["init_args"]
                    or old["init_kwargs"] != goal["init_kwargs"]
                )
                user_config_changed = (
                    old["config"].user_config != goal["config"].user_config
                )
                state.goal = goal
                state.deleting = False
                state.consecutive_failures = 0
                state.unhealthy_reason = None
                if code_changed:
                    # new code/args: replace every replica (simplified rolling
                    # update — the reference also versions replicas)
                    for r in list(state.replicas):
                        self._stop_replica(state, r)
                elif user_config_changed:
                    for r in state.replicas:
                        try:
                            r.handle.reconfigure.remote(goal["config"].user_config)
                        except Exception:
                            pass
                self._bump(state)
            self._reconcile(state)
        return True

    def delete_deployment(self, name: str) -> bool:
        with self._lock:
            state = self._deployments.get(name)
            if state is None:
                return False
            state.deleting = True
            for r in list(state.replicas):
                self._stop_replica(state, r)
            del self._deployments[name]
            self._retired = [s for s in self._retired if s.draining] + [state]
            self._changed.notify_all()  # wake listeners on the deleted name
        return True

    def get_routing_info(self, name: str) -> Optional[dict]:
        """Routing snapshot for one deployment: consumed by Routers
        (replaces the reference's long-poll channel)."""
        with self._lock:
            state = self._deployments.get(name)
            if state is None:
                return None
            return {
                "version": state.version,
                "max_concurrent_queries": state.config.max_concurrent_queries,
                "max_queued_requests": state.config.max_queued_requests,
                "request_timeout_s": state.config.request_timeout_s,
                "replicas": [
                    (r.tag, r.handle)
                    for r in state.replicas
                    if r.state == ReplicaState.RUNNING
                ],
            }

    def get_route_table(self) -> Dict[str, str]:
        """{route_prefix: deployment_name} for the HTTP proxy."""
        with self._lock:
            table = {}
            for name, state in self._deployments.items():
                prefix = state.goal.get("route_prefix")
                if prefix:
                    table[prefix] = name
            return table

    def get_status(self) -> Dict[str, dict]:
        with self._lock:
            out = {}
            for name, state in self._deployments.items():
                counts: Dict[str, int] = {}
                for r in state.replicas:
                    counts[r.state] = counts.get(r.state, 0) + 1
                if state.draining:
                    counts[ReplicaState.DRAINING] = len(state.draining)
                running = counts.get(ReplicaState.RUNNING, 0)
                goal_n = state.config.num_replicas
                if state.unhealthy_reason is not None:
                    status = "UNHEALTHY"
                elif running >= goal_n:
                    status = "HEALTHY"
                else:
                    status = "UPDATING"
                out[name] = {
                    "status": status,
                    "version": state.version,
                    "replica_states": counts,
                    "num_replicas_goal": goal_n,
                    "message": state.unhealthy_reason or "",
                }
            return out

    def list_deployments(self) -> List[str]:
        with self._lock:
            return list(self._deployments)

    # ------------------------------------------------------------------
    # declarative config deploy (serve/schema.py + serve_head.py analog)
    # ------------------------------------------------------------------
    def apply_deploy_config(self, config: dict) -> dict:
        """Reconcile live state to a validated declarative config: import
        each application's target, apply per-deployment overrides, deploy,
        and delete config-owned deployments the new config dropped.
        Code-deployed apps (serve.run) are left alone."""
        import cloudpickle
        import ray_tpu_torch
        from ray_tpu_torch.serve.api import Application
        from ray_tpu_torch.serve.batching import uses_batching
        from ray_tpu_torch.serve.handle import DeploymentHandle
        from ray_tpu_torch.serve.schema import _UNSET, import_target, parse_deploy_config

        schema = parse_deploy_config(config)
        self_handle = ray_tpu_torch.get_actor(CONTROLLER_NAME,
                                        namespace=SERVE_NAMESPACE)
        deployed: List[str] = []
        warnings: List[str] = []

        def deploy_app(app_schema, a, is_root: bool):
            d = a.deployment
            ov = next((o for o in app_schema.deployments
                       if o.name == d.name), None)
            if ov is not None:
                d = d.options(
                    num_replicas=ov.num_replicas,
                    max_concurrent_queries=ov.max_concurrent_queries,
                    user_config=ov.user_config,
                    ray_actor_options=ov.ray_actor_options,
                    route_prefix=ov.route_prefix,  # shares options()'s
                    # "__unset__" sentinel value
                    autoscaling_config=(ov.autoscaling_config
                                        if ov.autoscaling_config is not None
                                        else "__unset__"),
                )
            if (is_root and app_schema.route_prefix != _UNSET
                    and (ov is None or ov.route_prefix == _UNSET)):
                d = d.options(route_prefix=app_schema.route_prefix)
            args = tuple(
                deploy_app(app_schema, v, False) if isinstance(v, Application)
                else v for v in a.args)
            kwargs = {
                k: deploy_app(app_schema, v, False) if isinstance(v, Application)
                else v for k, v in a.kwargs.items()}
            goal = {
                "serialized_def": cloudpickle.dumps(d._func_or_class),
                "init_args": args,
                "init_kwargs": kwargs,
                "config": d.config,
                "route_prefix": d.route_prefix,
                "uses_batching": uses_batching(d._func_or_class),
            }
            self.deploy(d.name, goal)
            deployed.append(d.name)
            return DeploymentHandle(d.name, self_handle)

        for app_schema in schema.applications:
            if app_schema.runtime_env:
                warnings.append(
                    f"app {app_schema.name!r}: runtime_env is recorded but "
                    "not applied to config imports (import_path must be "
                    "importable in the controller's environment)")
            deploy_app(app_schema, import_target(app_schema.import_path), True)

        prev_owned = set(getattr(self, "_config_owned", ()))
        for name in prev_owned - set(deployed):
            self.delete_deployment(name)
        self._config_owned = set(deployed)
        self._goal_config = schema.to_dict()
        out = {"deployed": deployed}
        if warnings:
            out["warnings"] = warnings
        return out

    def get_deploy_config(self) -> Optional[dict]:
        """The last applied declarative config (goal), or None."""
        return getattr(self, "_goal_config", None)

    def graceful_shutdown(self) -> bool:
        """Drain and end every replica, waiting for the drains (each
        bounded by its deployment's graceful window, all by
        ``SHUTDOWN_WAIT_S``), then end any replica still left.  The drains
        run on this actor's threads and replicas are detached, so one left
        when serve.shutdown() kills the controller afterwards would live
        on and keep its grant (a card, a share of one)."""
        import ray_tpu_torch

        self._stopped.set()
        with self._lock:
            states = list(self._deployments.values()) + self._retired
            for state in self._deployments.values():
                for r in list(state.replicas):
                    self._stop_replica(state, r)
            self._deployments.clear()
            self._changed.notify_all()  # release parked long-poll listeners
        grace = max((s.config.graceful_shutdown_timeout_s for s in states), default=0.0)
        deadline = time.monotonic() + min(grace + 2.0, SHUTDOWN_WAIT_S)
        while True:
            with self._lock:
                left = [r for s in states for r in s.draining]
            if not left or time.monotonic() >= deadline:
                break
            time.sleep(0.1)
        for r in left:
            try:
                ray_tpu_torch.kill(r.handle)
            except Exception:
                pass
        return True

    def ping(self) -> str:
        return "pong"

    def _bump(self, state: _DeploymentState) -> None:
        """Version bump + wake every parked long-poll listener (lock held)."""
        state.version += 1
        self._changed.notify_all()

    def listen_for_change(
        self, name: str, known_version: int, timeout_s: float = 30.0
    ) -> Optional[dict]:
        """LongPollHost analog (``serve/_private/long_poll.py:185``): block
        until the deployment's routing info is newer than ``known_version``
        (or the timeout lapses), then return the fresh snapshot.  Runs on
        the controller's threaded executor, so parked listeners don't block
        other control-plane calls."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while not self._stopped.is_set():
                state = self._deployments.get(name)
                if state is None or state.version != known_version:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._changed.wait(remaining)
        return self.get_routing_info(name)

    # ------------------------------------------------------------------
    # autoscaling (serve/_private/autoscaling_policy.py analog)
    # ------------------------------------------------------------------
    def record_handle_metrics(
        self, name: str, router_id: str, num_ongoing: float
    ) -> None:
        """Routers report their in-flight request count here (the
        reference's handle autoscaling-metrics push)."""
        with self._lock:
            state = self._deployments.get(name)
            if state is not None:
                state.handle_metrics[router_id] = (float(num_ongoing), time.monotonic())

    def get_autoscaling_metrics(self, name: str) -> Optional[dict]:
        """Live router load reports for one deployment (observability)."""
        with self._lock:
            state = self._deployments.get(name)
            if state is None:
                return None
            now = time.monotonic()
            return {
                rid: {"ongoing": c, "age_s": now - ts}
                for rid, (c, ts) in state.handle_metrics.items()
            }

    def scale_deployment(self, name: str, delta: int = 0,
                         num_replicas: Optional[int] = None) -> Optional[int]:
        """Externally-driven replica scaling — the hook the trend
        autoscaler's ``replica_scaler`` calls when router-backlog slope
        says capacity must arrive before the queue becomes an incident.
        Clamped to the deployment's autoscaling bounds (when configured)
        so an external scaler and the demand autoscaler can coexist.
        Returns the new goal, or None for an unknown deployment."""
        with self._lock:
            state = self._deployments.get(name)
            if state is None or state.deleting:
                return None
            cur = state.config.num_replicas
            target = num_replicas if num_replicas is not None else cur + int(delta)
            auto = state.config.autoscaling_config
            if auto is not None:
                target = max(auto.min_replicas, min(auto.max_replicas, target))
            target = max(0, target)
            if target != cur:
                _events.emit(
                    "serve", "deployment scaled", severity="INFO",
                    entity_id=name, prev=cur, goal=target)
                logger.info("serve: external scale %s %d -> %d",
                            name, cur, target)
                state.config.num_replicas = target
                self._reconcile(state)
                self._bump(state)
            return target

    def _autoscale_once(self, state: _DeploymentState, now: float) -> None:
        """One scaling decision for one deployment (lock held)."""
        cfg = state.config.autoscaling_config
        if cfg is None or state.deleting or state.unhealthy_reason:
            return
        # drop reports from routers that stopped reporting (dead handles) —
        # freshness-filtering alone would leak one entry per router ever seen
        stale = [
            rid for rid, (_, ts) in state.handle_metrics.items()
            if now - ts > cfg.look_back_period_s
        ]
        for rid in stale:
            del state.handle_metrics[rid]
        total_ongoing = sum(c for c, _ in state.handle_metrics.values())
        desired = math.ceil(
            total_ongoing / cfg.target_num_ongoing_requests_per_replica
        )
        desired = max(cfg.min_replicas, min(cfg.max_replicas, desired))
        current = state.config.num_replicas
        direction = (desired > current) - (desired < current)
        if direction == 0:
            state.scale_direction = 0
            return
        if direction != state.scale_direction:
            state.scale_direction = direction
            state.scale_pending_since = now
            return
        delay = cfg.upscale_delay_s if direction > 0 else cfg.downscale_delay_s
        if now - state.scale_pending_since < delay:
            return
        logger.info(
            "serve: autoscaling %s %d -> %d (ongoing=%.1f)",
            state.name, current, desired, total_ongoing,
        )
        state.config.num_replicas = desired
        state.scale_direction = 0
        self._reconcile(state)
        self._bump(state)

    def _autoscale_loop(self) -> None:
        while not self._stopped.is_set():
            now = time.monotonic()
            with self._lock:
                for state in list(self._deployments.values()):
                    self._autoscale_once(state, now)
            self._stopped.wait(0.5)

    # ------------------------------------------------------------------
    # reconciliation (deployment_state.py:958 update loop)
    # ------------------------------------------------------------------
    def _reconcile(self, state: _DeploymentState) -> None:
        """Converge one deployment's replica set toward its goal.  Caller
        holds the lock."""
        if state.unhealthy_reason is not None:
            return  # crash-looping: stop churning workers until redeployed
        goal_n = state.config.num_replicas
        live = [r for r in state.replicas if r.state in (ReplicaState.STARTING, ReplicaState.RUNNING)]
        for _ in range(goal_n - len(live)):
            self._start_replica(state)
        if len(live) > goal_n:
            # scale down: drop STARTING replicas first, newest first
            victims = sorted(
                live, key=lambda r: (r.state == ReplicaState.RUNNING,)
            )[: len(live) - goal_n]
            for r in victims:
                self._stop_replica(state, r)
            self._bump(state)

    def _start_replica(self, state: _DeploymentState) -> None:
        import ray_tpu_torch
        from ray_tpu_torch.serve._private.replica import ServeReplica

        goal = state.goal
        tag = f"{state.name}#{uuid.uuid4().hex[:8]}"
        options = dict(goal["config"].ray_actor_options or {})
        # control-plane concurrency group: health pings and drain polls
        # run in their OWN bounded pool on the replica worker, so a
        # saturated request lane can never starve them (the PR 12 ingress
        # exposure this group exists to close).  User code still runs on
        # the default lane: serialized unless batching raises it.
        # MERGED into any user-declared groups — setdefault would drop
        # "control" whenever ray_actor_options declares its own groups,
        # and with it every health probe.
        groups = dict(options.get("concurrency_groups") or {})
        groups.setdefault("control", 2)
        options["concurrency_groups"] = groups
        # replicas are serve infrastructure managed (and explicitly
        # killed) by the detached controller: the tenant-disconnect reap
        # must not SIGKILL them past the graceful drain path just because
        # the driver that deployed the app went away
        options.setdefault("lifetime", "detached")
        if goal.get("uses_batching"):
            # @serve.batch replicas execute up to their query cap
            # concurrently so batches can form; user code still runs on
            # the single batcher thread.  Plain deployments stay
            # serialized — unsynchronized state must not start racing.
            options.setdefault(
                "max_concurrency", goal["config"].max_concurrent_queries
            )
        handle = ray_tpu_torch.remote(ServeReplica).options(**options).remote(
            state.name,
            tag,
            goal["serialized_def"],
            goal["init_args"],
            goal["init_kwargs"],
            goal["config"].user_config,
        )
        state.replicas.append(_Replica(tag, handle))
        logger.info("serve: starting replica %s", tag)

    def _stop_replica(self, state: _DeploymentState, replica: _Replica) -> None:
        """Graceful replica termination: stop assigning, finish in-flight,
        then terminate.  Three ordered moves (caller holds the lock):

        1. out of the routing set + version bump — routers stop assigning
           to it before it learns it is draining (so ReplicaDrainingError
           is a race, not a steady state);
        2. background drain: ``prepare_for_drain`` flips the replica's
           accept flag, then ``drain_status`` is polled until in-flight
           requests AND live streams hit zero or the graceful window
           lapses (a timeout means accepted work WOULD have been lost,
           and is recorded as a ``replica drain timeout`` event);
        3. the user's shutdown hook, then ``kill``.

        Scale-downs, code redeploys, autoscaler shrink and replica
        replacement all route through here, so every deliberate
        termination gets the same no-lost-requests story."""
        import ray_tpu_torch

        replica.state = ReplicaState.DRAINING
        if replica in state.replicas:
            state.replicas.remove(replica)
        state.draining.append(replica)
        self._bump(state)
        grace = state.config.graceful_shutdown_timeout_s
        dep_name = state.name

        def drain():
            from ray_tpu_torch.exceptions import GetTimeoutError

            t0 = time.monotonic()
            deadline = t0 + grace
            _events.emit(
                "serve", "replica draining", severity="INFO",
                entity_id=replica.tag, deployment=dep_name, grace_s=grace)
            pending = None
            died = None
            try:
                # control group: the drain flag flips and the polls answer
                # even while the request lane is saturated (previously
                # these queued behind every accepted request and a slow
                # lane starved the drain).  grace_s lets the replica keep
                # serving stale-router racers inside the window (refusing
                # only once a kill is imminent).
                st = ray_tpu_torch.get(
                    replica.handle.prepare_for_drain.options(
                        concurrency_group="control").remote(
                        grace_s=max(deadline - time.monotonic(), 0.1)),
                    timeout=max(deadline - time.monotonic(), 0.1))
                while (st.get("inflight", 0) > 0 or st.get("streams", 0) > 0):
                    if time.monotonic() >= deadline:
                        pending = st
                        break
                    time.sleep(0.1)
                    st = ray_tpu_torch.get(replica.handle.drain_status.options(
                        concurrency_group="control").remote(),
                        timeout=max(deadline - time.monotonic(), 0.1))
                if not pending:
                    # default-lane barrier: a request ACCEPTED before the
                    # drain but still queued at the worker is invisible to
                    # the inflight gauge — this call rides the same FIFO
                    # lane, so its reply proves the lane is empty (the
                    # airtight everything-accepted-finished guarantee the
                    # queued-behind-requests drain used to give)
                    ray_tpu_torch.get(replica.handle.drain_status.remote(),
                                timeout=max(deadline - time.monotonic(), 0.1))
            except GetTimeoutError:
                # never reached the replica inside the window — a request
                # is still occupying its executor (the cut-off case)
                pending = {"inflight": 1, "streams": 0, "confirmed": False}
            except Exception as e:  # noqa: BLE001 — replica died mid-
                # drain: NOT a clean drain (anything it was running is
                # lost), but also not a cutoff we chose
                died = f"{type(e).__name__}: {e}"[:200]
            if died is not None:
                _events.emit(
                    "serve", "replica died while draining",
                    severity="WARNING", entity_id=replica.tag,
                    deployment=dep_name, error=died)
            elif pending is None:
                _events.emit(
                    "serve", "replica drained", severity="INFO",
                    entity_id=replica.tag, deployment=dep_name,
                    wait_s=round(time.monotonic() - t0, 3))
            else:
                _events.emit(
                    "serve", "replica drain timeout", severity="WARNING",
                    entity_id=replica.tag, deployment=dep_name,
                    inflight=pending.get("inflight", 0),
                    streams=pending.get("streams", 0), grace_s=grace)
            try:
                fut = replica.handle.prepare_for_shutdown.remote()
                ray_tpu_torch.get(fut, timeout=max(deadline - time.monotonic(), 1.0))
            except Exception:
                pass
            try:
                ray_tpu_torch.kill(replica.handle)
            except Exception:
                pass
            replica.state = ReplicaState.DEAD
            with self._lock:
                if replica in state.draining:
                    state.draining.remove(replica)

        threading.Thread(target=drain, daemon=True, name=f"drain-{replica.tag}").start()

    # ------------------------------------------------------------------
    # health loop (GcsHealthCheckManager-style active probing of replicas)
    # ------------------------------------------------------------------
    def _health_loop(self) -> None:
        import ray_tpu_torch

        while not self._stopped.is_set():
            now = time.monotonic()
            with self._lock:
                probes: List[Tuple[_DeploymentState, _Replica, Any]] = []
                for state in self._deployments.values():
                    if now - state.last_probe < state.config.health_check_period_s:
                        continue
                    state.last_probe = now
                    for r in state.replicas:
                        if r.state in (ReplicaState.STARTING, ReplicaState.RUNNING):
                            try:
                                # control group: a replica saturated with
                                # slow requests still answers its health
                                # probe (liveness, not busyness)
                                probes.append((state, r, r.handle.ping.options(
                                    concurrency_group="control").remote()))
                            except Exception:
                                pass
            if probes:
                # one shared wait bounds the cycle regardless of replica
                # count; non-ready pings mean "busy/starting", not dead
                refs = [fut for _, _, fut in probes]
                ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=2.0)
                ready_set = {r.binary() for r in ready}
                for state, r, fut in probes:
                    if fut.binary() not in ready_set:
                        continue
                    try:
                        ray_tpu_torch.get(fut, timeout=5.0)
                        alive = True
                    except Exception:
                        alive = False
                    if not alive:
                        # a replica that is alive but fails its health
                        # check still holds its grant (a card, a share
                        # of one): end it, or its replacement waits
                        # forever.  One whose constructor raised is
                        # already ended by the head, its grant returned.
                        try:
                            ray_tpu_torch.kill(r.handle)
                        except Exception:
                            pass
                    with self._lock:
                        if r not in state.replicas:
                            continue
                        if alive:
                            if r.state == ReplicaState.STARTING:
                                r.state = ReplicaState.RUNNING
                                self._bump(state)
                                state.consecutive_failures = 0
                                logger.info("serve: replica %s RUNNING", r.tag)
                        else:
                            state.replicas.remove(r)
                            self._bump(state)
                            if r.state == ReplicaState.STARTING:
                                state.consecutive_failures += 1
                            if (
                                state.consecutive_failures
                                >= MAX_CONSECUTIVE_START_FAILURES
                            ):
                                state.unhealthy_reason = (
                                    f"replicas failed to start "
                                    f"{state.consecutive_failures} times in a "
                                    "row; giving up until next deploy"
                                )
                                logger.error(
                                    "serve: deployment %s UNHEALTHY: %s",
                                    state.name, state.unhealthy_reason,
                                )
                            elif not state.deleting:
                                logger.warning(
                                    "serve: replica %s died; replacing", r.tag
                                )
                                self._reconcile(state)
            self._stopped.wait(0.25)
