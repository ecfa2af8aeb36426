"""Router: picks a replica for each request under a concurrency cap.

Analog of ``python/ray/serve/_private/router.py:221`` (ReplicaSet with
``max_concurrent_queries``) + ``:261`` (assign_replica): least-loaded
selection among RUNNING replicas, counting this router's in-flight calls
per replica, blocking when every replica is at its cap until an in-flight
call drains.  Replica membership arrives via a LongPollClient-style
listener thread parked in the controller's ``listen_for_change`` (TTL pull
as fallback); routers also report ongoing-request counts that feed the
controller's autoscaler.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import events as _events
from ray_tpu_torch.util import tracing as _tracing
from ray_tpu_torch.serve.config import (
    REFRESH_BACKOFF_BASE_S,
    REFRESH_BACKOFF_CAP_S,
    ROUTE_TABLE_TTL_S,
    ROUTING_PULL_TIMEOUT_S,
    SHED_RETRY_AFTER_S,
)
from ray_tpu_torch.serve.exceptions import BackPressureError

# Lazy router metric singletons (tags: deployment).
_ROUTER_METRICS = None
# long-stall flight-recorder events are throttled per router
_STALL_EVENT_MIN_INTERVAL_S = 1.0


def _router_metrics():
    global _ROUTER_METRICS
    if _ROUTER_METRICS is None:
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

        _ROUTER_METRICS = {
            "admission": Histogram(
                "ray_tpu_serve_admission_latency_s",
                "request arrival -> replica assignment latency (s)",
                boundaries=[0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5],
                tag_keys=("deployment",)),
            "queue_len": Gauge(
                "ray_tpu_serve_router_queue_len",
                "requests waiting for a replica in this router",
                tag_keys=("deployment",)),
            "shed": Counter(
                "ray_tpu_serve_shed_total",
                "requests shed at the backlog watermark (503 + Retry-After)",
                tag_keys=("deployment",)),
        }
    return _ROUTER_METRICS


class Router:
    def __init__(self, controller_handle, deployment_name: str):
        import uuid

        self._controller = controller_handle
        self._name = deployment_name
        self._lock = threading.Lock()
        self._version = -1
        self._replicas: List[Tuple[str, Any]] = []  # (tag, ActorHandle)
        self._max_concurrent = 100
        self._last_refresh = 0.0
        # tag -> {oid: ObjectRef}: dict-keyed so on_request_done is O(1)
        self._inflight: Dict[str, Dict[bytes, Any]] = {}
        self._ref_tags: Dict[bytes, str] = {}  # oid -> tag for done-reports
        self._rr = 0  # round-robin tiebreak among equally-loaded replicas
        self._router_id = uuid.uuid4().hex[:12]  # raylint: disable=R3 (per router)
        # the session (client) this router belongs to: its poll/metrics
        # threads exit when the session is shut down or replaced
        from ray_tpu_torch._private.worker import global_worker

        self._born_client = global_worker.client
        self._last_metrics_push = 0.0
        self._listener_started = False
        # callers inside assign_request that have not been assigned a
        # replica yet — queued demand the autoscaler must see
        self._pending = 0
        # load shedding: the controller-owned backlog watermark (-1 =
        # unbounded) plus hysteresis state, so an episode is one
        # started/stopped pair of events, not one event per shed request
        self._max_queued = -1
        self._request_timeout = None  # deployment default deadline (s)
        self._shedding = False
        self._shed_count = 0
        # routing-refresh failure backoff (the stale table keeps serving
        # while the controller is unreachable)
        self._refresh_failures = 0
        self._next_refresh_attempt = 0.0
        # replicas observed dead by a caller (RayActorError): filtered out
        # of every routing snapshot until the controller itself stops
        # listing them — a forced re-pull of a stale table must not
        # resurrect a corpse for the retry that just evicted it
        self._dead_tags: Dict[str, float] = {}

    def _ensure_listener(self) -> None:
        """LongPollClient analog (``long_poll.py:68``): a daemon thread
        parks in the controller's listen_for_change and applies membership
        updates the moment they happen (the TTL pull stays as a fallback
        for missed notifications).  The threads hold only a weakref — when
        the Router is garbage-collected they exit on their next cycle, so
        handle churn can't leak threads or parked controller slots."""
        import weakref

        with self._lock:
            if self._listener_started:
                return
            self._listener_started = True
        ref = weakref.ref(self)
        t = threading.Thread(
            target=_listen_loop, args=(ref,), daemon=True,
            name=f"router-poll-{self._name}",
        )
        t.start()
        # periodic prune+report even when no requests arrive — without it a
        # gone-idle router's last (high) in-flight report would pin the
        # autoscaler at peak size until look_back_period expires
        m = threading.Thread(
            target=_metrics_loop, args=(ref,), daemon=True,
            name=f"router-metrics-{self._name}",
        )
        m.start()

    def _apply_routing_info(self, info: dict) -> None:
        with self._lock:
            self._last_refresh = time.monotonic()
            self._refresh_failures = 0
            self._next_refresh_attempt = 0.0
            self._version = info["version"]
            self._max_concurrent = info["max_concurrent_queries"]
            self._max_queued = info.get("max_queued_requests", -1)
            self._request_timeout = info.get("request_timeout_s")
            listed = {tag for tag, _ in info["replicas"]}
            # drop dead-tag memory once the controller agrees (its health
            # loop removed the replica) — tags are uuid-unique, so there
            # is no reuse to worry about
            self._dead_tags = {t: ts for t, ts in self._dead_tags.items()
                               if t in listed}
            self._replicas = [(t, h) for t, h in info["replicas"]
                              if t not in self._dead_tags]
            live = {tag for tag, _ in self._replicas}
            self._inflight = {
                tag: refs for tag, refs in self._inflight.items() if tag in live
            }
            self._ref_tags = {
                oid: tag for oid, tag in self._ref_tags.items() if tag in live
            }

    def _set_queue_gauge(self) -> None:
        """Mirror ``_pending`` into the router queue-length gauge (lock
        held).  Set on every transition — a gauge updated only on arrival
        would freeze at the last burst's peak forever."""
        if _events.ENABLED:
            _router_metrics()["queue_len"].set(
                self._pending, tags={"deployment": self._name})

    def _push_metrics(self) -> None:
        """Throttled fire-and-forget ongoing-request report feeding the
        controller's autoscaler."""
        now = time.monotonic()
        if now - self._last_metrics_push < 0.5:
            return
        self._last_metrics_push = now
        # ongoing = assigned + queued (the reference's num_ongoing_requests
        # counts queued handle requests too — autoscaling_policy.py)
        total = self._pending + sum(len(refs) for refs in self._inflight.values())
        try:
            self._controller.record_handle_metrics.remote(
                self._name, self._router_id, total
            )
        except Exception:
            pass

    # ------------------------------------------------------------------
    def _pull_routing_info(self):
        """One controller round trip (split out so tests can inject
        failures and the backoff logic stays testable)."""
        import ray_tpu_torch

        return ray_tpu_torch.get(
            self._controller.get_routing_info.remote(self._name),
            timeout=ROUTING_PULL_TIMEOUT_S,
        )

    def _refresh(self, force: bool = False) -> None:
        """TTL pull with bounded-backoff failure handling: a transient
        controller stall must NOT poison routing.  On a failed pull the
        stale routing table keeps serving and the next attempt backs off
        ``base * 2^n`` up to the cap (MetricsPusher's retry shape) — a
        `force` pull honors the backoff too, or a dead controller would
        eat one ROUTING_PULL_TIMEOUT_S per request."""
        now = time.monotonic()
        if not force and now - self._last_refresh < ROUTE_TABLE_TTL_S:
            return
        if self._refresh_failures and now < self._next_refresh_attempt:
            return  # backing off; the stale table keeps routing
        try:
            info = self._pull_routing_info()
        except Exception as e:  # noqa: BLE001 — controller stall/restart:
            # every failure mode gets the same stale-table-and-retry answer
            with self._lock:
                self._refresh_failures += 1
                delay = min(
                    REFRESH_BACKOFF_CAP_S,
                    REFRESH_BACKOFF_BASE_S * (2 ** (self._refresh_failures - 1)),
                )
                self._next_refresh_attempt = time.monotonic() + delay
                n_stale = len(self._replicas)
            if _events.ENABLED:
                _events.emit(
                    "serve", "routing refresh failed",
                    severity="WARNING", entity_id=self._name,
                    failures=self._refresh_failures, retry_in_s=round(delay, 2),
                    stale_replicas=n_stale,
                    error=f"{type(e).__name__}: {e}"[:200])
            return
        if info is None:
            with self._lock:
                self._last_refresh = now
                self._refresh_failures = 0
                self._next_refresh_attempt = 0.0
                self._replicas = []
            return
        self._apply_routing_info(info)

    def _prune_inflight(self) -> None:
        """Drop completed refs from the in-flight ledgers (lock held).
        Costs one head round trip — callers that finished via the fast
        path already reported through on_request_done, so this only runs
        when saturated or from the periodic metrics loop."""
        import ray_tpu_torch

        for tag, refs in self._inflight.items():
            if not refs:
                continue
            ready, not_ready = ray_tpu_torch.wait(
                list(refs.values()), num_returns=len(refs), timeout=0
            )
            self._inflight[tag] = {r.binary(): r for r in not_ready}
            for r in ready:
                self._ref_tags.pop(r.binary(), None)

    def on_request_done(self, ref) -> None:
        """Caller finished ``ray_tpu_torch.get(ref)``: release the concurrency
        slot without a head round trip (the reference router decrements
        its in-flight counter from the completion callback the same way —
        ``router.py:221`` ReplicaSet)."""
        oid = ref.binary()
        with self._lock:
            tag = self._ref_tags.pop(oid, None)
            if tag is not None:
                self._inflight.get(tag, {}).pop(oid, None)

    @property
    def request_timeout_s(self) -> Optional[float]:
        """The deployment's default per-request deadline (config-owned;
        None until the first routing refresh lands or when unset)."""
        return self._request_timeout

    def _shed_locked(self) -> None:
        """Backlog at the watermark: refuse instead of queueing (lock
        held).  Raises BackPressureError after recording the shed.  An
        episode is one started/stopped pair of events; per-shed volume
        rides the counter metric, not one event per refused request."""
        self._shed_count += 1
        if _events.ENABLED:
            _router_metrics()["shed"].inc(tags={"deployment": self._name})
            if not self._shedding:
                _events.emit(
                    "serve", "ingress shedding started",
                    severity="WARNING", entity_id=self._name,
                    queued=self._pending, max_queued=self._max_queued,
                    replicas=len(self._replicas))
        self._shedding = True
        raise BackPressureError(self._name, self._pending, self._max_queued,
                                retry_after_s=SHED_RETRY_AFTER_S)

    def _maybe_stop_shedding_locked(self) -> None:
        """Close the shedding episode once the backlog has drained to half
        the watermark (hysteresis: flapping around the watermark must not
        spray started/stopped pairs).  Lock held."""
        if self._shedding and (
                self._max_queued <= 0
                or self._pending <= self._max_queued // 2):
            self._shedding = False
            if _events.ENABLED:
                _events.emit(
                    "serve", "ingress shedding stopped", severity="INFO",
                    entity_id=self._name, queued=self._pending,
                    shed_total=self._shed_count)

    def _pick(self) -> Optional[Tuple[str, Any]]:
        """Least-loaded replica under the cap, round-robin on ties (lock
        held).  None if every replica is saturated or none are RUNNING."""
        if not self._replicas:
            return None
        best = None
        best_load = None
        n = len(self._replicas)
        for i in range(n):
            tag, handle = self._replicas[(self._rr + i) % n]
            load = len(self._inflight.get(tag, ()))
            if load >= self._max_concurrent:
                continue
            if best_load is None or load < best_load:
                best, best_load = (tag, handle), load
        if best is not None:
            self._rr = (self._rr + 1) % n
        return best

    def assign_request(
        self,
        method_name: str,
        args: Tuple,
        kwargs: Dict,
        timeout: Optional[float] = 60.0,
        return_replica: bool = False,
        deadline: Optional[float] = None,
    ):
        """Submit one request to a replica; returns the ObjectRef (or
        ``(ref, replica_handle)`` with ``return_replica`` — streaming
        responses need follow-up next_chunks calls on the SAME replica).
        Blocks while no replica is available (deployment still starting, or
        all at max_concurrent_queries) — up to the request's REMAINING
        deadline when the caller passes one (``deadline`` is a
        ``time.monotonic()`` timestamp and wins over ``timeout``: a
        5s-budget request must not queue for the 60s default).  Raises
        :class:`BackPressureError` instead of queueing when the queued
        backlog has reached the deployment's ``max_queued_requests``."""
        import ray_tpu_torch
        from ray_tpu_torch.exceptions import GetTimeoutError

        if deadline is None:
            deadline = (time.monotonic() + timeout
                        if timeout is not None else None)
        t_arrival = time.perf_counter()
        stall_reported = False
        # traced callers (HTTP ingress root or a user trace() block): the
        # admission wait becomes a child span and the replica task is
        # submitted UNDER it, so replica execution chains off the admission
        # in the assembled tree (tracing_helper's context-injection analog)
        trace_ctx = None
        if _events.ENABLED:
            trace_ctx = _tracing.child_context(f"admission {self._name}")
        self._ensure_listener()
        # refresh BEFORE the shed check so a just-raised watermark (or the
        # very first call) sheds against current config, not defaults
        self._refresh()
        force = False
        with self._lock:
            if 0 < self._max_queued <= self._pending:
                self._shed_locked()  # raises BackPressureError
            self._pending += 1  # queued demand, visible to the autoscaler
            self._set_queue_gauge()
        assigned = False
        try:
            pruned = False
            while True:
                self._refresh(force=force)
                force = False
                with self._lock:
                    picked = self._pick()
                    if picked is None and not pruned:
                        # saturated by our own ledger: reconcile against
                        # the head once (callers that crashed before
                        # on_request_done would otherwise leak slots)
                        self._prune_inflight()
                        pruned = True
                        picked = self._pick()
                    if picked is not None:
                        tag, handle = picked
                        self._pending -= 1
                        self._set_queue_gauge()
                        self._maybe_stop_shedding_locked()
                        assigned = True
                        if trace_ctx is not None:
                            token = _tracing.adopt(trace_ctx)
                            try:
                                ref = handle.handle_request.remote(
                                    method_name, args, kwargs)
                            finally:
                                _tracing.restore(token)
                        else:
                            ref = handle.handle_request.remote(
                                method_name, args, kwargs)
                        self._inflight.setdefault(tag, {})[ref.binary()] = ref
                        self._ref_tags[ref.binary()] = tag
                        self._push_metrics()
                        if _events.ENABLED:
                            waited = time.perf_counter() - t_arrival
                            _router_metrics()["admission"].observe(
                                waited, tags={"deployment": self._name})
                            # serve-admission span: arrival -> assignment
                            _events.emit(
                                "serve", f"admission {self._name}",
                                severity="DEBUG", entity_id=tag,
                                span_dur=waited)
                            if trace_ctx is not None:
                                _tracing.emit_span(
                                    f"admission {self._name}", waited,
                                    trace_ctx, phase="router_admission",
                                    replica=tag, deployment=self._name)
                        return (ref, handle) if return_replica else ref
                    self._push_metrics()
                    waitable = [r for refs in self._inflight.values()
                                for r in refs.values()]
                if _events.ENABLED and not stall_reported \
                        and time.perf_counter() - t_arrival > _STALL_EVENT_MIN_INTERVAL_S:
                    stall_reported = True
                    _events.emit(
                        "serve", "router stalled: no replica available",
                        severity="WARNING", entity_id=self._name,
                        pending=self._pending,
                        replicas=len(self._replicas))
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise GetTimeoutError(
                            f"no replica of {self._name!r} available within "
                            f"the request deadline "
                            f"(waited {time.perf_counter() - t_arrival:.1f}s)"
                        )
                else:
                    remaining = 0.5
                if waitable:
                    # our own backpressure: wait for one in-flight call to
                    # drain — never past the caller's remaining deadline
                    ray_tpu_torch.wait(waitable, num_returns=1,
                                 timeout=min(0.5, max(remaining, 0.01)))
                else:
                    # deployment still starting (or scaled to 0): poll membership
                    time.sleep(0.1)
                    force = True
        finally:
            if not assigned:
                with self._lock:
                    self._pending -= 1
                    self._set_queue_gauge()
                    # queued callers leaving via timeout also drain the
                    # backlog — without this, an episode whose queue
                    # expired (hung replicas, deleted deployment) would
                    # never record its stop
                    self._maybe_stop_shedding_locked()

    def on_replica_error(self, ref) -> None:
        """Caller observed a RayActorError from ``ref``: evict that replica
        locally and force the next assignment to re-pull membership (the
        reference router's replica-removal-on-failure path)."""
        oid = ref.binary()
        with self._lock:
            dead_tag = self._ref_tags.pop(oid, None)
            if dead_tag is not None:
                self._dead_tags[dead_tag] = time.monotonic()
                self._inflight.pop(dead_tag, None)
                self._ref_tags = {
                    o: t for o, t in self._ref_tags.items() if t != dead_tag
                }
                self._replicas = [
                    (t, h) for t, h in self._replicas if t != dead_tag
                ]
            self._last_refresh = 0.0


# ---------------------------------------------------------------------------
# background loops — module functions over a weakref so a dropped Router is
# collectable and its threads unwind instead of leaking
# ---------------------------------------------------------------------------


def _session_gone(router) -> bool:
    """The session this router was born in was shut down (or replaced):
    its threads must unwind instead of poking a dead/new head forever."""
    from ray_tpu_torch._private.worker import global_worker

    client = getattr(router, "_born_client", None)
    return client is None or client.closed or global_worker.client is not client


def _listen_loop(router_ref) -> None:
    import ray_tpu_torch

    while True:
        router = router_ref()
        if router is None:
            return
        if _session_gone(router):
            return
        controller, name, version = router._controller, router._name, router._version
        del router  # don't pin the Router across the blocking poll
        try:
            info = ray_tpu_torch.get(
                controller.listen_for_change.remote(name, version, 30.0),
                timeout=45,
            )
        except Exception:
            time.sleep(1.0)
            continue
        router = router_ref()
        if router is None:
            return
        if info is not None:
            router._apply_routing_info(info)
        else:
            # deployment gone (deleted or not yet deployed): don't hammer
            # the controller with back-to-back polls
            time.sleep(1.0)


def _metrics_loop(router_ref) -> None:
    while True:
        time.sleep(2.0)
        router = router_ref()
        if router is None:
            return
        if _session_gone(router):
            return
        try:
            with router._lock:
                router._prune_inflight()
                router._push_metrics()
        except Exception:
            pass
