"""Serve configuration dataclasses.

Analog of the reference's ``python/ray/serve/config.py`` (DeploymentConfig,
HTTPOptions) — the declarative half of a deployment: replica count, queue
caps, actor resources, and the HTTP front door.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class AutoscalingConfig:
    """Demand-driven replica scaling (``serve/config.py`` AutoscalingConfig +
    ``_private/autoscaling_policy.py`` analog).  The controller aggregates
    ongoing-request counts reported by routers and sizes the replica set to
    ``total_ongoing / target_num_ongoing_requests_per_replica``, smoothed by
    the up/downscale delays."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_num_ongoing_requests_per_replica: float = 1.0
    upscale_delay_s: float = 2.0
    downscale_delay_s: float = 10.0
    # router metric reports older than this are dropped from the aggregate
    look_back_period_s: float = 10.0

    def validate(self) -> None:
        if self.min_replicas < 0 or self.max_replicas < max(1, self.min_replicas):
            raise ValueError(
                "need 0 <= min_replicas <= max_replicas (and max_replicas >= 1)"
            )
        if self.target_num_ongoing_requests_per_replica <= 0:
            raise ValueError("target_num_ongoing_requests_per_replica must be > 0")


@dataclass
class DeploymentConfig:
    """Goal-state knobs the controller reconciles toward
    (``serve/config.py`` DeploymentConfig analog)."""

    num_replicas: int = 1
    max_concurrent_queries: int = 100
    user_config: Optional[Any] = None
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    health_check_period_s: float = 2.0
    graceful_shutdown_timeout_s: float = 10.0
    autoscaling_config: Optional[AutoscalingConfig] = None
    # Load-shedding watermark: a router whose queued (not-yet-assigned)
    # backlog reaches this sheds with BackPressureError instead of queueing
    # (HTTP: 503 + Retry-After).  -1 = unbounded (the pre-shedding
    # behavior handle callers rely on); the reference's handle-API knob of
    # the same name also defaults unbounded.
    max_queued_requests: int = -1
    # Default per-request deadline the HTTP ingress applies when the
    # client sends no X-Serve-Deadline-S header.  None = the ingress
    # default (INGRESS_DEFAULT_TIMEOUT_S).
    request_timeout_s: Optional[float] = None

    def validate(self) -> None:
        if self.num_replicas < 0:
            raise ValueError("num_replicas must be >= 0")
        if self.max_concurrent_queries <= 0:
            raise ValueError("max_concurrent_queries must be > 0")
        if self.max_queued_requests < -1 or self.max_queued_requests == 0:
            raise ValueError(
                "max_queued_requests must be -1 (unbounded) or > 0")
        if self.request_timeout_s is not None and self.request_timeout_s <= 0:
            raise ValueError("request_timeout_s must be > 0")
        if self.autoscaling_config is not None:
            self.autoscaling_config.validate()


# How long routers/proxies trust a cached routing snapshot before re-pulling
# from the controller (the poll-TTL stand-in for the reference's long-poll).
ROUTE_TABLE_TTL_S = 1.0

# Consecutive replica-start failures before the controller stops retrying a
# deployment and marks it UNHEALTHY (deployment_state's backoff analog).
MAX_CONSECUTIVE_START_FAILURES = 3

# One controller pull on the routing path.  Deliberately short: a stalled
# controller must cost a request at most this much before the router falls
# back to its stale table and retries in the background.
ROUTING_PULL_TIMEOUT_S = 5.0
# Routing-refresh failure backoff (MetricsPusher-style bounded retry): the
# stale table keeps serving while retries space out base * 2^n up to cap.
REFRESH_BACKOFF_BASE_S = 0.2
REFRESH_BACKOFF_CAP_S = 5.0

# Ingress request defaults.  Every HTTP request carries a deadline: the
# client's X-Serve-Deadline-S header, else the deployment's
# request_timeout_s, else this.
INGRESS_DEFAULT_TIMEOUT_S = 60.0
# Replica-death retries per request (idempotent requests only); each retry
# re-assigns to a live replica under the same deadline.
INGRESS_MAX_RETRIES = 3
# Retry-After value (seconds) sent with shedding 503s.
SHED_RETRY_AFTER_S = 1.0


@dataclass
class HTTPOptions:
    """HTTP proxy options (``serve/config.py`` HTTPOptions analog)."""

    host: str = "127.0.0.1"
    port: int = 8000
    # port=0 binds an ephemeral port (test-friendly on shared machines)


@dataclass
class ReplicaState:
    """One replica's lifecycle state as the controller tracks it
    (``_private/common.py`` ReplicaState analog)."""

    STARTING = "STARTING"
    RUNNING = "RUNNING"
    # out of the routing set, finishing accepted work before termination
    DRAINING = "DRAINING"
    STOPPING = "STOPPING"
    DEAD = "DEAD"
