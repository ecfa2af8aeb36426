"""Serve-specific exception types (``python/ray/serve/exceptions.py``
analog).

These cross process boundaries: a replica raises
:class:`ReplicaDrainingError`, the worker wraps it in ``RayTaskError``
(with ``cause`` preserved through pickling), and the ingress unwraps it to
decide retryability.  Keep them dependency-free and picklable.
"""

from __future__ import annotations


class RayServeException(Exception):
    """Base class for serve control/data-plane errors."""


class BackPressureError(RayServeException):
    """The router's queued-request backlog crossed ``max_queued_requests``.

    Raised *instead of* queueing: the caller gets an immediate, cheap
    signal that the deployment is saturated.  The HTTP ingress maps this
    to ``503`` with a ``Retry-After`` header; handle callers can catch it
    and apply their own backoff.
    """

    def __init__(self, deployment: str, queued: int, limit: int,
                 retry_after_s: float = 1.0):
        super().__init__(
            f"deployment {deployment!r} is shedding load: {queued} requests "
            f"already queued (max_queued_requests={limit})")
        self.deployment = deployment
        self.queued = queued
        self.limit = limit
        self.retry_after_s = retry_after_s

    def __reduce__(self):
        return (BackPressureError,
                (self.deployment, self.queued, self.limit,
                 self.retry_after_s))


class ReplicaDrainingError(RayServeException):
    """The chosen replica is draining and no longer accepts new requests.

    Only a membership race can hit this (the controller pulls a draining
    replica out of the routing set *before* telling it to drain), so the
    request was never executed — it is safe to re-assign regardless of
    idempotency.
    """

    def __init__(self, replica_tag: str = "?"):
        super().__init__(
            f"replica {replica_tag!r} is draining and accepts no new "
            "requests")
        self.replica_tag = replica_tag

    def __reduce__(self):
        return (ReplicaDrainingError, (self.replica_tag,))
