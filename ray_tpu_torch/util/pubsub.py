"""Cluster pubsub — the generalized publisher/subscriber channels.

Analog of ``src/ray/pubsub/`` (``Publisher``/``Subscriber``, channels in
``pubsub.proto``) as surfaced to Python.  The head fans published
messages out to subscriber connections; built-in channels:

- ``node_change`` — node join/death events (GcsNodeManager broadcast)
- ``error``       — task failures (the error-pubsub channel drivers print)

plus any application channel name.

    from ray_tpu_torch.util import pubsub
    pubsub.subscribe("jobs_done", lambda data: print("done:", data))
    pubsub.publish("jobs_done", {"job": 1})
"""

from __future__ import annotations

from typing import Any, Callable


def _client():
    from ray_tpu_torch._private.worker import global_worker

    if not global_worker.connected:
        raise RuntimeError("ray_tpu_torch.init() must run before pubsub")
    return global_worker.client


def publish(channel: str, data: Any) -> None:
    _client().publish(channel, data)


def subscribe(channel: str, callback: Callable[[Any], None]) -> None:
    _client().subscribe(channel, callback)


def unsubscribe(channel: str, callback: Callable[[Any], None] = None) -> None:
    _client().unsubscribe(channel, callback)
