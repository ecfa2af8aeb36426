"""Usage stats: opt-out, local-only session feature report.

Analog of the reference's usage-stats subsystem
(``python/ray/_private/usage/usage_lib.py`` — opt-out telemetry of which
libraries/features a session used).  The report is local only: it is
written to the session directory (``usage_report.json``) instead of
posted; the schema mirrors the reference's payload so an
operator can aggregate reports themselves.

Disable with ``RAY_TPU_TORCH_USAGE_STATS_ENABLED=0``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Set

_lock = threading.Lock()
_features: Set[str] = set()
_counters: Dict[str, int] = {}


def reset() -> None:
    """Start a fresh session scope (called at head start)."""
    with _lock:
        _features.clear()
        _counters.clear()


def enabled() -> bool:
    return os.environ.get("RAY_TPU_TORCH_USAGE_STATS_ENABLED", "1") not in ("0", "false")


def record_feature(name: str) -> None:
    """Mark a library/feature as used this session (cheap, idempotent).

    Works from any process: worker/driver processes also publish the flag
    to the head's KV (namespace ``usage``) so features exercised inside
    actors — e.g. a Tune trial importing rllib — reach the head's report."""
    if not enabled():
        return
    with _lock:
        if name in _features:
            return
        _features.add(name)
    try:
        from ray_tpu_torch._private.worker import global_worker

        if global_worker.connected and global_worker.client is not None:
            global_worker.client.kv_put("usage", name.encode(), b"1")
    except Exception:
        pass  # never let telemetry break the caller


def record_set(name: str, n: int) -> None:
    """Set a counter to an absolute value (session totals at shutdown)."""
    if not enabled():
        return
    with _lock:
        _counters[name] = n


def write_report(session_dir: str) -> str:
    """Write the session's usage report (called at head shutdown)."""
    if not enabled():
        return ""
    with _lock:
        payload = {
            "schema_version": "0.1",
            "timestamp": time.time(),
            "features_used": sorted(_features),
            "counters": dict(_counters),
        }
    path = os.path.join(session_dir, "usage_report.json")
    try:
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
    except OSError:
        return ""
    return path
