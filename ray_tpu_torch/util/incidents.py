"""Incident lifecycle + alert sinks for the watchdog plane (the port's
copy of ``ray_tpu/util/incidents.py``).

Doctor findings and SLO burns are *stateless* — the same pathology
re-reported every evaluation, nothing ever "resolves".  This module gives
them identity and a lifecycle: one :class:`IncidentTable` entry per
``(rule, entity)`` pair with a stable id, moving open → ack → resolved
under hysteresis (a finding must stay clear for N consecutive ticks to
resolve; a resolved incident whose finding returns re-opens, and a flappy
incident that keeps re-opening escalates its severity instead of paging
again at the same level).

Every transition is pushed to pluggable **alert sinks** through a bounded
queue drained by a dedicated daemon sender thread — delivery I/O (webhook
POSTs with bounded retry + a dead-letter counter, command hooks) never
runs under a watchdog lock and can never block a tick.

The table is bounded both ways: at most ``max_incidents`` records
(oldest resolved evicted first) and a capped transition history per
incident.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import shutil
import subprocess
import threading
import time
import urllib.request
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

# hysteresis: consecutive clear ticks before an open incident resolves
DEFAULT_RESOLVE_TICKS = 3
# a resolved incident re-opening this many times escalates its severity
DEFAULT_ESCALATE_REOPENS = 3
DEFAULT_MAX_INCIDENTS = 256
DEFAULT_HISTORY_PER_INCIDENT = 20

_SEV_ESCALATION = {"INFO": "WARNING", "WARNING": "ERROR",
                   "ERROR": "CRITICAL", "CRITICAL": "CRITICAL"}


def incident_id(rule: str, entity: str) -> str:
    """Stable slug for one (rule, entity) pair — deterministic on purpose
    (no per-open entropy): the same pathology on the same entity is the
    same incident across re-opens, restarts, and CLI invocations."""
    ent = str(entity or "cluster")
    safe = "".join(c if (c.isalnum() or c in "._-") else "-" for c in ent)
    return f"{rule}--{safe[:80]}"


class IncidentTable:
    """Bounded (rule, entity) → incident map with open/ack/resolve
    hysteresis.  ``observe()`` is the only mutator on the tick path; it
    computes transitions under the lock and returns snapshots — event
    emission, sink pushes, and bundle captures are the caller's job,
    after release."""

    def __init__(self, resolve_ticks: int = DEFAULT_RESOLVE_TICKS,
                 escalate_reopens: int = DEFAULT_ESCALATE_REOPENS,
                 max_incidents: int = DEFAULT_MAX_INCIDENTS,
                 history_per_incident: int = DEFAULT_HISTORY_PER_INCIDENT):
        self.resolve_ticks = max(1, int(resolve_ticks))
        self.escalate_reopens = max(1, int(escalate_reopens))
        self.max_incidents = max(1, int(max_incidents))
        self._history_cap = max(1, int(history_per_incident))
        self._incidents: Dict[str, dict] = {}
        self._lock = threading.Lock()

    # -- tick path ------------------------------------------------------
    def observe(self, findings: List[dict],
                now: Optional[float] = None) -> List[Tuple[dict, str]]:
        """Fold one tick's findings (doctor rules + SLO burns, each a dict
        with at least ``rule``/``severity``/``summary``) into the table.
        Returns ``[(incident_snapshot, transition), ...]`` where
        transition is ``open``/``reopen``/``escalate``/``resolve``."""
        if now is None:
            now = time.time()
        out: List[Tuple[dict, str]] = []
        with self._lock:
            active_ids = set()
            for f in findings:
                rule = str(f.get("rule", "unknown"))
                entity = str(f.get("entity", "") or "cluster")
                iid = incident_id(rule, entity)
                active_ids.add(iid)
                inc = self._incidents.get(iid)
                if inc is None:
                    inc = self._new_incident(iid, rule, entity, f, now)
                    self._incidents[iid] = inc
                    self._record(inc, "open", now)
                    out.append((self._snapshot(inc), "open"))
                elif inc["state"] == "resolved":
                    inc["state"] = "open"
                    inc["reopen_count"] += 1
                    inc["resolved_at"] = None
                    inc["ack_at"] = None
                    inc["clear_streak"] = 0
                    self._update_from_finding(inc, f, now)
                    self._record(inc, "reopen", now)
                    out.append((self._snapshot(inc), "reopen"))
                    if (inc["reopen_count"] >= self.escalate_reopens
                            and not inc["escalated"]):
                        inc["escalated"] = True
                        inc["severity"] = _SEV_ESCALATION.get(
                            inc["severity"], "ERROR")
                        self._record(inc, "escalate", now)
                        out.append((self._snapshot(inc), "escalate"))
                else:  # open/ack: refresh, reset hysteresis, no transition
                    inc["clear_streak"] = 0
                    self._update_from_finding(inc, f, now)
            for iid, inc in self._incidents.items():
                if iid in active_ids or inc["state"] == "resolved":
                    continue
                inc["clear_streak"] += 1
                if inc["clear_streak"] >= self.resolve_ticks:
                    inc["state"] = "resolved"
                    inc["resolved_at"] = now
                    inc["updated_at"] = now
                    self._record(inc, "resolve", now)
                    out.append((self._snapshot(inc), "resolve"))
            self._evict_locked()
        return out

    def _new_incident(self, iid: str, rule: str, entity: str, f: dict,
                      now: float) -> dict:
        return {
            "id": iid, "rule": rule, "entity": entity,
            "severity": f.get("severity", "WARNING"),
            "summary": f.get("summary", ""),
            "remedy": f.get("remedy", ""),
            "count": int(f.get("count", 1) or 1),
            "evidence": list(f.get("evidence", ()))[:5],
            "state": "open", "opened_at": now, "updated_at": now,
            "resolved_at": None, "ack_at": None,
            "reopen_count": 0, "clear_streak": 0, "escalated": False,
            "bundle_dir": None,
            "history": deque(maxlen=self._history_cap),
        }

    def _update_from_finding(self, inc: dict, f: dict, now: float) -> None:
        inc["updated_at"] = now
        inc["summary"] = f.get("summary", inc["summary"])
        inc["remedy"] = f.get("remedy", inc["remedy"])
        inc["count"] = int(f.get("count", inc["count"]) or inc["count"])
        if f.get("evidence"):
            inc["evidence"] = list(f["evidence"])[:5]
        if not inc["escalated"]:
            inc["severity"] = f.get("severity", inc["severity"])

    def _record(self, inc: dict, transition: str, now: float) -> None:
        inc["history"].append({"transition": transition, "ts": now,
                               "severity": inc["severity"]})

    def _evict_locked(self) -> None:
        while len(self._incidents) > self.max_incidents:
            resolved = [(inc["updated_at"], iid)
                        for iid, inc in self._incidents.items()
                        if inc["state"] == "resolved"]
            if resolved:
                resolved.sort()
                del self._incidents[resolved[0][1]]
                continue
            oldest = min(self._incidents,
                         key=lambda k: self._incidents[k]["updated_at"])
            del self._incidents[oldest]

    # -- surfaces -------------------------------------------------------
    def ack(self, iid: str,
            now: Optional[float] = None) -> Optional[dict]:
        """Acknowledge an open incident (snapshot or None if unknown /
        not open).  Ack'd incidents still resolve via hysteresis."""
        if now is None:
            now = time.time()
        with self._lock:
            inc = self._incidents.get(iid)
            if inc is None or inc["state"] != "open":
                return None
            inc["state"] = "ack"
            inc["ack_at"] = now
            inc["updated_at"] = now
            self._record(inc, "ack", now)
            return self._snapshot(inc)

    def get(self, iid: str) -> Optional[dict]:
        with self._lock:
            inc = self._incidents.get(iid)
            return self._snapshot(inc) if inc is not None else None

    def set_bundle_dir(self, iid: str, path: str) -> None:
        with self._lock:
            inc = self._incidents.get(iid)
            if inc is not None:
                inc["bundle_dir"] = path

    def list(self, include_resolved: bool = True) -> List[dict]:
        with self._lock:
            rows = [self._snapshot(i) for i in self._incidents.values()
                    if include_resolved or i["state"] != "resolved"]
        rows.sort(key=lambda r: r["opened_at"])
        return rows

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for inc in self._incidents.values():
                out[inc["state"]] = out.get(inc["state"], 0) + 1
            return out

    @staticmethod
    def _snapshot(inc: dict) -> dict:
        out = dict(inc)
        out["history"] = list(inc["history"])
        out["evidence"] = list(inc["evidence"])
        return out


# ---------------------------------------------------------------------------
# alert sinks
# ---------------------------------------------------------------------------


class LogSink:
    """Default sink: one structured line per transition on the watchdog
    logger — always on, so a bare cluster still records its pages."""

    name = "log"

    def deliver(self, payload: dict) -> None:
        inc = payload.get("incident", {})
        logger.warning(
            "incident %s %s [%s] %s", payload.get("transition"),
            inc.get("id"), inc.get("severity"), inc.get("summary"))


class WebhookSink:
    """POST each transition as JSON to ``url`` (stdlib http only) with
    bounded retry; a payload that exhausts its retries raises so the
    sender thread counts it into the dead-letter ledger."""

    def __init__(self, url: str, retries: int = 3, timeout_s: float = 2.0,
                 backoff_s: float = 0.25):
        self.name = "webhook"
        self.url = url
        self.retries = max(1, int(retries))
        self.timeout_s = timeout_s
        self.backoff_s = backoff_s

    def deliver(self, payload: dict) -> None:
        body = json.dumps(payload, default=str).encode()
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        last: Optional[BaseException] = None
        for attempt in range(self.retries):
            try:
                with urllib.request.urlopen(
                        req, timeout=self.timeout_s) as resp:
                    if 200 <= resp.status < 300:
                        return
                    last = RuntimeError(f"webhook HTTP {resp.status}")
            except Exception as e:  # noqa: BLE001 — refused/timeout/5xx
                last = e
            if attempt + 1 < self.retries:
                time.sleep(self.backoff_s * (2 ** attempt))
        raise RuntimeError(
            f"webhook delivery failed after {self.retries} attempts: {last}")


class CommandSink:
    """Run a shell hook per transition; the payload arrives on stdin as
    JSON (the PagerDuty-script escape hatch)."""

    def __init__(self, cmd: str, timeout_s: float = 5.0):
        self.name = "command"
        self.cmd = cmd
        self.timeout_s = timeout_s

    def deliver(self, payload: dict) -> None:
        proc = subprocess.run(
            self.cmd, shell=True,
            input=json.dumps(payload, default=str).encode(),
            capture_output=True, timeout=self.timeout_s)
        if proc.returncode != 0:
            raise RuntimeError(
                f"command sink exited {proc.returncode}: "
                f"{proc.stderr[-200:].decode(errors='replace')}")


class SinkSet:
    """Bounded queue in front of the sinks, drained by one daemon sender
    thread — the tick path only enqueues (lock-free beyond the queue's
    own), and a slow webhook can neither block a tick nor grow memory:
    past ``maxsize`` the oldest pending payload is dropped and counted."""

    def __init__(self, sinks: Optional[List[Any]] = None,
                 maxsize: int = 256):
        self.sinks = list(sinks) if sinks is not None else [LogSink()]
        self._q: "queue.Queue[Optional[dict]]" = queue.Queue(
            maxsize=max(1, int(maxsize)))
        self._stats_lock = threading.Lock()
        self._delivered: Dict[str, int] = {}
        self._dead_letter: Dict[str, int] = {}
        self._dropped = 0
        self._stop = False
        self._thread = threading.Thread(
            target=self._drain, name="watchdog-sinks", daemon=True)
        self._thread.start()

    def push(self, payload: dict) -> None:
        while True:
            try:
                self._q.put_nowait(payload)
                return
            except queue.Full:
                try:
                    self._q.get_nowait()
                    with self._stats_lock:
                        self._dropped += 1
                except queue.Empty:
                    pass

    def _drain(self) -> None:
        while True:
            payload = self._q.get()
            if payload is None:
                return
            for sink in self.sinks:
                name = getattr(sink, "name", type(sink).__name__)
                try:
                    sink.deliver(payload)
                except Exception:  # noqa: BLE001 — delivery is best-effort
                    with self._stats_lock:
                        self._dead_letter[name] = (
                            self._dead_letter.get(name, 0) + 1)
                else:
                    with self._stats_lock:
                        self._delivered[name] = (
                            self._delivered.get(name, 0) + 1)

    def flush(self, timeout_s: float = 2.0) -> bool:
        """Best-effort wait for the queue to drain (tests)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._q.empty():
                return True
            time.sleep(0.02)
        return self._q.empty()

    def stop(self) -> None:
        if not self._stop:
            self._stop = True
            self.push(None)  # type: ignore[arg-type]

    def stats(self) -> dict:
        with self._stats_lock:
            return {"queued": self._q.qsize(), "dropped": self._dropped,
                    "delivered": dict(self._delivered),
                    "dead_letter": dict(self._dead_letter)}


def sinks_from_env() -> List[Any]:
    """Sink list from the environment: the log sink always, a webhook
    when ``RAY_TPU_TORCH_INCIDENT_WEBHOOK`` names a URL, a command hook when
    ``RAY_TPU_TORCH_INCIDENT_CMD`` names a shell command."""
    sinks: List[Any] = [LogSink()]
    url = os.environ.get("RAY_TPU_TORCH_INCIDENT_WEBHOOK", "").strip()
    if url:
        sinks.append(WebhookSink(url))
    cmd = os.environ.get("RAY_TPU_TORCH_INCIDENT_CMD", "").strip()
    if cmd:
        sinks.append(CommandSink(cmd))
    return sinks


def prune_bundle_dirs(root: str, keep: int) -> List[str]:
    """Retention cap for ``<session>/incidents/``: keep the newest
    ``keep`` bundle directories, delete the rest (oldest mtime first).
    Returns the pruned paths."""
    try:
        entries = [os.path.join(root, d) for d in os.listdir(root)]
    except OSError:
        return []
    dirs = [(os.path.getmtime(p), p) for p in entries if os.path.isdir(p)]
    dirs.sort()
    pruned = []
    while len(dirs) > max(0, int(keep)):
        _, victim = dirs.pop(0)
        shutil.rmtree(victim, ignore_errors=True)
        pruned.append(victim)
    return pruned
