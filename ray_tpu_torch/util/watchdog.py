"""Watchdog plane: continuous SLO/burn-rate evaluation on the head (the
port's copy of ``ray_tpu/util/watchdog.py``).

After the recording planes (events, traces, TSDB, flamegraphs, logs) the
cluster records everything but *watches* nothing — ``run_doctor`` is an
on-demand CLI, findings have no lifecycle, and no declared objective
exists for the numbers the benches gate.  The :class:`Watchdog` closes
that loop with a head-side evaluation thread (cadence
``RAY_TPU_TORCH_WATCHDOG_S``, default 15s; every head runs one) that per
tick:

1. runs the doctor rules **incrementally** — event-cursor deltas via
   :class:`ray_tpu_torch.util.doctor.DoctorState` and head-local table access,
   never a 100k-row state-API pull, so a tick costs milliseconds;
2. evaluates **declarative SLOs** against the head TSDB (``slos.json``
   or :meth:`Watchdog.add_slo`) with SRE-style multi-window burn-rate:
   the fast (default 5min) AND slow (default 1h) windows must both
   breach before an SLO "burns" — single-window alerting flaps on noisy
   single-host benches;
3. folds findings + burns into the **incident lifecycle**
   (:mod:`ray_tpu_torch.util.incidents`): stable ids, open → ack → resolved
   with hysteresis, re-open escalation, every transition a
   flight-recorder ``incident`` event plus a push to the alert sinks;
4. at incident-open, freezes a **post-mortem bundle** under
   ``<session>/incidents/<id>/`` — implicated log tails (including
   retired death tails), trace span trees, TSDB slices for the burning
   series, the latest collapsed profile, an event-ring excerpt, and the
   memory/owner audit — to disk before the bounded rings decay the
   evidence.  ``debug_dump()`` writes the same bundle on demand.

SLO declaration (``slos.json``: ``{"slos": [...]}`` or a bare list; the
same dict shape feeds ``add_slo``)::

    {"name": "serve_p99", "metric": "ray_tpu_serve_http_p99_s",
     "kind": "threshold", "agg": "avg", "op": "<=", "threshold": 2.0,
     "fast_window_s": 300, "slow_window_s": 3600, "severity": "ERROR"}

    {"name": "serve_5xx", "kind": "ratio",
     "metric": "ray_tpu_serve_http_requests_total",
     "tags": {"code_class": "5xx"},
     "denominator": "ray_tpu_serve_http_requests_total",
     "threshold": 0.05}

``kind: threshold`` aggregates the metric's points over each window and
compares against ``threshold`` with ``op`` (``<=``: objective is "stay
at or below"; ``>=``: a floor).  ``kind: ratio`` takes counter deltas
over each window (numerator tags vs denominator) and burns when the
ratio exceeds the ``threshold`` budget.  A window with insufficient
coverage (fewer than 2 points, or spanning less than ``min_coverage``
of the window) is not evaluable — short-lived clusters never burn their
1h window by accident.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private import events as events_mod
from ray_tpu_torch._private.events import _float_env
from ray_tpu_torch.util import doctor
from ray_tpu_torch.util.incidents import (
    IncidentTable,
    SinkSet,
    prune_bundle_dirs,
    sinks_from_env,
)

logger = logging.getLogger(__name__)

DEFAULT_CADENCE_S = 15.0
DEFAULT_FAST_WINDOW_S = 300.0
DEFAULT_SLOW_WINDOW_S = 3600.0
# fraction of a window that must hold samples before it is evaluable
DEFAULT_MIN_COVERAGE = 0.5
# bundle caps
BUNDLE_MAX_STREAMS = 8
BUNDLE_TAIL_LINES = 200
BUNDLE_MAX_TRACES = 3
BUNDLE_MAX_METRICS = 12
BUNDLE_EVENT_ROWS = 500
BUNDLE_TSDB_WINDOW_S = 1800.0
PROFILE_WINDOW_S = 600.0
# the tick's doctor window (rows and seconds), its resolve and escalation
# rules, its trend window, and how many bundles a session keeps
DOCTOR_WINDOW_ROWS = 20_000
EVENT_WINDOW_S = 600.0
RESOLVE_TICKS = 3
ESCALATE_REOPENS = 3
TREND_WINDOW_S = 1800.0
BUNDLE_KEEP = 20


def cadence_s() -> float:
    return max(0.05, _float_env("RAY_TPU_TORCH_WATCHDOG_S", DEFAULT_CADENCE_S))


# ---------------------------------------------------------------------------
# SLO declaration + burn-rate evaluation
# ---------------------------------------------------------------------------


def make_slo(name: str, metric: str, threshold: float, *,
             kind: str = "threshold", op: str = "<=", agg: str = "avg",
             tags: Optional[Dict[str, str]] = None,
             denominator: Optional[str] = None,
             den_tags: Optional[Dict[str, str]] = None,
             fast_window_s: float = DEFAULT_FAST_WINDOW_S,
             slow_window_s: float = DEFAULT_SLOW_WINDOW_S,
             min_coverage: float = DEFAULT_MIN_COVERAGE,
             severity: str = "ERROR",
             description: str = "") -> dict:
    """Normalize one SLO declaration (raises on an unknown kind/op)."""
    if kind not in ("threshold", "ratio"):
        raise ValueError(f"unknown SLO kind {kind!r}")
    if op not in ("<=", ">="):
        raise ValueError(f"unknown SLO op {op!r} (use '<=' or '>=')")
    return {
        "name": str(name), "metric": str(metric),
        "threshold": float(threshold), "kind": kind, "op": op,
        "agg": agg, "tags": dict(tags or {}),
        "denominator": denominator or str(metric),
        "den_tags": dict(den_tags or {}),
        "fast_window_s": float(fast_window_s),
        "slow_window_s": float(slow_window_s),
        "min_coverage": float(min_coverage),
        "severity": severity, "description": description,
    }


def _series_points(tsdb, metric: str, tags: Optional[Dict[str, str]],
                   window_s: float,
                   now: Optional[float]) -> List[List[Tuple[float, float]]]:
    """Each matching label series' points, separately (cumulative
    counters must delta per series, never across merged series)."""
    try:
        q = tsdb.query(metric, window_s=window_s, step_s=0.0,
                       tags=tags or None, now=now)
    except Exception:  # noqa: BLE001 — metric unknown to the TSDB yet
        return []
    out = []
    for s in q.get("series", ()):
        pts = sorted((ts, v) for ts, v in s.get("points", ())
                     if v is not None)
        if pts:
            out.append(pts)
    return out


def _points(tsdb, metric: str, tags: Optional[Dict[str, str]],
            window_s: float, now: Optional[float]) -> List[Tuple[float,
                                                                 float]]:
    pts = [p for series in _series_points(tsdb, metric, tags, window_s,
                                          now) for p in series]
    pts.sort()
    return pts


def _coverage(pts: Sequence[Tuple[float, float]], window_s: float) -> float:
    if len(pts) < 2:
        return 0.0
    return max(0.0, (pts[-1][0] - pts[0][0]) / max(window_s, 1e-9))


def _counter_delta(pts: Sequence[Tuple[float, float]]) -> float:
    if len(pts) < 2:
        return 0.0
    return max(0.0, pts[-1][1] - pts[0][1])


def _eval_window(slo: dict, tsdb, window_s: float,
                 now: Optional[float]) -> dict:
    """One window's verdict: ``{"value", "breach", "coverage",
    "evaluable"}``."""
    out = {"window_s": window_s, "value": None, "breach": False,
           "coverage": 0.0, "evaluable": False}
    if slo["kind"] == "ratio":
        num = _series_points(tsdb, slo["metric"], slo["tags"], window_s,
                             now)
        den = _series_points(tsdb, slo["denominator"], slo["den_tags"],
                             window_s, now)
        den_flat = sorted(p for series in den for p in series)
        out["coverage"] = round(_coverage(den_flat, window_s), 3)
        d_den = sum(_counter_delta(s) for s in den)
        if d_den <= 0 or out["coverage"] < slo["min_coverage"]:
            return out
        ratio = sum(_counter_delta(s) for s in num) / d_den
        out.update(value=round(ratio, 6), evaluable=True,
                   breach=ratio > slo["threshold"])
        return out
    pts = _points(tsdb, slo["metric"], slo["tags"], window_s, now)
    out["coverage"] = round(_coverage(pts, window_s), 3)
    if out["coverage"] < slo["min_coverage"]:
        return out
    vals = [v for _, v in pts]
    agg = slo["agg"]
    if agg == "last":
        value = vals[-1]
    elif agg == "max":
        value = max(vals)
    elif agg == "min":
        value = min(vals)
    else:
        value = sum(vals) / len(vals)
    breach = value > slo["threshold"] if slo["op"] == "<=" \
        else value < slo["threshold"]
    out.update(value=round(value, 6), evaluable=True, breach=breach)
    return out


def evaluate_slo(slo: dict, tsdb, now: Optional[float] = None) -> dict:
    """Multi-window burn-rate verdict: burning iff the fast AND slow
    windows are both evaluable and both breach."""
    fast = _eval_window(slo, tsdb, slo["fast_window_s"], now)
    slow = _eval_window(slo, tsdb, slo["slow_window_s"], now)
    return {"name": slo["name"], "fast": fast, "slow": slow,
            "burning": bool(fast["breach"] and slow["breach"]
                            and fast["evaluable"] and slow["evaluable"])}


def default_slos() -> List[dict]:
    """The wellknown objectives for the numbers the benches gate.  Each
    only ever burns once its metric actually carries enough data to
    cover both windows — declaring them on an idle cluster is free."""
    return [
        make_slo("serve_p99", "ray_tpu_serve_http_p99_s", 2.0,
                 op="<=", agg="avg", severity="ERROR",
                 description="serve HTTP p99 stays at or under 2s"),
        make_slo("serve_5xx", "ray_tpu_serve_http_requests_total", 0.05,
                 kind="ratio", tags={"code_class": "5xx"},
                 severity="ERROR",
                 description="serve 5xx share of requests under 5%"),
        make_slo("mfu_floor", "ray_tpu_train_step_mfu", 0.05,
                 op=">=", agg="avg", severity="WARNING",
                 description="training MFU holds above the floor"),
        make_slo("ingest_floor", "ray_tpu_train_ingest_gbps", 0.1,
                 op=">=", agg="avg", severity="WARNING",
                 description="train ingest throughput holds above the "
                             "floor"),
        make_slo("queue_drain", "ray_tpu_sched_queue_depth", 5000.0,
                 op="<=", agg="avg", severity="WARNING",
                 description="the scheduler queue drains (sustained "
                             "depth stays bounded)"),
    ]


def load_slos_file(path: str) -> List[dict]:
    """Parse an ``slos.json`` (``{"slos": [...]}`` or a bare list) into
    normalized declarations; bad entries are skipped with a log line,
    not fatal — one typo must not take the watchdog down."""
    with open(path) as f:
        raw = json.load(f)
    if isinstance(raw, dict):
        raw = raw.get("slos", [])
    out = []
    for entry in raw:
        try:
            out.append(make_slo(**entry))
        except Exception as e:  # noqa: BLE001 — bad declaration
            logger.warning("skipping bad SLO %r: %s", entry, e)
    return out


def _burn_finding(slo: dict, ev: dict) -> dict:
    fast, slow = ev["fast"], ev["slow"]
    return {
        "rule": f"slo:{slo['name']}", "severity": slo["severity"],
        "entity": slo["name"], "slo": True, "metric": slo["metric"],
        "summary": (
            f"SLO {slo['name']} burning: {slo['metric']} "
            f"fast({int(slo['fast_window_s'])}s)={fast['value']} and "
            f"slow({int(slo['slow_window_s'])}s)={slow['value']} both "
            f"breach {slo['op']} {slo['threshold']}"),
        "remedy": slo["description"] or (
            "both burn-rate windows breach the declared objective — "
            "check the metric's TSDB slice in the incident bundle"),
        "count": 1,
        "evidence": [{"metric": slo["metric"], "fast": fast,
                      "slow": slow, "threshold": slo["threshold"]}],
    }


# ---------------------------------------------------------------------------
# the watchdog itself
# ---------------------------------------------------------------------------


class Watchdog:
    """Head-side evaluation loop.  ``tick()`` is synchronous and
    idempotent — the loop thread calls it on cadence; tests and the
    bench probe call it directly."""

    def __init__(self, node, cadence: Optional[float] = None,
                 sinks: Optional[SinkSet] = None,
                 capture_bundles: bool = True,
                 event_window_s: float = EVENT_WINDOW_S,
                 resolve_ticks: int = RESOLVE_TICKS):
        self._node = node
        self.cadence_s = cadence if cadence is not None else cadence_s()
        self._doctor = doctor.DoctorState(
            window_rows=DOCTOR_WINDOW_ROWS, event_window_s=event_window_s)
        self.incidents = IncidentTable(
            resolve_ticks=resolve_ticks, escalate_reopens=ESCALATE_REOPENS)
        self.sinks = sinks if sinks is not None else SinkSet(
            sinks_from_env())
        self._capture_bundles = capture_bundles
        self._bundle_keep = BUNDLE_KEEP
        self._trend_window_s = TREND_WINDOW_S
        self._lock = threading.Lock()
        self._slos: List[dict] = []
        self._slo_state: Dict[str, dict] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ticks = 0
        self._last_tick_s = 0.0
        self._total_tick_s = 0.0
        self._load_slos()

    # -- SLO registry ---------------------------------------------------
    def _load_slos(self) -> None:
        slos = default_slos()
        path = os.environ.get("RAY_TPU_TORCH_SLOS", "").strip() or (
            "slos.json" if os.path.exists("slos.json") else "")
        if path:
            try:
                declared = load_slos_file(path)
            except Exception as e:  # noqa: BLE001 — unreadable file
                logger.warning("could not load SLOs from %s: %s", path, e)
            else:
                # declared objectives override same-name defaults
                names = {s["name"] for s in declared}
                slos = [s for s in slos if s["name"] not in names]
                slos.extend(declared)
        with self._lock:
            self._slos = slos

    def add_slo(self, name: str, metric: str, threshold: float,
                **kwargs) -> dict:
        slo = make_slo(name, metric, threshold, **kwargs)
        with self._lock:
            self._slos = [s for s in self._slos if s["name"] != name]
            self._slos.append(slo)
        return slo

    def remove_slo(self, name: str) -> bool:
        with self._lock:
            before = len(self._slos)
            self._slos = [s for s in self._slos if s["name"] != name]
            return len(self._slos) != before

    def slos(self) -> List[dict]:
        """Declared SLOs with their latest evaluation folded in (the
        ``list_slos`` table body)."""
        with self._lock:
            slos = [dict(s) for s in self._slos]
            state = dict(self._slo_state)
        for s in slos:
            ev = state.get(s["name"])
            if ev:
                s["burning"] = ev["burning"]
                s["fast"] = ev["fast"]
                s["slow"] = ev["slow"]
            else:
                s["burning"] = False
        return slos

    # -- tick -----------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> List[Tuple[dict, str]]:
        """One evaluation pass; returns the incident transitions it
        produced.  Head-local by construction: event-cursor deltas, the
        gcs task table, and direct TSDB queries — zero state-API RPCs.  The
        head's own events are read from its session's part of the process
        ring (``node._session_ring``), as its doctor reads them."""
        t0 = time.perf_counter()
        if now is None:
            now = time.time()
        node = self._node
        self._doctor.feed(table=node.events, local=node._session_ring)
        tasks = self._task_rows()
        findings = self._doctor.diagnose(tasks, now=now)
        series_map: Dict[str, list] = {}
        for name in doctor.TREND_METRICS:
            try:
                q = node.tsdb.query(name, window_s=self._trend_window_s)
                series_map[name] = q.get("series", [])
            except Exception:  # noqa: BLE001 — no samples yet
                continue
        findings = findings + doctor.diagnose_trends(series_map)
        burns = []
        with self._lock:
            slos = list(self._slos)
        for slo in slos:
            ev = evaluate_slo(slo, node.tsdb, now=now)
            with self._lock:
                self._slo_state[slo["name"]] = ev
            if ev["burning"]:
                burns.append(_burn_finding(slo, ev))
        transitions = self.incidents.observe(findings + burns, now=now)
        for inc, tr in transitions:
            self._publish(inc, tr, now)
            if tr in ("open", "reopen") and self._capture_bundles:
                try:
                    path = self.capture_bundle(inc)
                    self.incidents.set_bundle_dir(inc["id"], path)
                except Exception:  # noqa: BLE001 — the bundle is
                    # best-effort evidence; capture failure must not
                    # break the lifecycle
                    logger.exception("bundle capture failed for %s",
                                     inc["id"])
        dt = time.perf_counter() - t0
        with self._lock:
            self._ticks += 1
            self._last_tick_s = dt
            self._total_tick_s += dt
        return transitions

    def _task_rows(self, limit: int = 5000) -> List[dict]:
        try:
            rows, _total = self._node._list_state_page("tasks", limit)
            return rows
        except Exception:  # noqa: BLE001 — table shape drift must not
            # kill the tick; event rules still run
            return []

    def _publish(self, inc: dict, transition: str, now: float) -> None:
        sev = inc["severity"] if transition != "resolve" else "INFO"
        if events_mod.ENABLED:
            events_mod.emit(
                "incident", f"incident {transition}", severity=sev,
                entity_id=inc["id"], rule=inc["rule"],
                entity=inc["entity"], transition=transition,
                reopen_count=inc["reopen_count"],
                summary=inc["summary"][:200])
        self.sinks.push({
            "transition": transition, "ts": now,
            "incident": {k: inc[k] for k in
                         ("id", "rule", "entity", "severity", "summary",
                          "remedy", "state", "opened_at", "reopen_count",
                          "escalated")}})

    def ack(self, iid: str) -> Optional[dict]:
        snap = self.incidents.ack(iid)
        if snap is not None:
            self._publish(snap, "ack", time.time())
        return snap

    # -- post-mortem bundles --------------------------------------------
    @property
    def bundle_root(self) -> str:
        return os.path.join(self._node.session_dir, "incidents")

    def capture_bundle(self, incident: dict,
                       root: Optional[str] = None) -> str:
        """Freeze the evidence for one incident to disk before the
        bounded rings decay it.  Returns the bundle directory."""
        node = self._node
        base = root or self.bundle_root
        bdir = os.path.join(base, incident["id"])
        os.makedirs(os.path.join(bdir, "logs"), exist_ok=True)
        os.makedirs(os.path.join(bdir, "tsdb"), exist_ok=True)
        self._write_json(bdir, "incident.json", incident)
        rows, _ = node.events.list_with_total(limit=BUNDLE_EVENT_ROWS)
        rows = rows + node._session_ring.since(0)[-(BUNDLE_EVENT_ROWS // 2):]
        rows.sort(key=lambda r: r.get("ts", 0.0))
        self._write_json(bdir, "events.json", rows[-BUNDLE_EVENT_ROWS:])
        for stream in self._implicated_streams(incident):
            tail = node.log_store.tail_text(stream, n=BUNDLE_TAIL_LINES)
            if not tail:
                continue
            safe = "".join(c if (c.isalnum() or c in "._-") else "_"
                           for c in stream)
            with open(os.path.join(bdir, "logs", safe + ".txt"), "w",
                      errors="replace") as f:
                f.write("\n".join(tail) + "\n")
        tids = self._implicated_traces(incident)
        for tid in tids:
            try:
                trace = node._get_trace(tid)
            except Exception:  # noqa: BLE001
                trace = None
            if trace:
                self._write_json(bdir, f"trace-{tid[:24]}.json", trace)
        try:
            # recent trace summaries ride along even without explicit
            # trace ids in the evidence: the requests in flight around
            # the incident are usually the implicated ones
            node._fold_local_traces()
            recent = node.traces.list(20)
            if recent:
                self._write_json(bdir, "traces.json", recent)
                if not tids and recent:
                    t = node._get_trace(recent[-1]["trace_id"])
                    if t:
                        self._write_json(
                            bdir,
                            f"trace-{recent[-1]['trace_id'][:24]}.json", t)
        except Exception:  # noqa: BLE001
            pass
        for metric, tags in self._bundle_metrics(incident):
            try:
                q = node.tsdb.query(metric, window_s=BUNDLE_TSDB_WINDOW_S,
                                    tags=tags or None)
            except Exception:  # noqa: BLE001
                continue
            if q.get("series"):
                self._write_json(bdir, os.path.join("tsdb",
                                                    metric + ".json"), q)
        try:
            collapsed = node.profile_store.collapsed(PROFILE_WINDOW_S)
            if collapsed:
                with open(os.path.join(bdir, "profile_collapsed.txt"),
                          "w") as f:
                    f.write(collapsed + "\n")
        except Exception:  # noqa: BLE001
            pass
        try:
            self._write_json(bdir, "memory.json",
                             node._memory_audit(limit=200))
        except Exception:  # noqa: BLE001
            pass
        prune_bundle_dirs(base, self._bundle_keep)
        return bdir

    def _implicated_streams(self, incident: dict) -> List[str]:
        """Log streams worth freezing: anything the evidence names, plus
        recently retired streams (a SIGKILL'd worker's death tail is the
        single most valuable line in the bundle), capped."""
        needles = {str(incident.get("entity", ""))}
        for ev in incident.get("evidence", ()):
            if isinstance(ev, dict):
                for key in ("entity_id", "origin", "stream", "pid"):
                    v = ev.get(key)
                    if v:
                        needles.add(str(v))
                data = ev.get("data")
                if isinstance(data, dict):
                    for key in ("stream", "worker_id", "entity_id"):
                        if data.get(key):
                            needles.add(str(data[key]))
        needles.discard("")
        dump_all = incident.get("rule") == "debug_dump"
        out: List[str] = []
        retired: List[str] = []
        rest: List[str] = []
        for row in self._node.log_store.stats():
            name = row["stream"]
            if any(n in name for n in needles):
                out.append(name)
            elif row.get("retired"):
                retired.append(name)
            elif dump_all:
                rest.append(name)
        for name in retired + rest:
            if len(out) >= (16 if dump_all else BUNDLE_MAX_STREAMS):
                break
            if name not in out:
                out.append(name)
        return out[:16 if dump_all else BUNDLE_MAX_STREAMS]

    @staticmethod
    def _implicated_traces(incident: dict) -> List[str]:
        tids: List[str] = []
        for ev in incident.get("evidence", ()):
            if not isinstance(ev, dict):
                continue
            data = ev.get("data") if isinstance(ev.get("data"), dict) \
                else {}
            for src in (ev, data):
                tid = src.get("trace_id")
                if tid and tid not in tids:
                    tids.append(str(tid))
        return tids[:BUNDLE_MAX_TRACES]

    def _bundle_metrics(self, incident: dict) -> List[Tuple[str,
                                                            Dict[str,
                                                                 str]]]:
        """TSDB slices to freeze: the incident's own metric (an SLO
        burn), every declared SLO's metric, and the queue-depth trend —
        capped and deduped."""
        out: List[Tuple[str, Dict[str, str]]] = []
        seen = set()

        def _add(metric: Optional[str], tags: Optional[dict] = None):
            if metric and metric not in seen and \
                    len(out) < BUNDLE_MAX_METRICS:
                seen.add(metric)
                out.append((metric, dict(tags or {})))

        _add(incident.get("metric"))
        for slo in self.slos():
            _add(slo["metric"], slo.get("tags"))
        _add("ray_tpu_sched_queue_depth")
        _add("ray_tpu_proc_rss_mb")
        return out

    def debug_dump(self, label: Optional[str] = None) -> str:
        """One-shot whole-cluster bundle (``ray_tpu_torch debug dump``)."""
        name = label or f"dump-{int(time.time())}"
        pseudo = {"id": name, "rule": "debug_dump", "entity": "cluster",
                  "severity": "INFO", "state": "dump",
                  "summary": "on-demand debug dump", "evidence": [],
                  "metric": None}
        return self.capture_bundle(pseudo)

    @staticmethod
    def _write_json(bdir: str, rel: str, obj: Any) -> None:
        with open(os.path.join(bdir, rel), "w") as f:
            json.dump(obj, f, indent=1, default=str)

    # -- loop + stats ---------------------------------------------------
    def start(self) -> threading.Thread:
        t = threading.Thread(target=self._loop, name="watchdog",
                             daemon=True)
        self._thread = t
        t.start()
        return t

    def _loop(self) -> None:
        while not self._stop.wait(self.cadence_s):
            if getattr(self._node, "_shutdown", False):
                return
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the watchdog must never
                # take the head down; next tick retries
                logger.exception("watchdog tick failed")

    def stop(self) -> None:
        self._stop.set()
        self.sinks.stop()

    def stats(self) -> dict:
        with self._lock:
            ticks = self._ticks
            last = self._last_tick_s
            avg = self._total_tick_s / ticks if ticks else 0.0
        return {"ticks": ticks, "cadence_s": self.cadence_s,
                "last_tick_ms": round(last * 1e3, 3),
                "avg_tick_ms": round(avg * 1e3, 3),
                "overhead_frac": round(avg / self.cadence_s, 6)
                if self.cadence_s else 0.0,
                "doctor_window_rows": self._doctor.window_len(),
                "incidents": self.incidents.counts(),
                "sinks": self.sinks.stats()}
