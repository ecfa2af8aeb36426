"""Application + runtime metrics (Counter/Gauge/Histogram).

Analog of ``ray.util.metrics`` (``python/ray/util/metrics.py``) over the
reference's OpenCensus pipeline (``src/ray/stats/metric.h:103-206``,
exported through the node metrics agent to Prometheus).  Every process
keeps a local registry, readable as a snapshot or in Prometheus text
exposition format (``prometheus_text``).  Workers and node agents ship
periodic snapshots to the head over their control connection
(``MetricsPusher``, every ``RAY_TPU_TORCH_METRICS_PUSH_S`` seconds); the
head merges them per origin (``_Registry.merge``, expired by
``expire_origins``) and folds them into its time-series store
(``util/tsdb.py``), which ``query_metric``, ``top``, ``perf`` and
``doctor`` read.  The head serves no HTTP ``/metrics`` endpoint.
"""

from __future__ import annotations

import bisect
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.locks import make_lock

LabelKey = Tuple[Tuple[str, str], ...]


class _Registry:
    def __init__(self):
        self.lock = make_lock("metrics.registry")
        # name -> {"type", "help", "values": {labelkey: value-or-histogram}}
        self.metrics: Dict[str, dict] = {}
        # origin -> last merge wall time: dead origins (a worker that
        # exited, a node that left) stop refreshing and get expired by
        # expire_origins instead of polluting the merged view forever
        self.origin_seen: Dict[str, float] = {}
        # origin -> {metric name -> full label keys it last pushed}: the
        # replacement-merge and expiry index, so both touch only the
        # origin's OWN series (never a rebuild of the cross-origin dict)
        self.origin_keys: Dict[str, Dict[str, set]] = {}

    def register(self, name: str, mtype: str, help_: str) -> dict:
        with self.lock:
            m = self.metrics.setdefault(
                name, {"type": mtype, "help": help_, "values": {}}
            )
            if m["type"] != mtype:
                raise ValueError(f"metric {name} already registered as {m['type']}")
            return m

    def snapshot(self) -> Dict[str, dict]:
        with self.lock:
            return {
                name: {"type": m["type"], "help": m["help"],
                       "values": dict(m["values"])}
                for name, m in self.metrics.items()
            }

    def merge(self, origin: str, snap: Dict[str, dict]) -> None:
        """Fold a remote process's snapshot in, labeled by origin.

        REPLACEMENT semantics per (origin, metric): each push carries the
        origin's complete current value set for every metric it reports,
        so label series absent from this push no longer exist at the
        origin (a dead worker pid in a node agent's per-process gauges, a
        series retired via ``Metric.remove``) and must leave the merged
        view — accumulate-only merging kept them forever.  The
        ``origin_keys`` index makes the replacement O(this origin's
        series), not a rebuild of every origin's values."""
        origin_tag = ("origin", origin)
        with self.lock:
            self.origin_seen[origin] = time.time()
            prev = self.origin_keys.setdefault(origin, {})
            for name, m in snap.items():
                cur = self.metrics.setdefault(
                    name, {"type": m["type"], "help": m["help"], "values": {}}
                )
                vals = cur["values"]
                new_keys = set()
                for key, value in m["values"].items():
                    fk = tuple(key) + (origin_tag,)
                    vals[fk] = value
                    new_keys.add(fk)
                for fk in prev.get(name, set()) - new_keys:
                    vals.pop(fk, None)
                prev[name] = new_keys

    def expire_origins(self, max_age_s: float,
                       now: Optional[float] = None) -> List[str]:
        """Drop every merged label series whose origin has not pushed
        within ``max_age_s`` (3 push intervals at the head).  Without
        this, merge() keeps dead workers'/nodes' series forever and the
        merged registry grows monotonically with churn."""
        if now is None:
            now = time.time()
        with self.lock:
            stale = {o for o, ts in self.origin_seen.items()
                     if now - ts > max_age_s}
            if not stale:
                return []
            for o in stale:
                for name, keys in self.origin_keys.pop(o, {}).items():
                    m = self.metrics.get(name)
                    if m is None:
                        continue
                    for fk in keys:
                        m["values"].pop(fk, None)
                del self.origin_seen[o]
            return sorted(stale)


_global = _Registry()


def _labelkey(tags: Optional[Dict[str, str]]) -> LabelKey:
    return tuple(sorted((tags or {}).items()))


class Metric:
    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Tuple[str, ...]] = None):
        self._name = name
        self._tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._m = _global.register(name, self._TYPE, description)

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]) -> LabelKey:
        merged = dict(self._default_tags)
        merged.update(tags or {})
        return _labelkey(merged)

    def remove(self, tags: Optional[Dict[str, str]] = None) -> bool:
        """Retire one label series (e.g. a per-worker gauge after that
        worker dies) without restarting the process.  Returns whether the
        series existed."""
        key = self._key(tags)
        with _global.lock:
            return self._m["values"].pop(key, None) is not None

    def label_sets(self) -> List[Dict[str, str]]:
        """The live label sets of this metric (samplers diff this against
        what they just observed to find series to retire)."""
        with _global.lock:
            return [dict(key) for key in self._m["values"]]


class Counter(Metric):
    _TYPE = "counter"

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError(
                f"Counter.inc() takes a non-negative value, got {value} "
                "(counters are monotone; use a Gauge for values that fall)")
        key = self._key(tags)
        with _global.lock:
            vals = self._m["values"]
            vals[key] = vals.get(key, 0.0) + value


class Gauge(Metric):
    _TYPE = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None) -> None:
        with _global.lock:
            self._m["values"][self._key(tags)] = float(value)


DEFAULT_BOUNDARIES = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 60)


class Histogram(Metric):
    _TYPE = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[List[float]] = None,
                 tag_keys: Optional[Tuple[str, ...]] = None):
        self.boundaries = tuple(boundaries or DEFAULT_BOUNDARIES)
        super().__init__(name, description, tag_keys)

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None) -> None:
        key = self._key(tags)
        with _global.lock:
            vals = self._m["values"]
            h = vals.get(key)
            if h is None:
                h = {"buckets": [0] * (len(self.boundaries) + 1),
                     "bounds": self.boundaries, "sum": 0.0, "count": 0}
                vals[key] = h
            h["buckets"][bisect.bisect_left(self.boundaries, value)] += 1
            h["sum"] += value
            h["count"] += 1


def registry() -> _Registry:
    return _global


def merge_snapshots(*snaps: Dict[str, dict]) -> Dict[str, dict]:
    """Combine registry snapshots (head + worker-reported) for exposition."""
    out: Dict[str, dict] = {}
    for snap in snaps:
        for name, m in snap.items():
            cur = out.setdefault(
                name, {"type": m["type"], "help": m["help"], "values": {}}
            )
            cur["values"].update(m["values"])
    return out


def _escape_label_value(v) -> str:
    """Prometheus exposition escaping for label values: backslash, double
    quote, and newline must be escaped or a crafted value (e.g. a
    user-chosen deployment name) corrupts the whole scrape."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def prometheus_text(snap: Optional[Dict[str, dict]] = None) -> str:
    """Render a registry snapshot in Prometheus exposition format (the
    ``prometheus_exporter.py`` analog)."""
    snap = snap if snap is not None else _global.snapshot()
    out: List[str] = []
    for name, m in sorted(snap.items()):
        if m["help"]:
            out.append(f"# HELP {name} {m['help']}")
        out.append(f"# TYPE {name} {m['type']}")
        for key, value in sorted(m["values"].items()):
            labels = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key)
            suffix = f"{{{labels}}}" if labels else ""
            if m["type"] == "histogram" and isinstance(value, dict):
                acc = 0
                for bound, cnt in zip(list(value["bounds"]) + ["+Inf"], value["buckets"]):
                    acc += cnt
                    lb = (labels + "," if labels else "") + f'le="{bound}"'
                    out.append(f"{name}_bucket{{{lb}}} {acc}")
                out.append(f"{name}_sum{suffix} {value['sum']}")
                out.append(f"{name}_count{suffix} {value['count']}")
            else:
                out.append(f"{name}{suffix} {value}")
    return "\n".join(out) + "\n"


def push_interval_s() -> float:
    """The cluster-wide metrics push cadence (workers, node agents, and
    the head's self-sample loop all tick at this; the head's TSDB and its
    origin-expiry windows are sized from it)."""
    try:
        return max(0.05, float(os.environ.get("RAY_TPU_TORCH_METRICS_PUSH_S", "5")))
    except ValueError:
        return 5.0


def grid_ticks(interval_s: float, wait_fn):
    """Deadline-grid ticker shared by every sampling/push loop (this
    pusher, the node agent's resource sampler, the head's TSDB loop).

    Ticks are scheduled on a fixed grid (next = start + k*interval), not
    ``interval`` after the previous body finished: sleep-after-work
    drifts by the body's duration, and the TSDB's downsampling assumes
    uniform sample spacing.  Grid points the body overran are skipped
    (no burst catch-up; the grid phase is preserved).

    ``wait_fn(timeout) -> truthy`` ends the loop (an ``Event.wait``, or
    a sleep returning a shutdown flag).  Yields ``stalled``: True when
    the previous tick was delayed by more than one extra interval —
    loops that expire peers by timestamp must skip expiry on such a
    tick, because a stall of THIS process delays everyone's timestamps
    equally and would read every live peer as dead."""
    next_tick = time.monotonic() + interval_s
    last = time.monotonic()
    while True:
        if wait_fn(max(0.0, next_tick - time.monotonic())):
            return
        now = time.monotonic()
        next_tick += interval_s
        if next_tick <= now:  # body overran: skip to the next future
            next_tick = now + interval_s - ((now - next_tick) % interval_s)
        stalled = now - last > 2 * interval_s
        last = now
        yield stalled


class MetricsPusher:
    """Background thread shipping this process's registry to the head
    (the per-node metrics-agent push path).

    Ticks ride the shared deadline grid (:func:`grid_ticks`) so the
    sample spacing the head's TSDB assumes stays uniform under slow
    sends.  A failed send is simply retried at the NEXT grid tick — one
    small send per interval costs nothing, and any longer backoff would
    open a gap wider than the head's 3-interval origin-expiry window,
    letting a single transient failure pass for this process's death
    (wiping its series from the merged view and its TSDB history).  The loop
    only exits when :meth:`stop` is called or ``closed_fn`` reports the
    client closed."""

    def __init__(self, send_fn, origin: str, interval_s: Optional[float] = None,
                 closed_fn=None):
        self._send = send_fn
        self._origin = origin
        self._interval = interval_s if interval_s is not None \
            else push_interval_s()
        self._closed = closed_fn
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="metrics-pusher")

    def start(self) -> "MetricsPusher":
        self._thread.start()
        return self

    def _loop(self) -> None:
        for _ in grid_ticks(self._interval, self._stop.wait):
            if self._closed is not None and self._closed():
                return
            snap = _global.snapshot()
            if not snap:
                continue
            try:
                self._send({"type": "metrics_report", "origin": self._origin,
                            "metrics": snap})
            except Exception:
                pass  # retried at the next grid tick (see class docstring)

    def stop(self) -> None:
        self._stop.set()
