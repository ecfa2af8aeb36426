"""Application + runtime metrics (Counter/Gauge/Histogram).

Analog of ``ray.util.metrics`` (``python/ray/util/metrics.py``) over the
reference's OpenCensus pipeline (``src/ray/stats/metric.h:103-206``).
Every process keeps a local registry, readable as a snapshot or in
Prometheus text exposition format (``prometheus_text``).  The JAX
package's push of worker snapshots to the head, its merged ``/metrics``
and its time-series store are left out of the port's runtime core.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.locks import make_lock

LabelKey = Tuple[Tuple[str, str], ...]


class _Registry:
    def __init__(self):
        self.lock = make_lock("metrics.registry")
        # name -> {"type", "help", "values": {labelkey: value-or-histogram}}
        self.metrics: Dict[str, dict] = {}

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


