"""Head-side metrics TSDB: bounded in-memory time series with staged
downsampling.

The metric registry (``util/metrics.py``) is a point-in-time snapshot
store — it can answer "what is the queue depth" but not "has the queue
depth been climbing for ten minutes", which is the question every leak,
creeping RSS, and slowly saturating router poses.  This module keeps the
trend: the head folds every registry snapshot that arrives over the
``metrics_report`` path (workers, node agents, its own self-sample loop)
into per-series ring buffers, Monarch-style — bounded in-memory storage,
staged resolution decay instead of unbounded growth:

- **raw**   ~5 s samples, ring of ``raw_points`` (default 1 h of history)
- **1 min** downsampled buckets, ring of ``m1_points`` (default 6 h)
- **10 min** downsampled buckets, ring of ``m10_points`` (default 28 h)

Each downsample bucket keeps ``(last, max, sum, count)`` so a query can
pick the aggregation that matches the metric's semantics — ``last`` for
cumulative counters, ``last``/``max`` for gauges, ``sum`` for per-bucket
deltas — without re-reading raw data that no longer exists.  Histograms
ingest as two cumulative scalar series, ``<name>_count`` and
``<name>_sum`` (rates and means are derivable; full bucket vectors would
multiply storage by the bucket count for little trend value).

Bounded three ways: fixed ring lengths per series, a total byte cap that
evicts least-recently-updated series first, and per-origin expiry so a
dead node's or worker's series stop occupying the store (the registry
analog of this fix lives in ``_Registry.expire_origins``).
"""

from __future__ import annotations

import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.locks import make_lock

LabelKey = Tuple[Tuple[str, str], ...]

# stage ring lengths: 1h raw @5s, 6h of 1-min buckets, 28h of 10-min
# (constants where the JAX module reads environment knobs: ROADMAP,
# "Cut from the port")
DEFAULT_RAW_POINTS = 720
DEFAULT_M1_POINTS = 360
DEFAULT_M10_POINTS = 168
# total-store byte cap; least-recently-updated series evict first
DEFAULT_MAX_BYTES = 64 << 20
# origins not refreshed within this many push intervals expire
ORIGIN_EXPIRY_INTERVALS = 3

# byte-cost model for the cap (measured: a (float, float) tuple in a
# deque costs ~120 B; a 4-float bucket tuple ~180 B; per-series dict +
# key overhead ~600 B).  An estimate is enough — the cap bounds the
# order of magnitude, not the malloc.
_RAW_POINT_COST = 120
_BUCKET_COST = 180
_SERIES_OVERHEAD = 600

_AGGS = ("last", "max", "min", "sum", "avg", "count")


class _Series:
    """One (metric, labelset) stream across the three stages."""

    __slots__ = ("mtype", "origin", "last_ts", "raw", "m1", "m10",
                 "_cur1", "_cur10")

    def __init__(self, mtype: str, origin: str,
                 raw_points: int, m1_points: int, m10_points: int):
        self.mtype = mtype
        self.origin = origin
        self.last_ts = 0.0
        self.raw: deque = deque(maxlen=raw_points)      # (ts, value)
        self.m1: deque = deque(maxlen=m1_points)        # (ts, last, mx, mn, sm, n)
        self.m10: deque = deque(maxlen=m10_points)
        self._cur1: Optional[list] = None   # [bucket_id, last, mx, mn, sm, n]
        self._cur10: Optional[list] = None

    def add(self, ts: float, value: float) -> None:
        self.last_ts = ts
        self.raw.append((ts, value))
        self._roll(ts, value, 60.0, "_cur1", self.m1)
        self._roll(ts, value, 600.0, "_cur10", self.m10)

    def _roll(self, ts: float, value: float, width: float,
              cur_attr: str, ring: deque) -> None:
        bucket = int(ts // width)
        cur = getattr(self, cur_attr)
        if cur is None or cur[0] != bucket:
            if cur is not None:
                # finalize the closed bucket, stamped at its end time
                ring.append(((cur[0] + 1) * width,
                             cur[1], cur[2], cur[3], cur[4], cur[5]))
            setattr(self, cur_attr, [bucket, value, value, value, value, 1])
        else:
            cur[1] = value
            cur[2] = max(cur[2], value)
            cur[3] = min(cur[3], value)
            cur[4] += value
            cur[5] += 1

    def bytes_estimate(self) -> int:
        return (_SERIES_OVERHEAD + len(self.raw) * _RAW_POINT_COST
                + (len(self.m1) + len(self.m10)) * _BUCKET_COST)

    def _stage_points(self, step_s: float, start: float):
        """Points as (ts, last, max, min, sum, count) from the finest
        stage that both resolves ``step_s`` AND reaches back to
        ``start``.  Resolution alone is not enough: the raw ring holds
        ~1 h, so a 24 h query at a 5 s step must escalate to the
        minute/10-minute rings (whose whole purpose is covering windows
        the raw ring can't) instead of silently returning the last hour
        as if it were the full window."""
        stages = []  # (points, ring ever evicted) fine -> coarse
        if step_s < 60.0:
            stages.append(([(ts, v, v, v, v, 1) for ts, v in self.raw],
                           len(self.raw) == self.raw.maxlen))
        if step_s < 600.0:
            pts = list(self.m1)
            if self._cur1 is not None:
                c = self._cur1
                pts.append((self.last_ts, c[1], c[2], c[3], c[4], c[5]))
            stages.append((pts, len(self.m1) == self.m1.maxlen))
        pts = list(self.m10)
        if self._cur10 is not None:
            c = self._cur10
            pts.append((self.last_ts, c[1], c[2], c[3], c[4], c[5]))
        stages.append((pts, len(self.m10) == self.m10.maxlen))
        for pts, evicted in stages:
            # a stage covers the window when its oldest retained point
            # predates the start, or its ring never evicted anything —
            # then nothing older ever existed and coarser stages know
            # no more
            if pts and (not evicted or pts[0][0] <= start):
                return pts
        for pts, _ in stages:  # nothing reaches start: finest non-empty
            if pts:
                return pts
        return []


def _default_agg(mtype: str) -> str:
    # counters are cumulative — the newest value in a bin carries the
    # whole story; gauges too (max/min stay available explicitly)
    return "last"


class TimeSeriesStore:
    """Bounded multi-stage time-series store for registry snapshots."""

    def __init__(self, max_bytes: int = DEFAULT_MAX_BYTES,
                 raw_points: int = DEFAULT_RAW_POINTS,
                 m1_points: int = DEFAULT_M1_POINTS,
                 m10_points: int = DEFAULT_M10_POINTS):
        self._lock = make_lock("tsdb.store")
        self._max_bytes = int(max_bytes)
        self._raw_points = int(raw_points)
        self._m1_points = int(m1_points)
        self._m10_points = int(m10_points)
        # (name, labelkey) -> _Series; ordered by last update (LRU evict)
        self._series: "OrderedDict[Tuple[str, LabelKey], _Series]" = OrderedDict()
        # name -> (type, help) directory (survives series eviction)
        self._meta: Dict[str, Tuple[str, str]] = {}
        self._origin_seen: Dict[str, float] = {}
        self._est_bytes = 0
        self._evicted_series = 0

    # -- ingest --------------------------------------------------------
    def ingest(self, origin: str, snap: Dict[str, dict],
               ts: Optional[float] = None) -> None:
        """Fold one registry snapshot in, tagging every series with its
        origin (worker id, node id, or "head") exactly like
        ``_Registry.merge`` does for the exposition path."""
        if ts is None:
            ts = time.time()
        with self._lock:
            self._origin_seen[origin] = ts
            for name, m in snap.items():
                mtype = m.get("type", "gauge")
                help_ = m.get("help", "")
                if m.get("values") and mtype != "histogram":
                    self._meta.setdefault(name, (mtype, help_))
                for key, value in m.get("values", {}).items():
                    key = tuple(key)
                    if not any(k == "origin" for k, _ in key):
                        key = key + (("origin", origin),)
                    if mtype == "histogram" and isinstance(value, dict):
                        self._meta.setdefault(
                            name + "_count", ("counter", help_))
                        self._meta.setdefault(
                            name + "_sum", ("counter", help_))
                        self._add_locked(name + "_count", key, "counter",
                                         origin, ts, float(value["count"]))
                        self._add_locked(name + "_sum", key, "counter",
                                         origin, ts, float(value["sum"]))
                    elif isinstance(value, (int, float)):
                        self._add_locked(name, key, mtype, origin, ts,
                                         float(value))
            self._enforce_cap_locked()

    def add_sample(self, name: str, value: float,
                   tags: Optional[Dict[str, str]] = None,
                   mtype: str = "gauge", origin: str = "head",
                   ts: Optional[float] = None) -> None:
        """Direct single-sample ingest (synthetic series in tests/bench)."""
        if ts is None:
            ts = time.time()
        key = tuple(sorted((tags or {}).items()))
        if not any(k == "origin" for k, _ in key):
            key = key + (("origin", origin),)
        with self._lock:
            self._origin_seen[origin] = max(
                self._origin_seen.get(origin, 0.0), ts)
            self._meta.setdefault(name, (mtype, ""))
            self._add_locked(name, key, mtype, origin, ts, float(value))
            self._enforce_cap_locked()

    def _add_locked(self, name: str, key: LabelKey, mtype: str,
                    origin: str, ts: float, value: float) -> None:
        sk = (name, key)
        s = self._series.get(sk)
        if s is None:
            s = self._series[sk] = _Series(
                mtype, origin, self._raw_points, self._m1_points,
                self._m10_points)
            self._est_bytes += _SERIES_OVERHEAD
        else:
            self._series.move_to_end(sk)
        raw_n, m1_n, m10_n = len(s.raw), len(s.m1), len(s.m10)
        s.add(ts, value)
        # rings at maxlen stay flat (append evicts); only growth costs
        self._est_bytes += (len(s.raw) - raw_n) * _RAW_POINT_COST \
            + (len(s.m1) - m1_n + len(s.m10) - m10_n) * _BUCKET_COST

    def _enforce_cap_locked(self) -> None:
        while self._est_bytes > self._max_bytes and len(self._series) > 1:
            _, s = self._series.popitem(last=False)  # least recently updated
            self._est_bytes -= s.bytes_estimate()
            self._evicted_series += 1

    # -- expiry --------------------------------------------------------
    def expire_stale(self, max_age_s: float,
                     now: Optional[float] = None) -> int:
        """Drop SERIES (and origins) not refreshed within ``max_age_s``.

        Series-granular on purpose: every push re-ingests all of an
        origin's current values, so a series whose ``last_ts`` stopped
        advancing means either its origin died OR its label set vanished
        from a still-live origin's pushes (a worker that died on an agent
        node whose agent keeps reporting).  Both must leave, or
        per-entity series accumulate forever with churn.  Returns the
        number of series dropped."""
        if now is None:
            now = time.time()
        dropped = 0
        with self._lock:
            for sk in [sk for sk, s in self._series.items()
                       if now - s.last_ts > max_age_s]:
                self._est_bytes -= self._series.pop(sk).bytes_estimate()
                dropped += 1
            for o in [o for o, ts in self._origin_seen.items()
                      if now - ts > max_age_s]:
                del self._origin_seen[o]
        return dropped

    # -- query ---------------------------------------------------------
    def list_metrics(self) -> List[dict]:
        with self._lock:
            by_name: Dict[str, dict] = {}
            for (name, key), s in self._series.items():
                row = by_name.get(name)
                if row is None:
                    mtype, help_ = self._meta.get(name, (s.mtype, ""))
                    row = by_name[name] = {
                        "name": name, "type": mtype, "help": help_,
                        "num_series": 0, "origins": set(), "last_ts": 0.0,
                    }
                row["num_series"] += 1
                row["origins"].add(s.origin)
                row["last_ts"] = max(row["last_ts"], s.last_ts)
        # sort OUTSIDE the lock: by_name is ours alone once built, and
        # the ingest path must never wait on a directory listing
        out = []
        for row in sorted(by_name.values(), key=lambda r: r["name"]):
            row["origins"] = sorted(row["origins"])
            out.append(row)
        return out

    def query(self, name: str, window_s: float = 3600.0,
              step_s: float = 0.0, tags: Optional[Dict[str, str]] = None,
              agg: Optional[str] = None,
              now: Optional[float] = None) -> dict:
        """Aligned time series for ``name`` over the trailing window.

        Every matching label series returns separately (callers sum/plot
        per-series).  ``step_s <= 0`` defaults to the cluster's actual
        push cadence (``metrics.push_interval_s`` — the one knob every
        sampling loop ticks on, so default-step bins line up with real
        samples); ``step_s > window_s`` degrades to a single bin; an
        empty/negative window returns no points — never raises on shape,
        only on an unknown aggregation."""
        from ray_tpu_torch.util.metrics import push_interval_s

        if agg is not None and agg not in _AGGS:
            raise ValueError(f"unknown agg {agg!r} (one of {_AGGS})")
        if now is None:
            now = time.time()
        step_s = float(step_s) if step_s and step_s > 0 else push_interval_s()
        window_s = float(window_s)
        # step > window degrades to a single bin inside _bin; an empty or
        # negative window yields no points — both are shape, not errors
        start = now - window_s
        out_series: List[dict] = []
        want = tuple(sorted((tags or {}).items()))
        with self._lock:
            mtype, help_ = self._meta.get(name, ("gauge", ""))
            matches = [(key, s) for (n, key), s in self._series.items()
                       if n == name and all(kv in key for kv in want)]
            use = agg or _default_agg(mtype)
            for key, s in matches:
                pts = [p for p in s._stage_points(step_s, start)
                       if p[0] > start]
                out_series.append({
                    "tags": dict(key),
                    "points": _bin(pts, start, now, step_s, use),
                })
        return {"name": name, "type": mtype, "help": help_,
                "window_s": window_s, "step_s": step_s,
                "agg": agg or _default_agg(mtype), "series": out_series}

    # -- admin ---------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "num_series": len(self._series),
                "num_metrics": len({n for n, _ in self._series}),
                "num_origins": len(self._origin_seen),
                "est_bytes": self._est_bytes,
                "max_bytes": self._max_bytes,
                "evicted_series": self._evicted_series,
            }

    def memory_bytes(self) -> int:
        with self._lock:
            return self._est_bytes

    def origins(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._origin_seen)


def _bin(points, start: float, end: float, step_s: float,
         agg: str) -> List[List[float]]:
    """Fold stage points into aligned [ts, value] bins.  Bins with no
    source point are skipped (gaps stay visible as gaps — interpolating
    would invent data a doctor rule could false-positive on)."""
    if end <= start or not points:
        return []
    n_bins = max(1, int(round((end - start) / step_s)))
    bins: Dict[int, list] = {}
    for ts, last, mx, mn, sm, cnt in points:
        i = min(n_bins - 1, max(0, int((ts - start) / step_s)))
        b = bins.get(i)
        if b is None:
            bins[i] = [ts, last, mx, mn, sm, cnt]
        else:
            # points arrive time-ordered within a series
            b[0], b[1] = ts, last
            b[2] = max(b[2], mx)
            b[3] = min(b[3], mn)
            b[4] += sm
            b[5] += cnt
    out = []
    for i in sorted(bins):
        ts, last, mx, mn, sm, cnt = bins[i]
        if agg == "last":
            v = last
        elif agg == "max":
            v = mx
        elif agg == "min":
            v = mn
        elif agg == "sum":
            v = sm
        elif agg == "count":
            v = float(cnt)
        else:  # avg
            v = sm / cnt if cnt else 0.0
        out.append([round(start + (i + 1) * step_s, 3), v])
    return out
