"""Head-side store for continuously-shipped folded stacks (the port's
copy of ``ray_tpu/util/profile_store.py``).

Every process in the cluster runs a
:class:`~ray_tpu_torch._private.sampling_profiler.ContinuousProfiler` that
batch-ships time-bucketed folded stacks over its existing control
connection (``profile_report`` frames ride the same path as
``metrics_report``).  The head lands them here: bounded per-origin rings
with staged decay — recent windows keep full fine-grained buckets, old
fine buckets fold into coarse buckets, and origins that stop pushing are
retired wholesale — the TSDB discipline applied to profiles.

On top of the rings sit the query surfaces: merged flamegraphs over a
window (``query``/``collapsed``), differential folded stacks between two
windows (``diff``, flamegraph.pl ``difffolded`` ready), and the CPU cost
ledger (``cost_ledger``) that converts duty-cycle-sampled stacks into
per-task microsecond columns which must sum to the measured per-task
wall — the ``StepProfiler`` exactness discipline applied to the control
plane.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional

# ---------------------------------------------------------------------------
# frame classification (shared by the ledger and the doctor's
# serialization gauge)
# ---------------------------------------------------------------------------

# A stack is "idle" when its leaf frame is a blocking wait: the thread is
# parked in the kernel, consuming no core.  Leaf function names cover the
# stdlib wait idioms; leaf files catch the socket/selector layers whose
# function names are too generic to list.
_IDLE_LEAF_FUNCS = frozenset((
    "wait", "_wait_for_tstate_lock", "select", "poll", "_poll", "epoll",
    "recv", "_recv", "recv_bytes", "recv_into", "readinto", "read",
    "readline", "accept", "sleep", "get", "park", "kqueue",
))
_IDLE_LEAF_FILES = frozenset(("selectors.py", "socket.py"))

# Busy stacks classify by the LEAF-MOST recognizable file: serialization
# inside a dispatch call tree is serialization — that nesting is exactly
# what the ledger exists to expose.  The table matches by basename, as
# the JAX package's does, so torch's own files fall in too:
# torch/serialization.py (a tensor's pickling) is "serialize", but
# torch/fx/node.py is "dispatch" and any */api.py "submit".
_CLASS_BY_FILE = {
    "serialization.py": "serialize", "wire.py": "serialize",
    "packed_wire.py": "serialize", "pickle.py": "serialize",
    "copyreg.py": "serialize", "struct.py": "serialize",
    "locks.py": "lock_wait",
    "node.py": "dispatch", "sharding.py": "dispatch",
    "object_store.py": "dispatch", "syncer.py": "dispatch",
    "remote_function.py": "submit", "client.py": "submit",
    "actor.py": "submit", "api.py": "submit",
    "worker.py": "exec",
}

BUSY_CLASSES = ("submit", "dispatch", "exec", "serialize", "lock_wait",
                "other")


def classify_stack(stack: str) -> str:
    """Map one ``|``-joined folded stack to an accounting class."""
    frames = stack.split("|")
    leaf_file, _, leaf_func = frames[-1].partition(":")
    if leaf_func in _IDLE_LEAF_FUNCS or leaf_file in _IDLE_LEAF_FILES:
        return "idle"
    for frame in reversed(frames):
        cls = _CLASS_BY_FILE.get(frame.partition(":")[0])
        if cls is not None:
            return cls
    return "other"


def _bucket_cost(folded: Dict[str, int]) -> int:
    # bookkeeping estimate: key bytes + counter slot
    return sum(len(s) + 32 for s in folded)


class ProfileStore:
    """Bounded per-origin rings of folded-stack buckets.

    ``fine`` buckets hold full resolution for the recent past; byte or
    age pressure folds the oldest of them into ``coarse`` buckets
    (wider span, top-K stacks, remainder under ``(decayed)``); coarse
    buckets beyond retention — and whole origins that stop pushing — are
    dropped.  All caps are constructor parameters so tests can force
    every stage cheaply.
    """

    def __init__(self, *, bucket_s: float = 60.0, coarse_s: float = 600.0,
                 max_bytes_per_origin: int = 1 << 20, max_origins: int = 64,
                 fine_retention_s: float = 1800.0,
                 coarse_retention_s: float = 7200.0,
                 coarse_top_k: int = 400):
        from ray_tpu_torch._private.locks import make_lock

        self.bucket_s = bucket_s
        self.coarse_s = coarse_s
        self.max_bytes_per_origin = max_bytes_per_origin
        self.max_origins = max_origins
        self.fine_retention_s = fine_retention_s
        self.coarse_retention_s = coarse_retention_s
        self.coarse_top_k = coarse_top_k
        self._lock = make_lock("profile_store")
        # origin -> {"fine": {ts: {"folded": Counter, "ticks": float}},
        #            "coarse": {ts: ...}, "bytes": int, "last_push": float,
        #            "samples": int, "gil_frac": float, "meta": dict}
        self._origins: Dict[str, dict] = {}

    # -- ingest -------------------------------------------------------------
    def ingest(self, origin: str, buckets: List[dict],
               meta: Optional[dict] = None, now: Optional[float] = None) -> None:
        """Land one ``profile_report`` batch.  ``buckets`` is the wire
        shape ``[{"ts": float, "folded": {stack: n}}, ...]``; the batch's
        sampling ticks (duty-cycle denominator) are apportioned across
        its buckets by sample share."""
        now = time.time() if now is None else now
        meta = meta or {}
        total = sum(sum(b.get("folded", {}).values()) for b in buckets) or 1
        meta_ticks = float(meta.get("ticks", 0))
        with self._lock:
            st = self._origins.get(origin)
            if st is None:
                st = self._origins[origin] = {
                    "fine": {}, "coarse": {}, "bytes": 0, "last_push": now,
                    "samples": 0, "gil_frac": 0.0, "meta": {},
                }
                self._evict_origins_locked()
            st["last_push"] = now
            if meta:
                st["meta"] = dict(meta)
                lateness = float(meta.get("lateness_frac", 0.0))
                st["gil_frac"] = 0.5 * st["gil_frac"] + 0.5 * lateness
            for b in buckets:
                folded = b.get("folded") or {}
                if not folded:
                    continue
                ts = (float(b.get("ts", now)) // self.bucket_s) * self.bucket_s
                row = st["fine"].get(ts)
                if row is None:
                    row = st["fine"][ts] = {
                        "folded": collections.Counter(), "ticks": 0.0,
                        "busy": 0.0}
                before = _bucket_cost(row["folded"])
                row["folded"].update(folded)
                n = sum(folded.values())
                # the continuous profiler ships per-bucket duty counts;
                # batches without them (synthetic/legacy) apportion the
                # batch total by sample share
                row["ticks"] += float(
                    b.get("ticks", meta_ticks * n / total))
                row["busy"] += float(b.get("busy_ticks", 0.0))
                st["samples"] += n
                st["bytes"] += _bucket_cost(row["folded"]) - before
            self._enforce_locked(st)

    def _evict_origins_locked(self) -> None:
        while len(self._origins) > self.max_origins:
            oldest = min(self._origins, key=lambda o: self._origins[o]["last_push"])
            del self._origins[oldest]

    def _enforce_locked(self, st: dict) -> None:
        """Byte-pressure staged decay: oldest fine bucket folds to
        coarse; when only coarse remains, the oldest coarse is dropped."""
        while st["bytes"] > self.max_bytes_per_origin:
            if st["fine"]:
                ts = min(st["fine"])
                self._decay_bucket_locked(st, ts)
            elif st["coarse"]:
                ts = min(st["coarse"])
                row = st["coarse"].pop(ts)
                st["bytes"] -= _bucket_cost(row["folded"])
            else:
                break

    def _decay_bucket_locked(self, st: dict, ts: float) -> None:
        row = st["fine"].pop(ts)
        st["bytes"] -= _bucket_cost(row["folded"])
        cts = (ts // self.coarse_s) * self.coarse_s
        crow = st["coarse"].get(cts)
        if crow is None:
            crow = st["coarse"][cts] = {
                "folded": collections.Counter(), "ticks": 0.0, "busy": 0.0}
        before = _bucket_cost(crow["folded"])
        crow["folded"].update(row["folded"])
        crow["ticks"] += row["ticks"]
        crow["busy"] += row.get("busy", 0.0)
        # coarse keeps only the top-K stacks; the long tail merges into a
        # single marker so the byte cost of history is bounded by design
        if len(crow["folded"]) > self.coarse_top_k:
            keep = collections.Counter(
                dict(crow["folded"].most_common(self.coarse_top_k)))
            keep["(decayed)"] += (sum(crow["folded"].values())
                                  - sum(keep.values()))
            crow["folded"] = keep
        st["bytes"] += _bucket_cost(crow["folded"]) - before

    # -- maintenance --------------------------------------------------------
    def prune(self, now: Optional[float] = None) -> None:
        """Age-based staged decay (the byte caps handle pressure; this
        handles the clock): fine buckets past ``fine_retention_s`` fold
        to coarse, coarse past ``coarse_retention_s`` drop."""
        now = time.time() if now is None else now
        with self._lock:
            for st in self._origins.values():
                for ts in sorted(st["fine"]):
                    if now - ts > self.fine_retention_s:
                        self._decay_bucket_locked(st, ts)
                for ts in sorted(st["coarse"]):
                    if now - ts > self.coarse_retention_s:
                        row = st["coarse"].pop(ts)
                        st["bytes"] -= _bucket_cost(row["folded"])

    def retire_stale(self, max_age_s: float,
                     now: Optional[float] = None) -> List[str]:
        """Drop origins that missed their pushes for ``max_age_s``
        (dead worker, disconnected driver).  Returns the retired names
        so the caller can emit events."""
        now = time.time() if now is None else now
        with self._lock:
            dead = [o for o, st in self._origins.items()
                    if now - st["last_push"] > max_age_s]
            for o in dead:
                del self._origins[o]
        return dead

    # -- queries ------------------------------------------------------------
    def _merged_locked(self, lo: float, hi: float,
                       origin: Optional[str]) -> tuple:
        """Merge every bucket OVERLAPPING [lo, hi) — a window shorter
        than the bucket span must still see the bucket it sits inside."""
        folded: "collections.Counter[str]" = collections.Counter()
        ticks = 0.0
        busy = 0.0
        origins = []
        for name, st in self._origins.items():
            if origin is not None and name != origin:
                continue
            hit = False
            for ring, span in ((st["fine"], self.bucket_s),
                               (st["coarse"], self.coarse_s)):
                for ts, row in ring.items():
                    if ts + span > lo and ts < hi:
                        folded.update(row["folded"])
                        ticks += row["ticks"]
                        busy += row.get("busy", 0.0)
                        hit = True
            if hit:
                origins.append(name)
        return folded, ticks, busy, origins

    def query(self, window_s: float, origin: Optional[str] = None,
              now: Optional[float] = None) -> dict:
        """Merged folded stacks over the trailing window."""
        now = time.time() if now is None else now
        with self._lock:
            folded, ticks, busy, origins = self._merged_locked(
                now - window_s, now + 1e-9, origin)
        return {"window_s": window_s, "origin": origin,
                "origins": sorted(origins), "ticks": round(ticks, 1),
                "busy_ticks": round(busy, 1),
                "samples": sum(folded.values()), "folded": dict(folded)}

    def collapsed(self, window_s: float, origin: Optional[str] = None,
                  now: Optional[float] = None) -> str:
        """Folded-stack lines (``a;b;c N``) for speedscope/flamegraph.pl."""
        q = self.query(window_s, origin=origin, now=now)
        return "\n".join(
            f"{stack.replace('|', ';')} {n}"
            for stack, n in sorted(q["folded"].items(),
                                   key=lambda kv: -kv[1]))

    def diff(self, window_a: float, window_b: float,
             origin: Optional[str] = None,
             now: Optional[float] = None) -> dict:
        """Differential profile: the trailing ``window_b`` seconds (B)
        against the ``window_a``-long span before it (A) — "what changed
        recently".  A's counts are scaled to B's span so the per-stack
        ``delta`` (and the ``difffolded``-format ``collapsed`` lines,
        ``stack countA countB``) compare like with like."""
        now = time.time() if now is None else now
        window_a = max(float(window_a), 1e-9)
        window_b = max(float(window_b), 1e-9)
        with self._lock:
            a, ticks_a, _, _ = self._merged_locked(
                now - window_b - window_a, now - window_b, origin)
            b, ticks_b, _, origins = self._merged_locked(
                now - window_b, now + 1e-9, origin)
        scale = window_b / window_a
        delta = {}
        lines = []
        for stack in sorted(set(a) | set(b)):
            a_scaled = a.get(stack, 0) * scale
            d = b.get(stack, 0) - a_scaled
            if d:
                delta[stack] = round(d, 2)
            lines.append(f"{stack.replace('|', ';')} "
                         f"{round(a_scaled)} {b.get(stack, 0)}")
        return {"window_a": window_a, "window_b": window_b,
                "origin": origin, "origins": sorted(origins),
                "samples_a": sum(a.values()), "samples_b": sum(b.values()),
                "ticks_a": round(ticks_a, 1), "ticks_b": round(ticks_b, 1),
                "delta": delta, "collapsed": "\n".join(lines)}

    def stats(self, now: Optional[float] = None) -> List[dict]:
        """One row per origin (the ``list_profiles`` body)."""
        now = time.time() if now is None else now
        with self._lock:  # snapshot only; the O(n log n) sort runs after
            snap = [(name, len(st["fine"]), len(st["coarse"]), st["bytes"],
                     st["samples"], st["gil_frac"], st["last_push"],
                     list(st["fine"]) + list(st["coarse"]),
                     st["meta"].get("interval_s"), st["meta"].get("period_s"))
                    for name, st in self._origins.items()]
        rows = []
        for (name, fine_n, coarse_n, nbytes, samples, gil, last_push,
             all_ts, interval_s, period_s) in sorted(snap, key=lambda r: r[0]):
            rows.append({
                "origin": name,
                "buckets": fine_n,
                "coarse_buckets": coarse_n,
                "bytes": nbytes,
                "samples": samples,
                "gil_frac": round(gil, 4),
                "age_s": round(now - last_push, 1),
                "span_s": round(max(all_ts) - min(all_ts)
                                + self.bucket_s, 1) if all_ts else 0.0,
                "interval_s": interval_s,
                "period_s": period_s,
            })
        return rows

    # -- duty-cycle accounting / the ledger ---------------------------------
    def class_rates(self, window_s: float, origin: Optional[str] = None,
                    now: Optional[float] = None) -> dict:
        """Duty-cycle accounting over the window: thread-seconds/second
        per accounting class.  A burst's sample share per class equals
        its wall share per thread, so ``class samples / ticks`` is the
        class's thread-occupancy — it can exceed 1.0 on a multi-threaded
        process, and on CPython that excess is by definition GIL wait
        (``util`` clips at one core; ``raw_busy - util`` is the
        runnable-but-unscheduled surplus)."""
        now = time.time() if now is None else now
        with self._lock:
            folded, ticks, busy, origins = self._merged_locked(
                now - window_s, now + 1e-9, origin)
            gil = 0.0
            if origin is not None and origin in self._origins:
                gil = self._origins[origin]["gil_frac"]
        per_class: Dict[str, float] = {c: 0.0 for c in BUSY_CLASSES}
        idle = 0.0
        for stack, n in folded.items():
            cls = classify_stack(stack)
            if cls == "idle":
                idle += n
            else:
                per_class[cls] += n
        denom = max(ticks, 1e-9)
        rates = {c: v / denom for c, v in per_class.items()}
        raw_busy = sum(rates.values())
        # utilization: fraction of ticks that caught the process OFF a
        # blocking wait (sampler-counted, one core max per process).
        # raw_busy over-counts it badly on a multi-threaded CPython
        # process — GIL-waiting threads photograph as busy — so the
        # per-tick busy count is the denominator of record; raw_busy is
        # the fallback for batches that never carried duty counts.
        util = min(busy / denom, 1.0) if busy else min(raw_busy, 1.0)
        return {"window_s": window_s, "origin": origin,
                "origins": sorted(origins), "ticks": round(ticks, 1),
                "classes": {c: round(v, 4) for c, v in rates.items()},
                "raw_busy": round(raw_busy, 4),
                "util": round(util, 4),
                "idle": round(idle / denom, 4),
                "gil_frac": round(gil, 4)}

    def serialization_frac(self, window_s: float = 300.0,
                           now: Optional[float] = None) -> float:
        """Cluster-wide share of busy samples spent serializing — the
        gauge behind the doctor's ``serialization_hot`` rule."""
        r = self.class_rates(window_s, origin=None, now=now)
        busy = max(r["raw_busy"], 1e-9)
        return min(1.0, r["classes"]["serialize"] / busy)

    def cost_ledger(self, window_s: float, tasks: int,
                    roles: Dict[str, str],
                    now: Optional[float] = None) -> dict:
        """The per-task CPU cost ledger.

        ``roles`` maps origin -> "head" | "worker" (origins absent from
        the map — node agents, drivers off the task path — are
        excluded).  The head process — the GIL-serialized control plane,
        which also hosts the in-process driver — is the wall's clock:
        its measured utilization times the per-task wall is its budget,
        split between stack classes and the lateness-measured GIL-wait
        share.  Worker CPU lands on the wall only up to the head's idle
        gap — worker time overlapped with a busy head is pipelined and
        costs CPU but no wall, so it reports separately as
        ``overlapped_worker_cpu_us`` instead of inflating the sum.

        Nothing forces ``sum_over_wall`` to 1.0: it only gets there if
        the measured head utilization plus gap-filling worker time
        actually cover the wall.  Under-measured utilization (idle
        misclassification), a missing GIL clip, or a dead profiler all
        push it out of band — when the columns don't sum, the
        measurement (not the label) is wrong, which is the point.
        """
        now = time.time() if now is None else now
        tasks = max(int(tasks), 1)
        per_task_wall_us = window_s * 1e6 / tasks
        cols = {"driver_submit_us": 0.0, "head_dispatch_us": 0.0,
                "worker_exec_us": 0.0, "serialize_us": 0.0,
                "lock_wait_us": 0.0, "gil_wait_us": 0.0, "other_us": 0.0}
        origin_util = {}
        head_util = 0.0
        worker_pool_us = 0.0
        for origin, role in roles.items():
            r = self.class_rates(window_s, origin=origin, now=now)
            if not r["ticks"]:
                continue
            util = r["util"]
            origin_util[origin] = util
            if role != "head":
                worker_pool_us += util * per_task_wall_us
                continue
            head_util = max(head_util, util)
            raw = max(r["raw_busy"], 1e-9)
            gil_frac = r["gil_frac"]
            budget_us = util * per_task_wall_us
            cols["gil_wait_us"] += budget_us * gil_frac
            busy_us = budget_us * (1.0 - gil_frac)
            for cls, rate in r["classes"].items():
                share = busy_us * rate / raw
                if cls == "serialize":
                    cols["serialize_us"] += share
                elif cls == "lock_wait":
                    cols["lock_wait_us"] += share
                elif cls in ("submit", "exec"):
                    # in-process driver: client/remote_function and the
                    # global_worker machinery are driver time, the rest
                    # of the process is dispatch
                    cols["driver_submit_us"] += share
                elif cls == "dispatch":
                    cols["head_dispatch_us"] += share
                else:
                    cols["other_us"] += share
        gap_us = max(0.0, 1.0 - head_util) * per_task_wall_us
        cols["worker_exec_us"] = min(worker_pool_us, gap_us)
        overlapped_us = worker_pool_us - cols["worker_exec_us"]
        total_us = sum(cols.values())
        return {"window_s": window_s, "tasks": tasks,
                "per_task_wall_us": round(per_task_wall_us, 2),
                "columns": {k: round(v, 2) for k, v in cols.items()},
                "overlapped_worker_cpu_us": round(overlapped_us, 2),
                "sum_us": round(total_us, 2),
                "sum_over_wall": round(total_us / max(per_task_wall_us, 1e-9),
                                       4),
                "origin_util": {o: round(u, 4)
                                for o, u in origin_util.items()}}
