"""``ray_tpu_torch doctor`` — rule-based pathology analysis over recorded state.

The flight recorder (``_private/events.py``), the metric registry, and the
task table already RECORD every known pathology this runtime can hit —
backpressure stalls, spill thrash, OOM kills, gang restarts, split
starvation, poisoned/stuck compiled-graph channels, router saturation,
slow-node skew.  This module closes the loop: ``diagnose()`` runs the
rule set over the recorded rows and returns actionable findings WITH the
evidence rows, so an operator staring at a p99 regression gets "streaming
pump stalled 4.2s on backpressure (budget 1); raise the block budget or
speed up the consumer" instead of a wall of DEBUG events.

Rules are thresholded against healthy baselines (a backpressured streaming
pipeline is the design working, not a pathology — it takes sustained stall
seconds to flag), and a clean run returns ``[]``: ``chip_smoke.py``'s
``util_pool_bert_accounting`` phase holds a healthy run to that.

Pure functions over row lists — testable without a cluster; ``run_doctor``
is the thin live-cluster wrapper the CLI uses.  The port records its
events and series under the JAX package's source, message and metric
names (``perf``/``jit compile`` from ``util/perf.py``'s compile tracker,
``ray_tpu_train_step_mfu`` from its step profiler, ``ray_tpu_proc_rss_mb``
from the ``/proc`` samplers), so every rule reads them unchanged.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

# finding severities mirror event severities (ERROR > WARNING > INFO)
_SEV_ORDER = {"ERROR": 0, "WARNING": 1, "INFO": 2}

# -- rule thresholds (shared with the tests; module-level so an operator
# can tune them for an unusual deployment) ---------------------------------
STALL_TOTAL_S = 0.5       # cumulative pump stall that counts as a stall
STARVATION_TOTAL_S = 2.0  # cumulative consumer starvation seconds
SPILL_COUNT = 3           # spills before "thrash"
CHANNEL_WAIT_STUCK_S = 5.0  # one channel wait this long = stuck
ROUTER_STALL_COUNT = 1    # saturated-router stalls (replicas > 0)
WORKER_CHURN_COUNT = 3    # unexpected worker deaths
DRAIN_STUCK_S = 15.0      # a drain still open this long after starting
                          # (relative to the newest recorded event)
SKEW_RATIO = 3.0          # slowest-node / fastest-node mean exec ratio
SKEW_MIN_TASKS = 5        # per (task name, node) sample floor
SKEW_MIN_DELTA_S = 0.05   # absolute mean gap floor (noise guard)

# -- trend-rule thresholds (over TSDB series — slopes only a time series
# can express; point-in-time snapshots cannot false-positive OR true-
# positive on any of these) -------------------------------------------------
TREND_MIN_POINTS = 6        # samples before any slope is trusted
RSS_SLOPE_MB_PER_MIN = 5.0  # per-process RSS growth rate to flag
RSS_GROWTH_MIN_MB = 64.0    # absolute growth floor (warmup noise guard)
RSS_MONOTONE_FRAC = 0.8     # fraction of deltas that must be increases
STORE_SLOPE_MB_PER_MIN = 16.0  # object-store bytes growth rate to flag
STORE_GROWTH_MIN_MB = 64.0
QUEUE_CLIMB_MIN_DEPTH = 1.0  # queue never drained below this AND
QUEUE_CLIMB_RATIO = 2.0      # ended >= this multiple of where it started

# -- perf-rule thresholds (over the util/perf.py step profiler's and
# serve/llm.py tick meter's `perf` events — signals only device-time
# attribution can express) ---------------------------------------------------
RECOMPILE_STORM_SIGS = 5     # distinct shape signatures for ONE jit fn
                             # (multi-bucket prefill legitimately holds 4)
INGEST_FRACTION = 0.30       # ingest-wait share of step wall to flag
INGEST_MIN_STEPS = 5         # profiled steps before the share is trusted
PREFILL_INTERFERENCE_FRAC = 0.20  # interference share of decode tick time
PREFILL_MIN_TICKS = 20       # interleaved ticks before the share is trusted
MFU_DROP_FRAC = 0.10         # trailing-window MFU drop vs the earlier mean
MFU_MIN_LEVEL = 0.02         # earlier-mean floor (CPU dev noise guard)
TENANT_REAP_STUCK_S = 10.0   # death with no reap for this long = wedged
TENANT_KILL_RECENT_S = 120.0  # explained incident stays visible this long

# -- continuous-profiling thresholds (signals only the always-on sampler
# and the lock-timing plane can express) -------------------------------------
GIL_SATURATION_FRAC = 0.35   # sustained off-GIL fraction to call a process
                             # core-bound (healthy loaded heads sit < 0.2)
GIL_MIN_POINTS = 4           # sustained means: the whole trailing stretch
LOCK_WAIT_MIN_S = 1.0        # measured wait a lock must accumulate over the
                             # window before its ratio is worth reading
LOCK_WAIT_HOLD_RATIO = 2.0   # waiters paid >= 2x the hold behind them: a
                             # convoy, not incidental contention
SERIALIZATION_HOT_FRAC = 0.35  # share of sampled busy time inside
                               # serialization frames to flag


def _finding(rule: str, severity: str, summary: str,
             evidence: Sequence[dict], remedy: str) -> dict:
    return {
        "rule": rule,
        "severity": severity,
        "summary": summary,
        "remedy": remedy,
        "count": len(evidence),
        "evidence": list(evidence)[:5],
    }


def _rows(events: Sequence[dict], source: str,
          message: Optional[str] = None,
          prefix: Optional[str] = None) -> List[dict]:
    out = []
    for e in events:
        if e.get("source") != source:
            continue
        m = e.get("message", "")
        if message is not None and m != message:
            continue
        if prefix is not None and not m.startswith(prefix):
            continue
        out.append(e)
    return out


# ---------------------------------------------------------------------------
# rules (each: events, tasks -> finding | None)
# ---------------------------------------------------------------------------

def _rule_backpressure_stall(events, tasks):
    stalls = _rows(events, "streaming", "backpressure stall")
    # total_stalled_s is cumulative per executor: take each executor's max
    # (rows don't carry an executor id — op is the closest key)
    by_op: Dict[str, float] = {}
    for r in stalls:
        d = r.get("data") or {}
        op = str(d.get("op", "?"))
        by_op[op] = max(by_op[op] if op in by_op else 0.0,
                        float(d.get("total_stalled_s") or 0.0))
    total = sum(by_op.values())
    if total < STALL_TOTAL_S:
        return None
    return _finding(
        "backpressure_stall", "WARNING",
        f"streaming pump stalled {total:.2f}s on per-split block budgets "
        f"(ops: {', '.join(sorted(by_op))})",
        stalls,
        "consumers are slower than the pipeline: raise "
        "RAY_TPU_TORCH_STREAMING_BLOCK_BUDGET / max_in_flight_blocks, speed up "
        "the consumer, or add splits")


def _rule_split_starvation(events, tasks):
    rows = _rows(events, "streaming", "split starved")
    total = sum(float((r.get("data") or {}).get("wait_s") or 0.0)
                for r in rows)
    if total < STARVATION_TOTAL_S:
        return None
    return _finding(
        "split_starvation", "WARNING",
        f"streaming consumers sat {total:.2f}s on empty splits "
        f"({len(rows)} waits) — the pipeline can't keep up",
        rows,
        "producers are the bottleneck: add parallelism to the source/map "
        "stage or raise the block budget so submission runs ahead")


def _rule_spill_thrash(events, tasks):
    rows = _rows(events, "object_store", "spilled object to disk")
    if len(rows) < SPILL_COUNT:
        return None
    mb = sum(float((r.get("data") or {}).get("size_mb") or 0.0)
             for r in rows)
    return _finding(
        "spill_thrash", "WARNING",
        f"object store spilled {len(rows)} objects (~{mb:.0f} MB) to disk",
        rows,
        "working set exceeds shm capacity: raise the object-store "
        "capacity, free refs sooner, or stream instead of materializing")


def _rule_oom_kills(events, tasks):
    rows = _rows(events, "scheduler", "OOM kill")
    if not rows:
        return None
    return _finding(
        "oom_kills", "ERROR",
        f"{len(rows)} worker(s) OOM-killed by the memory monitor",
        rows,
        "tasks exceed per-worker memory: lower per-node concurrency, "
        "shrink task working sets, or add memory/nodes")


def _rule_gang_restart(events, tasks):
    restarts = _rows(events, "train", "gang restarted")
    failures = _rows(events, "train", prefix="gang failure")
    if not restarts and not failures:
        return None
    return _finding(
        "gang_restart", "ERROR" if failures else "WARNING",
        f"train gang restarted {len(restarts)}x / "
        f"{len(failures)} rank failure(s)",
        failures + restarts,
        "a rank is dying mid-training (see the evidence rows' error "
        "field): check worker OOMs/preemptions; checkpoints bound lost "
        "work")


def _rule_stuck_channel(events, tasks):
    dead = [r for r in _rows(events, "compiled_dag")
            if r.get("severity") == "ERROR"]
    # only SEND-side waits count as stuck: a long recv wait is a loop
    # idling between requests (normal), a long blocked put means the
    # consumer stopped draining
    stuck = [r for r in _rows(events, "compiled_dag", "channel wait")
             if float(r.get("span_dur") or 0.0) >= CHANNEL_WAIT_STUCK_S
             and (r.get("data") or {}).get("op") == "send"]
    if not dead and not stuck:
        return None
    return _finding(
        "stuck_channel", "ERROR" if dead else "WARNING",
        f"compiled-graph channels unhealthy: {len(dead)} loop death(s), "
        f"{len(stuck)} channel wait(s) >= {CHANNEL_WAIT_STUCK_S:.0f}s",
        dead + stuck,
        "a node loop died (poisoning its edges) or a stage starves its "
        "peers: check the ERROR rows' actor, teardown() and recompile; "
        "balance stage times or raise max_inflight")


def _rule_router_saturation(events, tasks):
    rows = [r for r in _rows(events, "serve",
                             "router stalled: no replica available")
            if (r.get("data") or {}).get("replicas", 0) > 0]
    if len(rows) < ROUTER_STALL_COUNT:
        return None
    return _finding(
        "router_saturation", "WARNING",
        f"serve router(s) stalled {len(rows)}x with every replica at "
        f"max_concurrent_queries",
        rows,
        "replicas are saturated: raise num_replicas (or autoscaling "
        "max), raise max_concurrent_queries, or speed up the handler")


def _rule_ingress_shedding(events, tasks):
    """The serve ingress is ACTIVELY refusing work: a ``shedding
    started`` episode (router backlog watermark or proxy in-flight cap)
    with no later ``stopped`` for the same entity is an open overload
    incident.  Shedding that started and stopped is the mechanism
    working — degradation was graceful, demand receded, nothing to page
    about — so doctor stays quiet once recovery lands."""
    started = _rows(events, "serve", "ingress shedding started")
    if not started:
        return None
    stopped = _rows(events, "serve", "ingress shedding stopped")
    last_stop: Dict[str, float] = {}
    for r in stopped:
        eid = str(r.get("entity_id"))
        last_stop[eid] = max(last_stop.get(eid, 0.0),
                             float(r.get("ts") or 0.0))
    open_rows: Dict[str, dict] = {}
    for r in started:
        eid = str(r.get("entity_id"))
        ts = float(r.get("ts") or 0.0)
        if ts > last_stop.get(eid, -1.0):
            prev = open_rows.get(eid)
            if prev is None or ts >= float(prev.get("ts") or 0.0):
                open_rows[eid] = r
    if not open_rows:
        return None
    who = ", ".join(sorted(open_rows))
    return _finding(
        "ingress_shedding", "WARNING",
        f"serve ingress is shedding load on {who} — requests are being "
        f"refused (503 + Retry-After) at the backlog watermark",
        list(open_rows.values()),
        "demand exceeds serving capacity: raise num_replicas (or the "
        "autoscaling max), raise max_queued_requests if the backlog is a "
        "burst, or speed up the handler; shedding that has stopped "
        "clears this finding")


def _rule_drain_stuck(events, tasks):
    """A graceful replica drain that neither finished nor timed out long
    after starting — in-flight requests (or live streams) are wedged on
    a replica the controller wants gone.  Terminal events (``replica
    drained`` / ``replica drain timeout``) close the incident; a drain
    that TIMED OUT is also surfaced (accepted work was cut off at the
    graceful window — the zero-lost-requests story has a hole)."""
    starts = _rows(events, "serve", "replica draining")
    if not starts:
        return None
    done = _rows(events, "serve", "replica drained")
    timeouts = _rows(events, "serve", "replica drain timeout")
    closed: Dict[str, float] = {}
    for r in done + timeouts:
        eid = str(r.get("entity_id"))
        closed[eid] = max(closed.get(eid, 0.0), float(r.get("ts") or 0.0))
    # "now" inside a recorded-event table is the newest row's timestamp
    now = max((float(e.get("ts") or 0.0) for e in events), default=0.0)
    stuck = []
    for r in starts:
        eid = str(r.get("entity_id"))
        ts = float(r.get("ts") or 0.0)
        if ts > closed.get(eid, -1.0) and now - ts >= DRAIN_STUCK_S:
            stuck.append(r)
    if not stuck and not timeouts:
        return None
    sev = "ERROR" if stuck else "WARNING"
    summary = []
    if stuck:
        summary.append(
            f"{len(stuck)} replica drain(s) open > {DRAIN_STUCK_S:.0f}s")
    if timeouts:
        summary.append(
            f"{len(timeouts)} drain(s) hit the graceful window with "
            "requests still in flight")
    return _finding(
        "drain_stuck", sev,
        "graceful replica draining is not completing: "
        + "; ".join(summary),
        stuck + timeouts,
        "a handler is outliving graceful_shutdown_timeout_s: shorten "
        "request runtimes, raise the graceful window, or accept the "
        "cutoff (the evidence rows carry the in-flight counts)")


def _rule_tenant_killed(events, tasks):
    """A tenant's driver died.  Two shapes: a death with NO matching
    "tenant reaped" is an OPEN incident (the head's reap is wedged —
    that job's actors and pins are leaking) and stays ERROR until the
    reap lands; a death whose reap completed is EXPLAINED at WARNING
    while recent (``TENANT_KILL_RECENT_S`` against the event table's own
    clock), then the rule goes quiet — the cluster is healthy again and
    the incident is history, not a finding."""
    deaths = _rows(events, "client_proxy", "tenant driver died")
    if not deaths:
        return None
    reaps = _rows(events, "client_proxy", "tenant reaped")
    reaped_ts: Dict[str, float] = {}
    for r in reaps:
        eid = str(r.get("entity_id"))
        reaped_ts[eid] = max(reaped_ts.get(eid, 0.0), float(r.get("ts") or 0.0))
    now = max((float(e.get("ts") or 0.0) for e in events), default=0.0)
    open_, recent = [], []
    for r in deaths:
        eid = str(r.get("entity_id"))
        ts = float(r.get("ts") or 0.0)
        if reaped_ts.get(eid, -1.0) < ts:
            if now - ts >= TENANT_REAP_STUCK_S:
                open_.append(r)
        elif now - ts <= TENANT_KILL_RECENT_S:
            recent.append(r)
    if open_:
        return _finding(
            "tenant_killed", "ERROR",
            f"{len(open_)} tenant driver death(s) with no completed reap: "
            "the dead job's actors and object pins are still held",
            open_,
            "the head's client-disconnect reap did not run; check the "
            "head log for the tenant's job id")
    if recent:
        jobs = sorted({str(r.get("entity_id")) for r in recent})
        return _finding(
            "tenant_killed", "WARNING",
            f"tenant driver died and was reaped: {', '.join(jobs)} — "
            "non-detached actors killed, pins released; other tenants "
            "unaffected",
            recent,
            "no action needed unless the death was unexpected; the "
            "chaos/events tables show whether it was injected")
    return None


def _rule_worker_churn(events, tasks):
    rows = [r for r in _rows(events, "worker_pool", prefix="worker died")
            if r.get("severity") == "WARNING"]
    if len(rows) < WORKER_CHURN_COUNT:
        return None
    return _finding(
        "worker_churn", "WARNING",
        f"{len(rows)} workers died while holding tasks/actors",
        rows,
        "repeated unexpected worker deaths (segfaults, OOM, kills): "
        "check the per-worker logs under the session dir")


def _rule_log_error_burst(events, tasks):
    # the log store watches its ingest for error/traceback line bursts
    # from a single source — a worker spewing exceptions shows up here
    # before it dies (or without ever dying)
    rows = _rows(events, "log", prefix="error burst")
    if not rows:
        return None
    srcs = sorted({r.get("entity_id") for r in rows if r.get("entity_id")})
    return _finding(
        "log_error_burst", "WARNING",
        f"error/traceback log bursts from {len(srcs) or len(rows)} "
        f"source(s): {', '.join(srcs[:4])}",
        rows,
        "a process is emitting errors at a high rate: read them with "
        "`ray_tpu_torch logs <stream> --errors` (or `ray_tpu_torch logs --errors` "
        "cluster-wide) and check the owning task/actor")


def _rule_worker_stderr_at_death(events, tasks):
    # a worker died AND its shipped stderr tail held a traceback — the
    # crash explanation is already on the head, surface it next to the
    # death instead of making the user dig for the file
    rows = _rows(events, "log",
                 prefix="worker died with uncollected stderr")
    if not rows:
        return None
    sev = "ERROR" if any(r.get("severity") == "ERROR" for r in rows) \
        else "WARNING"
    # pull the first retained tail line into the summary: the point of
    # this rule is that the evidence IS the explanation
    tail_hint = ""
    for r in rows:
        tail = (r.get("data") or {}).get("tail") or []
        if tail:
            tail_hint = f" — last stderr: {tail[-1][:120]!r}"
            break
    return _finding(
        "worker_stderr_at_death", sev,
        f"{len(rows)} worker(s) died with unread stderr{tail_hint}",
        rows,
        "the dead worker's final stderr was captured before the death "
        "was processed: `ray_tpu_torch logs <stream> --errors` or "
        "state.tail_log(stream, errors=True) has the full tail")


def _rule_slow_node_skew(events, tasks):
    # same task name, >=2 nodes, enough samples each: a node whose mean
    # exec time is SKEW_RATIO x the fastest is dragging the tail
    by_name_node: Dict[str, Dict[str, List[float]]] = {}
    for t in tasks or ():
        if t.get("exec_start") is None or t.get("exec_end") is None \
                or not t.get("node_id"):
            continue
        dur = t["exec_end"] - t["exec_start"]
        by_name_node.setdefault(t.get("name", "?"), {}) \
            .setdefault(t["node_id"], []).append(dur)
    worst = None
    for name, per_node in by_name_node.items():
        means = {n: sum(v) / len(v) for n, v in per_node.items()
                 if len(v) >= SKEW_MIN_TASKS}
        if len(means) < 2:
            continue
        fast_n, fast = min(means.items(), key=lambda kv: kv[1])
        slow_n, slow = max(means.items(), key=lambda kv: kv[1])
        if slow < fast * SKEW_RATIO or slow - fast < SKEW_MIN_DELTA_S:
            continue
        if worst is None or slow / max(fast, 1e-9) > worst["ratio"]:
            worst = {"name": name, "slow": slow_n, "fast": fast_n,
                     "ratio": slow / max(fast, 1e-9),
                     "slow_s": slow, "fast_s": fast}
    if worst is None:
        return None
    return _finding(
        "slow_node_skew", "WARNING",
        f"node {worst['slow']} runs {worst['name']!r} "
        f"{worst['ratio']:.1f}x slower than {worst['fast']} "
        f"({worst['slow_s'] * 1e3:.0f}ms vs {worst['fast_s'] * 1e3:.0f}ms "
        f"mean)",
        [worst],
        "a straggler node skews the gang/tail: check its host_stats on "
        "the dashboard (CPU steal, thermal, noisy neighbor) or drain it")


def _rule_slice_degraded(events, tasks):
    """A slice with a dead/paused member and NO replacement in flight.

    A slice is one failure domain: one dead host wedges any STRICT gang
    leased on it, and per-host healing can't restore the lease — the only
    remedy is slice-atomic replacement.  The head emits ``slice
    degraded`` when a member dies unexpectedly (deliberate scale-downs
    mark the slice draining first and stay silent); the autoscaler emits
    ``slice replacement started`` / ``replaced`` / ``failed`` as it
    heals.  A degraded slice whose LAST degradation has no completed
    replacement at or after it — and no replacement in flight (a
    ``started`` not superseded by a later ``failed``) — is an open
    incident; a FAILED replacement re-opens it (the slice is still
    degraded; suppressing on 'started' alone would keep doctor silent
    forever under e.g. persistent quota exhaustion)."""
    degraded = _rows(events, "node", "slice degraded")
    if not degraded:
        return None

    def _last_ts(source, message):
        out: Dict[str, float] = {}
        for r in _rows(events, source, message):
            sid = r.get("entity_id")
            out[sid] = max(out.get(sid, 0.0), float(r.get("ts") or 0.0))
        return out

    replaced = _last_ts("autoscaler", "slice replaced")
    started = _last_ts("autoscaler", "slice replacement started")
    failed = _last_ts("autoscaler", "slice replacement failed")
    last_degraded: Dict[str, dict] = {}
    for r in degraded:
        sid = r.get("entity_id")
        if (sid not in last_degraded
                or float(r.get("ts") or 0.0)
                >= float(last_degraded[sid].get("ts") or 0.0)):
            last_degraded[sid] = r

    def _open(sid, row):
        ts = float(row.get("ts") or 0.0)
        if replaced.get(sid, -1.0) >= ts:
            return False  # repair landed
        in_flight = (started.get(sid, -1.0) >= ts
                     and failed.get(sid, -1.0) < started.get(sid, -1.0))
        return not in_flight

    open_rows = [r for sid, r in sorted(last_degraded.items())
                 if _open(sid, r)]
    if not open_rows:
        return None
    sids = ", ".join(str(r.get("entity_id")) for r in open_rows)
    return _finding(
        "slice_degraded", "ERROR",
        f"slice(s) {sids} hold dead member(s) with no replacement in "
        f"flight — any STRICT gang on them is wedged",
        open_rows,
        "replace the slice atomically (TrendAutoscaler.repair_slices / "
        "provider.replace_slice, create-before-terminate); per-host "
        "replacement cannot restore the gang lease")


def _rule_recompile_storm(events, tasks):
    """One jit function accumulating many distinct shape signatures is a
    recompile storm: every new shape pays seconds of XLA compile on the
    hot path (the classic cause: un-bucketed dynamic batch/sequence
    shapes).  The step profiler's compile events carry ``n_sigs`` per
    function, so the storm is a counter, not a guess."""
    rows = _rows(events, "perf", "jit compile")
    worst: Dict[str, dict] = {}
    for r in rows:
        d = r.get("data") or {}
        fn = str(d.get("fn", "?"))
        if fn not in worst or (d.get("n_sigs") or 0) > (
                (worst[fn].get("data") or {}).get("n_sigs") or 0):
            worst[fn] = r
    storms = [r for r in worst.values()
              if ((r.get("data") or {}).get("n_sigs") or 0)
              >= RECOMPILE_STORM_SIGS]
    if not storms:
        return None
    names = ", ".join(
        f"{(r.get('data') or {}).get('fn')} "
        f"({(r.get('data') or {}).get('n_sigs')} signatures)"
        for r in storms)
    return _finding(
        "recompile_storm", "WARNING",
        f"jit recompile storm: {names} — every new shape signature pays "
        f"a fresh XLA compile on the hot path",
        storms,
        "bucket the dynamic dimensions (pad batch/sequence to a fixed "
        "set of shapes) or hoist the varying value out of the traced "
        "arguments; see the signatures in the evidence rows")


def _rule_ingest_bound(events, tasks):
    """Training that spends a large share of every step waiting on data
    is ingest-bound — the chip idles while the input pipeline catches
    up.  Only the step profiler's phase attribution can say this: a
    step-time histogram alone cannot split waiting from computing."""
    rows = _rows(events, "perf", "step phases")
    if len(rows) < INGEST_MIN_STEPS:
        return None
    wall = ingest = 0.0
    for r in rows:
        d = r.get("data") or {}
        phases = d.get("phases") or {}
        wall += float(d.get("wall_s") or r.get("span_dur") or 0.0)
        ingest += float(phases.get("ingest") or 0.0)
    if wall <= 0:
        return None
    frac = ingest / wall
    if frac < INGEST_FRACTION:
        return None
    ev = [{"steps": len(rows), "ingest_s": round(ingest, 4),
           "wall_s": round(wall, 4), "ingest_frac": round(frac, 4)}]
    return _finding(
        "ingest_bound", "WARNING",
        f"training is ingest-bound: {frac * 100:.0f}% of step wall "
        f"({ingest:.2f}s of {wall:.2f}s over {len(rows)} steps) waits "
        f"on data",
        ev,
        "the input pipeline can't keep up: raise streaming parallelism "
        "/ prefetch_blocks, move transforms off the train host, or "
        "shard the source wider")


def _rule_prefill_interference(events, tasks):
    """Decode ticks co-scheduled with prefill chunks run long — the
    serve engine's tick meter bills that excess to the prefills.  A high
    billed share IS the decode-tail explanation (gpt2 p99/p50=1.39x):
    bound it with chunked prefill or an interleave budget."""
    rows = _rows(events, "perf", "prefill interference")
    # latest meter state per (origin, engine): engine ids are per-process
    # (pids collide across hosts), so the shipping origin must qualify
    # the key or one replica's healthy meter shadows another's pathology
    latest: Dict[tuple, dict] = {}
    for r in rows:
        eid = (str(r.get("origin") or "head"), str(r.get("entity_id")))
        if eid not in latest or float(r.get("ts") or 0.0) >= float(
                latest[eid].get("ts") or 0.0):
            latest[eid] = r
    flagged = []
    for r in latest.values():
        d = r.get("data") or {}
        if (d.get("interleaved_ticks") or 0) >= PREFILL_MIN_TICKS \
                and (d.get("interference_frac") or 0.0) \
                >= PREFILL_INTERFERENCE_FRAC:
            flagged.append(r)
    if not flagged:
        return None
    worst = max((r.get("data") or {}).get("interference_frac", 0.0)
                for r in flagged)
    return _finding(
        "prefill_interference", "WARNING",
        f"prefill chunks are billed {worst * 100:.0f}% of decode tick "
        f"time on {len(flagged)} engine(s) — the decode tail is "
        f"prefill interference, not decode variance",
        flagged,
        "bound the interleave: chunk prefills smaller, cap admissions "
        "per tick, or disaggregate prefill onto its own replica "
        "(serve.llm.prefill_decode_graph)")


# ---------------------------------------------------------------------------
# trend rules (each: series_map -> finding | None).  series_map is
# {metric_name: [{"tags": {...}, "points": [[ts, value], ...]}, ...]} —
# the shape `query_metric` returns, so the rules run identically over a
# live TSDB and synthetic fixtures.
# ---------------------------------------------------------------------------

def _slope_per_min(points) -> float:
    """Least-squares slope in value-units per minute."""
    n = len(points)
    if n < 2:
        return 0.0
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]
    mx = sum(xs) / n
    my = sum(ys) / n
    den = sum((x - mx) ** 2 for x in xs)
    if den <= 0:
        return 0.0
    return sum((x - mx) * (y - my) for x, y in points) / den * 60.0


def _monotone_frac(points) -> float:
    deltas = [b[1] - a[1] for a, b in zip(points, points[1:])]
    if not deltas:
        return 0.0
    return sum(1 for d in deltas if d > 0) / len(deltas)


def _trend_rule_rss_growth(series_map):
    """A worker whose RSS climbs monotonically for the whole window is
    leaking (or unboundedly caching) — a snapshot can't see it, a slope
    can."""
    worst = None
    for s in series_map.get("ray_tpu_proc_rss_mb", ()):
        pts = s.get("points") or []
        if len(pts) < TREND_MIN_POINTS:
            continue
        growth = pts[-1][1] - pts[0][1]
        slope = _slope_per_min(pts)
        mono = _monotone_frac(pts)
        if (slope >= RSS_SLOPE_MB_PER_MIN and growth >= RSS_GROWTH_MIN_MB
                and mono >= RSS_MONOTONE_FRAC):
            row = {"tags": s.get("tags", {}), "slope_mb_per_min": round(slope, 2),
                   "growth_mb": round(growth, 1), "monotone_frac": round(mono, 2),
                   "window_points": len(pts)}
            if worst is None or slope > worst["slope_mb_per_min"]:
                worst = row
    if worst is None:
        return None
    who = worst["tags"].get("worker_id", "?")
    return _finding(
        "rss_growth", "WARNING",
        f"process {who} RSS grew {worst['growth_mb']:.0f}MB at "
        f"{worst['slope_mb_per_min']:.1f}MB/min, "
        f"{worst['monotone_frac'] * 100:.0f}% monotone — memory leak "
        "suspect",
        [worst],
        "a worker/actor is accumulating memory: check for unbounded "
        "caches or growing actor state; restart_policy/max_calls bound "
        "the blast radius while you find it")


def _trend_rule_store_leak(series_map):
    """Object-store bytes climbing steadily means refs are being created
    faster than released — the 'who owns these 6 GiB' precursor."""
    for name in ("ray_tpu_object_store_bytes", "ray_tpu_arena_bytes_used"):
        for s in series_map.get(name, ()):
            pts = s.get("points") or []
            if len(pts) < TREND_MIN_POINTS:
                continue
            growth_mb = (pts[-1][1] - pts[0][1]) / (1 << 20)
            slope_mb = _slope_per_min(pts) / (1 << 20)
            if (slope_mb >= STORE_SLOPE_MB_PER_MIN
                    and growth_mb >= STORE_GROWTH_MIN_MB
                    and _monotone_frac(pts) >= RSS_MONOTONE_FRAC):
                ev = {"metric": name, "tags": s.get("tags", {}),
                      "slope_mb_per_min": round(slope_mb, 2),
                      "growth_mb": round(growth_mb, 1)}
                return _finding(
                    "object_store_leak", "WARNING",
                    f"{name} grew {growth_mb:.0f}MB at "
                    f"{slope_mb:.1f}MB/min without receding — object "
                    "refs are outliving their use",
                    [ev],
                    "run `ray_tpu_torch memory` to see which owner holds the "
                    "bytes; del refs promptly, or stream instead of "
                    "materializing")
    return None


def _trend_rule_queue_climb(series_map):
    """A queue that never drains AND keeps climbing is demand outrunning
    capacity — backlog, not burst."""
    for s in series_map.get("ray_tpu_sched_queue_depth", ()):
        pts = s.get("points") or []
        if len(pts) < TREND_MIN_POINTS:
            continue
        lo = min(p[1] for p in pts)
        first = max(pts[0][1], QUEUE_CLIMB_MIN_DEPTH)
        last = pts[-1][1]
        if (lo >= QUEUE_CLIMB_MIN_DEPTH and last >= first * QUEUE_CLIMB_RATIO
                and _slope_per_min(pts) > 0):
            ev = {"tags": s.get("tags", {}), "min_depth": lo,
                  "start_depth": pts[0][1], "end_depth": last,
                  "slope_per_min": round(_slope_per_min(pts), 2)}
            return _finding(
                "queue_depth_climb", "WARNING",
                f"scheduler queue climbed {pts[0][1]:.0f} -> {last:.0f} "
                f"without ever draining below {lo:.0f} — sustained "
                "overload, not a burst",
                [ev],
                "demand exceeds cluster capacity: add nodes, lower "
                "submission rate, or batch smaller tasks into fewer "
                "larger ones")
    return None


def _trend_rule_mfu_regression(series_map):
    """Live MFU sagging against its own trailing history: the step
    profiler's per-step MFU gauge makes "the run got slower" a measured
    regression instead of an end-of-run surprise.  Compares the trailing
    quarter of the window against the earlier mean — a sustained drop,
    not a single slow step."""
    worst = None
    for s in series_map.get("ray_tpu_train_step_mfu", ()):
        pts = s.get("points") or []
        if len(pts) < 2 * TREND_MIN_POINTS:
            continue
        half = pts[:len(pts) // 2]
        tail = pts[-max(3, len(pts) // 4):]
        earlier = sum(p[1] for p in half) / len(half)
        trailing = sum(p[1] for p in tail) / len(tail)
        if earlier < MFU_MIN_LEVEL:
            continue
        drop = 1.0 - trailing / earlier
        if drop < MFU_DROP_FRAC:
            continue
        row = {"tags": s.get("tags", {}),
               "earlier_mfu": round(earlier, 4),
               "trailing_mfu": round(trailing, 4),
               "drop_frac": round(drop, 4),
               "window_points": len(pts)}
        if worst is None or drop > worst["drop_frac"]:
            worst = row
    if worst is None:
        return None
    return _finding(
        "mfu_regression", "WARNING",
        f"live MFU regressed {worst['drop_frac'] * 100:.0f}%: "
        f"{worst['earlier_mfu']:.3f} -> {worst['trailing_mfu']:.3f} "
        f"over the trailing window",
        [worst],
        "something slowed the step mid-run: check `ray_tpu_torch perf` for a "
        "phase that grew (ingest? collective? a recompile storm?), HBM "
        "pressure, or a straggler rank")


def _trend_rule_gil_saturation(series_map):
    """A process whose continuous profiler keeps reporting high tick
    lateness is core-bound: its threads sit runnable behind the GIL.
    This is the measured number behind ROADMAP's "core-bound" label —
    sustained, not one hot burst."""
    worst = None
    for s in series_map.get("ray_tpu_gil_lateness_frac", ()):
        pts = s.get("points") or []
        if len(pts) < GIL_MIN_POINTS:
            continue
        tail = pts[-GIL_MIN_POINTS:]
        if min(p[1] for p in tail) < GIL_SATURATION_FRAC:
            continue
        mean = sum(p[1] for p in tail) / len(tail)
        row = {"tags": s.get("tags", {}), "mean_frac": round(mean, 3),
               "window_points": len(pts)}
        if worst is None or mean > worst["mean_frac"]:
            worst = row
    if worst is None:
        return None
    who = worst["tags"].get("origin", "a process")
    return _finding(
        "gil_saturation", "WARNING",
        f"{who} spends {worst['mean_frac'] * 100:.0f}% of sampled wall "
        "waiting for the GIL — the process is core-bound, threads will "
        "not help",
        [worst],
        "one interpreter core is the ceiling: move work into more "
        "worker processes, or — if this is the head — ROADMAP item 3 "
        "(native dispatch) is the structural fix; `ray_tpu_torch profile "
        "--live --origin <who>` shows which frames own the core")


def _trend_rule_lock_contention(series_map):
    """A named lock whose measured wait outruns the hold behind it is a
    convoy: threads queue faster than the critical section drains.
    make_lock's timing plane measures both sides, so the ratio is
    arithmetic, not inference."""
    # cumulative gauges: the window's cost is last - first per series
    def _delta(name, tags):
        for s in series_map.get(name, ()):
            if s.get("tags") == tags:
                pts = s.get("points") or []
                if len(pts) >= 2:
                    return max(0.0, pts[-1][1] - pts[0][1])
        return 0.0

    worst = None
    for s in series_map.get("ray_tpu_lock_wait_s", ()):
        pts = s.get("points") or []
        if len(pts) < 2:
            continue
        tags = s.get("tags", {})
        wait = max(0.0, pts[-1][1] - pts[0][1])
        if wait < LOCK_WAIT_MIN_S:
            continue
        hold = _delta("ray_tpu_lock_hold_s", tags)
        ratio = wait / max(hold, 1e-6)
        if ratio < LOCK_WAIT_HOLD_RATIO:
            continue
        row = {"tags": tags, "wait_s": round(wait, 3),
               "hold_s": round(hold, 3), "ratio": round(ratio, 1)}
        if worst is None or wait > worst["wait_s"]:
            worst = row
    if worst is None:
        return None
    name = worst["tags"].get("lock", "?")
    if name.startswith(("node.", "profile_store")):
        remedy = (
            "the head control plane is convoying on its own lock — "
            "ROADMAP item 3 (native dispatch: refcounts and dispatch "
            "off the GIL) is the structural fix; until then shrink the "
            "critical section or shard the state it guards")
    else:
        remedy = (
            "threads queue on this lock faster than its critical "
            "section drains: shrink what runs under it, shard the "
            "guarded state, or hand the work to a single owner thread")
    return _finding(
        "lock_contention", "WARNING",
        f"lock {name}: threads waited {worst['wait_s']:.1f}s behind "
        f"{worst['hold_s']:.1f}s of holds ({worst['ratio']:.0f}x) over "
        "the window — a convoy",
        [worst], remedy)


def _trend_rule_serialization_hot(series_map):
    """Serialization frames owning a large share of all sampled busy
    time means the cluster ships bytes instead of doing work — the
    continuous profiler sees it cluster-wide, without anyone asking for
    a profile."""
    for s in series_map.get("ray_tpu_profile_serialization_frac", ()):
        pts = s.get("points") or []
        if len(pts) < GIL_MIN_POINTS:
            continue
        tail = pts[-GIL_MIN_POINTS:]
        if min(p[1] for p in tail) < SERIALIZATION_HOT_FRAC:
            continue
        mean = sum(p[1] for p in tail) / len(tail)
        ev = {"tags": s.get("tags", {}), "serialize_frac": round(mean, 3),
              "window_points": len(pts)}
        return _finding(
            "serialization_hot", "WARNING",
            f"{mean * 100:.0f}% of sampled busy time cluster-wide is "
            "serialization — the workload ships bytes instead of "
            "computing",
            [ev],
            "pass object refs instead of values, move big transfers "
            "onto the data plane (ROADMAP item 5: channel transport), "
            "and check `ray_tpu_torch profile --live` for the pickle-heavy "
            "call sites")
    return None


TREND_RULES = (
    _trend_rule_rss_growth,
    _trend_rule_store_leak,
    _trend_rule_queue_climb,
    _trend_rule_mfu_regression,
    _trend_rule_gil_saturation,
    _trend_rule_lock_contention,
    _trend_rule_serialization_hot,
)

# metric names the live doctor pulls from the TSDB for the trend pass
TREND_METRICS = (
    "ray_tpu_proc_rss_mb",
    "ray_tpu_object_store_bytes",
    "ray_tpu_arena_bytes_used",
    "ray_tpu_sched_queue_depth",
    "ray_tpu_train_step_mfu",
    "ray_tpu_gil_lateness_frac",
    "ray_tpu_lock_wait_s",
    "ray_tpu_lock_hold_s",
    "ray_tpu_profile_serialization_frac",
)


def diagnose_trends(series_map: Dict[str, list]) -> List[dict]:
    """Run the trend rules over queried series (same finding shape as
    :func:`diagnose`; pure — feed it synthetic series in tests)."""
    findings = []
    for rule in TREND_RULES:
        f = rule(series_map)
        if f is not None:
            findings.append(f)
    findings.sort(key=lambda f: _SEV_ORDER.get(f["severity"], 9))
    return findings


RULES = (
    _rule_oom_kills,
    _rule_slice_degraded,
    _rule_gang_restart,
    _rule_stuck_channel,
    _rule_backpressure_stall,
    _rule_split_starvation,
    _rule_spill_thrash,
    _rule_router_saturation,
    _rule_ingress_shedding,
    _rule_drain_stuck,
    _rule_tenant_killed,
    _rule_worker_churn,
    _rule_log_error_burst,
    _rule_worker_stderr_at_death,
    _rule_slow_node_skew,
    _rule_recompile_storm,
    _rule_ingest_bound,
    _rule_prefill_interference,
)


def diagnose(events: Sequence[dict],
             tasks: Sequence[dict] = ()) -> List[dict]:
    """Run every rule over recorded events + task rows; returns findings
    sorted by severity (an empty list IS the healthy verdict)."""
    findings = []
    for rule in RULES:
        f = rule(events, tasks)
        if f is not None:
            findings.append(f)
    findings.sort(key=lambda f: _SEV_ORDER.get(f["severity"], 9))
    return findings


class DoctorState:
    """Incremental doctor evaluation — the watchdog-tick path.

    Instead of re-pulling up to 100k event rows per evaluation, the state
    holds a bounded trailing window of rows and ``feed()`` pulls only the
    *delta* since the last look via cursors: the head ``EventTable``'s
    ingest version and the process-local ring's seq.  ``diagnose()``
    re-runs the rule set only when new rows arrived (dirty flag) — an
    idle cluster's tick costs two cursor compares, not a diagnosis.

    Shared by the watchdog tick and the head's ``doctor_report`` RPC so
    the on-demand CLI and the continuous loop read one path."""

    def __init__(self, window_rows: int = 20_000,
                 event_window_s: Optional[float] = None):
        from collections import deque

        self._rows: "deque[dict]" = deque(maxlen=max(100, int(window_rows)))
        self._table_cursor = 0
        self._local_seq = 0
        self._dirty = True
        self._findings: List[dict] = []
        # sliding TIME window: with it set, diagnose() only sees rows
        # newer than now - event_window_s, so a finding whose evidence
        # aged out goes clear and its incident can auto-resolve.  Without
        # it (the one-shot RPC path) the full retained window is read.
        self._event_window_s = event_window_s

    def feed(self, table=None, local=None) -> bool:
        """Pull event deltas from the head EventTable and/or a local
        EventBuffer; returns True when anything new arrived."""
        new = False
        if table is not None:
            rows, self._table_cursor = table.since(self._table_cursor)
            if rows:
                self._rows.extend(rows)
                new = True
        if local is not None:
            rows = local.since(self._local_seq)
            if rows:
                self._local_seq = max(r.get("seq", 0) for r in rows)
                self._rows.extend(rows)
                new = True
        if new:
            self._dirty = True
        return new

    def feed_rows(self, rows: Sequence[dict]) -> None:
        """Direct row injection (tests / custom gathers)."""
        if rows:
            self._rows.extend(rows)
            self._dirty = True

    def diagnose(self, tasks: Sequence[dict] = (),
                 force: bool = False,
                 now: Optional[float] = None) -> List[dict]:
        """Event-rule findings over the current window; cached until the
        next ``feed()`` delta (``force=True`` re-runs regardless, e.g.
        when the task table changed without an event).  A time-windowed
        state re-runs whenever it holds rows — the window's trailing edge
        moves even when no new event arrives."""
        if self._event_window_s:
            if now is None:
                now = time.time()
            horizon = now - self._event_window_s
            # drop aged-out rows for good: the deque is append-only in
            # time, so popping from the left is exact
            while self._rows and self._rows[0].get("ts", now) < horizon:
                self._rows.popleft()
                self._dirty = True
            if self._dirty or force or self._findings:
                # table + local rows interleave slightly out of ts order,
                # so filter the survivors too (exact window, not just the
                # deque's left edge)
                rows = [r for r in self._rows
                        if r.get("ts", now) >= horizon]
                self._findings = diagnose(rows, tasks)
                self._dirty = False
        elif self._dirty or force:
            # the window holds table + local rows in arrival order; the
            # rules themselves sort nothing and tolerate interleaving
            self._findings = diagnose(list(self._rows), tasks)
            self._dirty = False
        return list(self._findings)

    @property
    def dirty(self) -> bool:
        return self._dirty

    def window_len(self) -> int:
        return len(self._rows)


def head_report(events_table, local_buffer, tsdb,
                tasks: Sequence[dict] = (),
                state: Optional[DoctorState] = None,
                trend_window_s: float = 1800.0) -> List[dict]:
    """One full doctor pass over HEAD-LOCAL tables — zero state-API
    pulls.  ``state`` carries the incremental window between calls (the
    watchdog's persistent DoctorState); without one, an ephemeral state
    reads the tables' full retained history (the ``doctor_report`` RPC's
    cold path, still head-local)."""
    st = state if state is not None else DoctorState()
    st.feed(table=events_table, local=local_buffer)
    findings = st.diagnose(tasks, force=state is None)
    series_map: Dict[str, list] = {}
    if tsdb is not None:
        for name in TREND_METRICS:
            try:
                q = tsdb.query(name, window_s=trend_window_s)
                series_map[name] = q.get("series", [])
            except Exception:  # noqa: BLE001 — a metric with no samples
                continue
    findings = findings + diagnose_trends(series_map)
    findings.sort(key=lambda f: _SEV_ORDER.get(f["severity"], 9))
    return findings


def run_doctor(trend_window_s: float = 1800.0) -> List[dict]:
    """Diagnose the live cluster.  The head runs the full pass over its
    own tables (one ``doctor_report`` RPC); the client receives only the
    findings.  A failure at the head raises here."""
    from ray_tpu_torch.experimental.state import api as state

    return state.doctor_report(trend_window_s=trend_window_s)


def render(findings: List[dict]) -> str:
    """The doctor's report as text (what ``ray_tpu_torch doctor`` prints)."""
    if not findings:
        return ("ray_tpu_torch doctor: no findings — recorded state shows no "
                "known pathology.")
    out = [f"ray_tpu_torch doctor: {len(findings)} finding(s)\n"]
    for f in findings:
        out.append(f"[{f['severity']}] {f['rule']}: {f['summary']}")
        out.append(f"  remedy: {f['remedy']}")
        for ev in f["evidence"][:3]:
            desc = {k: v for k, v in ev.items()
                    if k in ("ts", "message", "entity_id", "origin",
                             "data", "name", "slow", "fast", "ratio",
                             "tags", "metric", "slope_mb_per_min",
                             "growth_mb", "monotone_frac", "min_depth",
                             "start_depth", "end_depth", "slope_per_min",
                             "steps", "ingest_s", "wall_s", "ingest_frac",
                             "earlier_mfu", "trailing_mfu", "drop_frac",
                             "mean_frac", "wait_s", "hold_s",
                             "serialize_frac", "window_points",
                             "incident_id", "bundle_dir", "threshold")}
            out.append(f"  evidence: {desc}")
        if f["count"] > 3:
            out.append(f"  ... {f['count'] - 3} more evidence row(s)")
        out.append("")
    return "\n".join(out).rstrip()
