"""ray_tpu_torch CLI — ``ray start/stop/status/...`` analog.

Reference: ``python/ray/scripts/scripts.py`` (cluster lifecycle) and
``dashboard/modules/job/cli.py`` (job commands).  Run as
``python -m ray_tpu_torch <command>``:

    start --head [--num-cpus N --num-gpus N]   run a head in the foreground
    start --address host:port [--authkey HEX]  join as a worker node agent
    up CONFIG / down CONFIG                    launch / tear down a YAML cluster
    stop                                       stop the last started head
    status                                     cluster resources/state
    list {actors,tasks,nodes,objects,workers,placement_groups,jobs,traces}
    submit [--wait] -- <entrypoint...>         submit a job
    job-logs <job_id> / job-stop <job_id>
    timeline [--out FILE]                      chrome-trace of task events
    events [--source S --severity L --limit N] flight-recorder event table
    trace [TRACE_ID] [--json]                  recent traces, or one trace
    serve-status                               serve deployments + autoscaling
    doctor [--json]                            pathology findings (exit 1 on any)
    top [--interval S --iterations N --sort K] live nodes/workers resource view
    memory [--limit N --json]                  object-ownership audit
    metrics [NAME --window S --step S --agg A] TSDB directory, or one series
    perf [--window S --json]                   step phases, MFU, card memory

Every command but ``start``, ``up``, ``down`` and ``stop`` talks to the
cluster named by ``$RAY_TPU_TORCH_ADDRESS`` (``tcp://host:port``, with
``$RAY_TPU_TORCH_AUTHKEY``) when it is set, else to the last head started
on this host (its session record under the temp directory).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time


def _record_path() -> str:
    from ray_tpu_torch._private.config import session_root

    return os.path.join(session_root(), "last_session.json")


def _record() -> dict:
    try:
        with open(_record_path()) as f:
            return json.load(f)
    except OSError:
        raise SystemExit("no running ray_tpu_torch session found (start one with "
                         "`python -m ray_tpu_torch start --head`)")


def _session() -> dict:
    """``{"address", "authkey"}`` of the cluster this command talks to."""
    address = os.environ.get("RAY_TPU_TORCH_ADDRESS", "")
    if address.startswith("tcp://"):
        return {"address": address, "authkey": os.environ["RAY_TPU_TORCH_AUTHKEY"]}
    return _record()


def _connect():
    import ray_tpu_torch

    if not ray_tpu_torch.is_initialized():
        sess = _session()
        ray_tpu_torch.init(address=sess["address"],
                           _authkey=bytes.fromhex(sess["authkey"]))
    return ray_tpu_torch


def _job_client():
    from ray_tpu_torch.job_submission import JobSubmissionClient

    sess = _session()
    return JobSubmissionClient(sess["address"], authkey=bytes.fromhex(sess["authkey"]))


def _exit_on_sigterm() -> None:
    """SIGTERM (``stop``, ``down``) unwinds through the ``finally``
    blocks, so the head or agent stops its workers and jobs first."""
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))


def cmd_start(args) -> None:
    if args.head:
        import ray_tpu_torch

        _exit_on_sigterm()
        ray_tpu_torch.init(num_cpus=args.num_cpus, num_gpus=args.num_gpus)
        from ray_tpu_torch._private.worker import global_worker

        node = global_worker.node
        host, port = node.tcp_address
        print(f"ray_tpu_torch head running: tcp://{host}:{port}")
        print(f"authkey: {node.authkey.hex()}")
        print("join with: python -m ray_tpu_torch start "
              f"--address {host}:{port} --authkey {node.authkey.hex()}")
        print("Ctrl-C to stop.", flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            ray_tpu_torch.shutdown()
    elif args.address:
        from ray_tpu_torch._private.node_agent import NodeAgent

        _exit_on_sigterm()
        authkey = bytes.fromhex(args.authkey or os.environ["RAY_TPU_TORCH_AUTHKEY"])
        agent = NodeAgent(
            args.address, authkey, num_cpus=args.num_cpus,
            num_gpus=args.num_gpus, shm_dir=args.shm_dir,
        )
        agent.serve_forever()
    else:
        raise SystemExit("start needs --head or --address")


def cmd_up(args) -> None:
    """``ray up`` analog: start head + join workers per the YAML."""
    from ray_tpu_torch.autoscaler.commands import load_cluster_config, up

    out = up(load_cluster_config(args.config))
    print(json.dumps(out, indent=2))
    print(f"cluster up: {out['address']} "
          f"({len(out['workers'])} worker nodes joining)")


def cmd_down(args) -> None:
    from ray_tpu_torch.autoscaler.commands import down, load_cluster_config

    down(load_cluster_config(args.config))
    print("cluster down")


def cmd_stop(_args) -> None:
    sess = _record()
    pid = sess.get("pid")
    try:
        os.kill(pid, signal.SIGTERM)
        print(f"sent SIGTERM to head pid {pid}")
    except OSError as e:
        print(f"head pid {pid}: {e}")


def cmd_status(_args) -> None:
    _connect()
    from ray_tpu_torch._private.worker import global_worker

    snap = global_worker.client.state_snapshot()
    print(json.dumps({
        "cluster_resources": snap["cluster_resources"],
        "available_resources": snap["available_resources"],
        "object_store": snap["object_store"],
        "nodes": len(snap["nodes"]),
        "actors": len(snap["actors"]),
        "tasks": len(snap["tasks"]),
    }, indent=2, default=repr))


def cmd_list(args) -> None:
    _connect()
    from ray_tpu_torch.experimental.state import api as state

    page = state.list_state_page(args.what, limit=args.limit)
    print(json.dumps(page["rows"], indent=2, default=repr))
    if page["truncated"]:
        # loud, and on stderr so piped JSON stays parseable — a capped
        # listing must never masquerade as the complete table
        print(f"# truncated: showing {len(page['rows'])} of "
              f"{page['total']} rows (use --limit {page['total']})",
              file=sys.stderr)


def cmd_submit(args) -> None:
    client = _job_client()
    import shlex

    parts = args.entrypoint
    if parts and parts[0] == "--":  # argparse.REMAINDER keeps the separator
        parts = parts[1:]
    entry = shlex.join(parts)  # preserve each argv token through the shell
    job_id = client.submit_job(entrypoint=entry)
    print(f"submitted {job_id}: {entry}")
    if args.wait:
        status = client.wait_until_finish(job_id, timeout=args.timeout)
        print(client.get_job_logs(job_id), end="")
        print(f"job {job_id}: {status}")
        sys.exit(0 if status == "SUCCEEDED" else 1)


def cmd_job_logs(args) -> None:
    """The job driver's log, as the head's JobManager captured it."""
    print(_job_client().get_job_logs(args.job_id), end="")


def cmd_job_stop(args) -> None:
    print("stopped" if _job_client().stop_job(args.job_id) else "not running")


def cmd_timeline(args) -> None:
    _connect()
    from ray_tpu_torch.util.timeline import timeline_dump

    path = timeline_dump(args.out)
    print(f"wrote chrome trace to {path} (open in chrome://tracing)")


def cmd_events(args) -> None:
    """Flight-recorder events (``ray list cluster-events`` analog): the
    head's merged per-source event table — dispatch decisions, spills,
    OOM kills, stalls, admissions — as JSON lines or a summary."""
    _connect()
    from ray_tpu_torch.experimental.state import api as state

    if args.summary:
        print(json.dumps(state.summarize_events(), indent=2))
        return
    rows = state.list_events(limit=args.limit, source=args.source,
                             severity=args.severity)
    for r in rows:
        print(json.dumps(r, default=repr))


def cmd_trace(args) -> None:
    """Request traces: without an id, list recent traces; with one and
    ``--json``, the assembled spans.  The rendered span tree with its
    critical path is not ported."""
    _connect()
    from ray_tpu_torch.experimental.state import api as state

    if not args.trace_id:
        rows = state.list_traces(limit=args.limit)
        if args.json:
            print(json.dumps(rows, indent=2, default=repr))
            return
        if not rows:
            print("(no traces recorded — run a workload inside "
                  "ray_tpu_torch.util.tracing.trace(), or send serve traffic)")
            return
        for r in rows:
            print(f"{r['trace_id']}  {r['duration_s'] * 1e3:9.2f}ms  "
                  f"{r['num_spans']:4d} spans  {r['name']}")
        return
    if not args.json:
        raise SystemExit("ray_tpu_torch renders no span tree yet; "
                         "use `trace TRACE_ID --json`")
    trace = state.get_trace(args.trace_id)
    if trace is None:
        raise SystemExit(f"unknown trace {args.trace_id!r} (see "
                         f"`ray_tpu_torch trace` for recent ids)")
    print(json.dumps(trace, indent=2, default=repr))


def cmd_serve_status(_args) -> None:
    """``serve status`` analog over the running cluster."""
    rt = _connect()
    from ray_tpu_torch.serve._private.controller import (
        CONTROLLER_NAME, SERVE_NAMESPACE)

    try:
        controller = rt.get_actor(CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
    except Exception:
        print(json.dumps({}))  # serve not running
        return
    status = rt.get(controller.get_status.remote(), timeout=30)
    # submit all metric fetches, one shared deadline (a slow controller
    # costs one timeout, not one per deployment)
    refs = {n: controller.get_autoscaling_metrics.remote(n) for n in status}
    try:
        metrics = rt.get(list(refs.values()), timeout=10)
        for (name, _), m in zip(refs.items(), metrics):
            status[name]["autoscaling_metrics"] = m
    except Exception as e:  # noqa: BLE001
        status["_autoscaling_metrics_error"] = f"{type(e).__name__}: {e}"
    try:
        goal = rt.get(controller.get_deploy_config.remote(), timeout=10)
        if goal:  # goal (declarative config) vs actual (status above)
            status["_goal_config"] = goal
    except Exception:
        pass
    print(json.dumps(status, indent=2, default=repr))


def cmd_doctor(args) -> None:
    """Rule-based pathology analysis over the recorded event/task state
    and the head's TSDB trends; exits non-zero when findings exist so CI
    can gate on it."""
    _connect()
    from ray_tpu_torch.util.doctor import render, run_doctor

    findings = run_doctor()
    if args.json:
        print(json.dumps(findings, indent=2, default=repr))
    else:
        print(render(findings))
    if findings:
        sys.exit(1)


def _fmt_bytes(n) -> str:
    n = float(n or 0)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if n < 1024 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}TiB"


def _render_hbm_rows(hbm) -> list:
    """Device-memory watermark table lines (shared by ``top`` and
    ``perf`` — one formatter, so the two surfaces can never disagree)."""
    out = [f"{'DEVICE MEMORY':<30} {'IN-USE':>10} {'LIMIT':>10} "
           f"{'PEAK':>10}"]
    for row in hbm:
        t = row.get("tags", {})
        label = (f"{t.get('kind', '?')}/dev{t.get('device', '?')} "
                 f"@{t.get('origin', 'head')}")
        limit = row.get("bytes_limit")
        peak = row.get("peak_bytes_in_use")
        out.append(
            f"{label[:29]:<30} "
            f"{_fmt_bytes(row.get('bytes_in_use')):>10} "
            f"{_fmt_bytes(limit) if limit is not None else '-':>10} "
            f"{_fmt_bytes(peak) if peak is not None else '-':>10}")
    return out


def _render_top(snap: dict, sort: str) -> str:
    """One ``top`` frame as text (htop-style, data from the head's
    per-entity sampler + ownership audit)."""
    out = []
    tasks = snap.get("tasks", {})
    store = snap.get("store", {})
    out.append(
        f"ray_tpu_torch top — nodes {len(snap['nodes'])}  "
        f"workers {len(snap['workers'])}  "
        f"tasks P/R/F: {tasks.get('PENDING', 0)}/{tasks.get('RUNNING', 0)}/"
        f"{tasks.get('FINISHED', 0)}  "
        f"store {_fmt_bytes(store.get('bytes_used'))} "
        f"in {store.get('num_objects', 0)} objects"
        + (f"  ORPHANED {_fmt_bytes(snap['orphan_bytes'])}"
           if snap.get("orphan_bytes") else ""))
    out.append("")
    out.append(f"{'NODE':<22} {'ALIVE':<6} {'UTIL':>5} {'LOAD1':>6} "
               f"{'MEM-AVAIL':>10}")
    for n in snap["nodes"]:
        hs = n.get("host_stats") or {}
        out.append(
            f"{n['node_id']:<22} {str(n['alive']):<6} "
            f"{n['utilization'] * 100:>4.0f}% "
            f"{hs.get('load_1m', 0):>6.2f} "
            f"{hs.get('mem_available_mb', 0):>8.0f}MB")
    out.append("")
    key = {"cpu": lambda w: -(w.get("cpu_pct") or 0),
           "rss": lambda w: -(w.get("rss_mb") or 0),
           "pinned": lambda w: -(w.get("pinned_bytes") or 0)}[sort]
    out.append(f"{'WORKER':<18} {'KIND':<18} {'NODE':<14} {'PID':>7} "
               f"{'STATE':<9} {'CPU%':>6} {'RSS':>9} {'FDS':>5} {'PINNED':>10}")
    for w in sorted(snap["workers"], key=key):
        kind = w.get("actor_class") or w["kind"]
        rss = w.get("rss_mb")
        cpu = w.get("cpu_pct")
        out.append(
            f"{w['worker_id'][:16]:<18} {kind[:17]:<18} "
            f"{w['node_id'][:13]:<14} {w.get('pid') or '-':>7} "
            f"{w['state']:<9} "
            f"{f'{cpu:.1f}' if cpu is not None else '-':>6} "
            f"{f'{rss:.0f}MB' if rss is not None else '-':>9} "
            f"{int(w['open_fds']) if w.get('open_fds') is not None else '-':>5} "
            f"{_fmt_bytes(w.get('pinned_bytes')):>10}")
    hbm = snap.get("hbm") or []
    if hbm:
        out.append("")
        out.extend(_render_hbm_rows(hbm))
    owners = snap.get("owners") or []
    if owners:
        out.append("")
        out.append(f"{'OWNER (pinned bytes)':<40} {'BYTES':>10} {'OBJECTS':>8}")
        for o in owners[:10]:
            label = o.get("owner_label", o["owner"])
            flag = "  [ORPHAN]" if o.get("orphan") else ""
            out.append(f"{label[:39]:<40} {_fmt_bytes(o['bytes']):>10} "
                       f"{o['objects']:>8}{flag}")
    namespaces = snap.get("namespaces") or []
    if namespaces:
        # per-tenant rollup: one row per namespace — a tenant's pinned
        # bytes and live actor count read off a single line
        out.append("")
        out.append(f"{'NAMESPACE':<28} {'BYTES':>10} {'OBJECTS':>8} "
                   f"{'ACTORS':>7} {'JOBS':>5}")
        for r in namespaces[:10]:
            out.append(f"{r['namespace'][:27]:<28} "
                       f"{_fmt_bytes(r['bytes']):>10} {r['objects']:>8} "
                       f"{r['actors']:>7} {r['jobs']:>5}")
    return "\n".join(out)


def cmd_top(args) -> None:
    """Live cluster resource view (``htop`` for the cluster): nodes,
    workers/actors sorted by CPU/RSS/pinned bytes, refreshed in place."""
    _connect()
    from ray_tpu_torch.experimental.state import api as state

    i = 0
    try:
        while True:
            frame = _render_top(state.top_snapshot(), args.sort)
            if args.iterations != 1 and sys.stdout.isatty():
                print("\x1b[2J\x1b[H", end="")  # clear + home
            print(frame)
            i += 1
            if args.iterations and i >= args.iterations:
                return
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass


def cmd_memory(args) -> None:
    """Object-ownership audit (``ray memory`` analog): bytes by owner and
    pin reason, per-object rows, orphan flags."""
    _connect()
    from ray_tpu_torch.experimental.state import api as state

    audit = state.memory_summary(limit=args.limit)
    if args.json:
        print(json.dumps(audit, indent=2, default=repr))
        return
    frac = audit["attributed_frac"] * 100.0
    print(f"ray_tpu_torch memory — {_fmt_bytes(audit['total_bytes'])} sealed in "
          f"{audit['num_objects']} objects; {frac:.1f}% attributed to an "
          f"owner; orphaned {_fmt_bytes(audit['orphan_bytes'])}")
    reasons = ", ".join(f"{r}={_fmt_bytes(b)}" for r, b in
                        sorted(audit["by_pin_reason"].items()))
    if reasons:
        print(f"pinned by: {reasons}")
    print()
    print(f"{'OWNER':<40} {'KIND':<8} {'BYTES':>10} {'OBJECTS':>8}")
    for o in audit["by_owner"]:
        flag = "  [ORPHAN: owner dead]" if o.get("orphan") else ""
        print(f"{o['owner_label'][:39]:<40} {o['owner_kind']:<8} "
              f"{_fmt_bytes(o['bytes']):>10} {o['objects']:>8}{flag}")
    namespaces = audit.get("by_namespace") or []
    if namespaces:
        print()
        print(f"{'NAMESPACE':<28} {'BYTES':>10} {'OBJECTS':>8} "
              f"{'ACTORS':>7} {'JOBS':>5}")
        for r in namespaces:
            print(f"{r['namespace'][:27]:<28} {_fmt_bytes(r['bytes']):>10} "
                  f"{r['objects']:>8} {r['actors']:>7} {r['jobs']:>5}")
    rows = audit.get("rows") or []
    if rows:
        print()
        # full object ids: they share a per-process prefix, so a truncated
        # id renders every row identical
        print(f"{'OBJECT':<34} {'SIZE':>10} {'WHERE':<10} {'OWNER':<28} "
              f"{'PIN':<10} {'AGE':>8}")
        for r in rows:
            flag = " [ORPHAN]" if r.get("orphan") else ""
            print(f"{r['object_id']:<34} {_fmt_bytes(r['size']):>10} "
                  f"{r['where'][:9]:<10} "
                  f"{r.get('owner_label', r['owner'])[:27]:<28} "
                  f"{r['pin_reason']:<10} {r['age_s']:>7.0f}s{flag}")


def cmd_metrics(args) -> None:
    """TSDB surface: without a name, the metric directory; with one, the
    queried series as JSON."""
    _connect()
    from ray_tpu_torch.experimental.state import api as state

    if not args.name:
        for m in state.list_metrics():
            print(f"{m['name']:<44} {m['type']:<10} "
                  f"{m['num_series']:>4} series  "
                  f"origins: {', '.join(m['origins'][:4])}")
        return
    result = state.query_metric(args.name, window_s=args.window,
                                step_s=args.step, agg=args.agg)
    print(json.dumps(result, indent=2))


def cmd_perf(args) -> None:
    """Performance observability report: the step-phase breakdown
    (phases sum exactly to the profiled step wall), live MFU per rank +
    the TSDB trend, the jit compile-cache table, the HBM watermark, and
    decode attribution (TTFT/ITL + prefill interference)."""
    _connect()
    from ray_tpu_torch.experimental.state import api as state

    s = state.perf_summary(window_s=args.window)
    if args.json:
        print(json.dumps(s, indent=2, default=repr))
        return
    st = s["steps"]
    out = [f"ray_tpu_torch perf — {st['count']} profiled steps, "
           f"wall {st['wall_s']:.3f}s, {st['tokens']} tokens"]
    if st["phases"]:
        out.append("")
        out.append(f"{'PHASE':<12} {'SECONDS':>10} {'SHARE':>7}")
        for name, p in st["phases"].items():
            out.append(f"{name:<12} {p['s']:>10.4f} {p['frac'] * 100:>6.1f}%")
        total = sum(p["s"] for p in st["phases"].values())
        out.append(f"{'total':<12} {total:>10.4f} {'100.0%':>7}"
                   f"  (phases sum to measured step wall)")
    if st["last_mfu"]:
        mfus = ", ".join(f"{k}={v:.4f}"
                         for k, v in sorted(st["last_mfu"].items()))
        out.append("")
        out.append(f"live MFU: {mfus}")
    for series in (s.get("mfu_trend") or [])[:4]:
        pts = series.get("points") or []
        if pts:
            out.append(f"  trend {series.get('tags', {})}: {pts[0][1]:.4f} "
                       f"-> {pts[-1][1]:.4f} over {len(pts)} samples")
    comp = s.get("compiles") or []
    if comp:
        out.append("")
        out.append(f"{'JIT FN':<24} {'ORIGIN':<10} {'COMPILES':>8} "
                   f"{'SIGS':>5} {'HITS':>8} {'COMPILE-S':>10}")
        for e in comp[:12]:
            out.append(f"{e['fn'][:23]:<24} {e['origin'][:9]:<10} "
                       f"{e['compiles']:>8} {e['n_sigs']:>5} "
                       f"{e['hits']:>8} {e['compile_s']:>10.3f}")
    hbm = s.get("hbm") or []
    if hbm:
        out.append("")
        out.extend(_render_hbm_rows(hbm))

    def _pct(h, key, digits):
        # a percentile whose mass fell in the +inf overflow bucket has
        # no honest upper bound — render "> last_bound" instead
        v = h.get(key)
        if v is not None:
            return f"<={v * 1e3:.{digits}f}ms"
        return f">{(h.get('last_bound_s') or 0) * 1e3:.{digits}f}ms"

    dec = s.get("decode") or {}
    ttft, itl = dec.get("ttft"), dec.get("itl")
    interference = dec.get("interference") or {}
    if ttft or itl or interference:
        out.append("")
        out.append("decode attribution:")
        if ttft:
            out.append(
                f"  TTFT: {ttft['count']} samples, "
                f"mean {ttft['mean_s'] * 1e3:.1f}ms, "
                f"p50{_pct(ttft, 'p50_est_s', 1)} "
                f"p99{_pct(ttft, 'p99_est_s', 1)}")
        if itl:
            out.append(
                f"  ITL:  {itl['count']} samples, "
                f"mean {itl['mean_s'] * 1e3:.2f}ms, "
                f"p50{_pct(itl, 'p50_est_s', 2)} "
                f"p99{_pct(itl, 'p99_est_s', 2)}")
        for eid, m in interference.items():
            billed = m.get("excess_billed_to_prefill")
            billed_s = (f"{billed * 100:.0f}% of tick excess billed to "
                        f"prefill" if billed is not None
                        else "excess share n/a: no decode-only baseline")
            out.append(
                f"  {eid}: interference {m.get('interference_s', 0):.3f}s "
                f"({(m.get('interference_frac') or 0) * 100:.1f}% of "
                f"decode tick time; {billed_s}) over "
                f"{m.get('interleaved_ticks')} interleaved ticks")
    if not (st["count"] or comp or hbm or ttft or itl or interference):
        out.append("(no perf data recorded — run a StepProfiler-"
                   "instrumented train loop or serve LLM traffic; see "
                   "README 'Performance observability')")
    print("\n".join(out))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="ray_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("start", help="start a head or join as a node")
    s.add_argument("--head", action="store_true")
    s.add_argument("--address", default=None, help="head host:port to join")
    s.add_argument("--authkey", default=None)
    s.add_argument("--num-cpus", type=int, default=None)
    s.add_argument("--num-gpus", type=int, default=None,
                   help="cards this node offers (counted with nvidia-smi when unset)")
    s.add_argument("--shm-dir", default=None)
    s.set_defaults(fn=cmd_start)

    s = sub.add_parser("up", help="launch a cluster from a YAML spec")
    s.add_argument("config", help="cluster YAML (see autoscaler/commands.py)")
    s.set_defaults(fn=cmd_up)

    s = sub.add_parser("down", help="tear down a YAML-launched cluster")
    s.add_argument("config")
    s.set_defaults(fn=cmd_down)

    sub.add_parser("stop", help="stop the last started head").set_defaults(fn=cmd_stop)
    sub.add_parser("status", help="cluster summary").set_defaults(fn=cmd_status)

    s = sub.add_parser("list", help="state API tables")
    s.add_argument("what", choices=["actors", "tasks", "nodes", "objects",
                                    "workers", "placement_groups", "jobs",
                                    "traces"])
    s.add_argument("--limit", type=int, default=100)
    s.set_defaults(fn=cmd_list)

    s = sub.add_parser("submit", help="submit a job entrypoint")
    s.add_argument("--wait", action="store_true")
    s.add_argument("--timeout", type=float, default=600.0)
    s.add_argument("entrypoint", nargs=argparse.REMAINDER)
    s.set_defaults(fn=cmd_submit)

    s = sub.add_parser("job-logs")
    s.add_argument("job_id")
    s.set_defaults(fn=cmd_job_logs)

    s = sub.add_parser("job-stop")
    s.add_argument("job_id")
    s.set_defaults(fn=cmd_job_stop)

    s = sub.add_parser("timeline", help="dump chrome-trace task timeline")
    s.add_argument("--out", default=None)
    s.set_defaults(fn=cmd_timeline)

    s = sub.add_parser(
        "events", help="flight-recorder events (cluster event table)")
    s.add_argument("--source", default=None,
                   help="filter: scheduler|object_store|streaming|serve|"
                        "train|actor|worker_pool|node|collective|"
                        "serve_llm|compiled_dag|trace|syncer|chaos|"
                        "autoscaler|perf|rllib")
    s.add_argument("--severity", default=None,
                   help="filter: DEBUG|INFO|WARNING|ERROR")
    s.add_argument("--limit", type=int, default=200)
    s.add_argument("--summary", action="store_true",
                   help="counts by source/severity instead of rows")
    s.set_defaults(fn=cmd_events)

    s = sub.add_parser(
        "trace", help="request traces: list, or one trace's spans (--json)")
    s.add_argument("trace_id", nargs="?", default=None)
    s.add_argument("--limit", type=int, default=20)
    s.add_argument("--json", action="store_true")
    s.set_defaults(fn=cmd_trace)

    sub.add_parser(
        "serve-status", help="serve deployments + autoscaling state"
    ).set_defaults(fn=cmd_serve_status)

    s = sub.add_parser(
        "doctor",
        help="pathology analysis over recorded events/tasks and TSDB "
             "trends (exit 1 on findings)")
    s.add_argument("--json", action="store_true")
    s.set_defaults(fn=cmd_doctor)

    s = sub.add_parser(
        "top", help="live cluster resource view (nodes, workers, pinned "
                    "bytes, card memory; Ctrl-C to exit)")
    s.add_argument("--interval", type=float, default=2.0)
    s.add_argument("--iterations", type=int, default=0,
                   help="frames to render (0 = forever); 1 prints once")
    s.add_argument("--sort", choices=["cpu", "rss", "pinned"], default="cpu")
    s.set_defaults(fn=cmd_top)

    s = sub.add_parser(
        "memory",
        help="object-ownership audit: bytes by owner/pin reason (`ray "
             "memory` analog)")
    s.add_argument("--limit", type=int, default=20,
                   help="per-object rows to show (aggregates cover all)")
    s.add_argument("--json", action="store_true")
    s.set_defaults(fn=cmd_memory)

    s = sub.add_parser(
        "metrics", help="metrics TSDB: directory, or query one series")
    s.add_argument("name", nargs="?", default=None)
    s.add_argument("--window", type=float, default=3600.0)
    s.add_argument("--step", type=float, default=0.0)
    s.add_argument("--agg", choices=["last", "max", "min", "sum", "avg",
                                     "count"], default=None)
    s.set_defaults(fn=cmd_metrics)

    s = sub.add_parser(
        "perf",
        help="performance observability: step-phase breakdown, live "
             "MFU + trend, compile-cache table, card memory, decode "
             "TTFT/ITL + prefill interference")
    s.add_argument("--window", type=float, default=1800.0,
                   help="MFU-trend window seconds (TSDB query)")
    s.add_argument("--json", action="store_true")
    s.set_defaults(fn=cmd_perf)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
