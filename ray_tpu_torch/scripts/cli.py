"""ray_tpu_torch CLI — ``ray start/stop/status/...`` analog.

Reference: ``python/ray/scripts/scripts.py`` (cluster lifecycle) and
``dashboard/modules/job/cli.py`` (job commands).  Run as
``python -m ray_tpu_torch <command>``:

    start --head [--num-cpus N --num-gpus N]   run a head in the foreground
    start --address host:port [--authkey HEX]  join as a worker node agent
    up CONFIG / down CONFIG                    launch / tear down a YAML cluster
    stop                                       stop the last started head
    status                                     cluster resources/state
    list {actors,tasks,nodes,objects,workers,placement_groups,jobs,traces,
          slices,tenants,logs,incidents,slos}
    submit [--wait] -- <entrypoint...>         submit a job
    job-logs <job_id> / job-stop <job_id>
    logs [STREAM] [--follow --errors --grep P] cluster log plane (tailed
         [--job J --task T --actor A           worker/driver files, context-
          --node N --pid P --tail N]           stamped, from the head store)
    timeline [--out FILE]                      chrome-trace of task events
    events [--source S --severity L --limit N] flight-recorder event table
    trace [TRACE_ID] [--json]                  span tree + critical path
    serve-status                               serve deployments + autoscaling
    serve-deploy CONFIG                        PUT a JSON app config to the dashboard
    doctor [--json --live --static]            pathology findings (exit 1 on any;
                                               --live reads the watchdog's incident set,
                                               --static adds raylint's new findings)
    incidents [--follow --history --ack ID]    watchdog incident lifecycle
    slo                                        declared SLOs + burn-rate state
    debug dump                                 write a whole-cluster post-mortem bundle
    slices                                     failure domains: member health
    top [--interval S --iterations N --sort K] live nodes/workers resource view
    memory [--limit N --json]                  object-ownership audit
    metrics [NAME --window S --step S --agg A] TSDB directory, or one series
    perf [--window S --json]                   step phases, MFU, card memory
    profile [--duration N --worker-id HEX]     on-demand sampling profile (dashboard)
    profile --live [--window S --origin O]     always-on flamegraph (folded stacks)
    profile diff WINDOW_A WINDOW_B             differential folded stacks
    profile ledger [--window S]                per-task CPU cost ledger
    profile list                               origins with profile history
    lint [--rule R4 --json --update-baseline]  raylint static-analysis gate

Every command but ``start``, ``up``, ``down``, ``stop`` and ``lint`` talks to the
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
        if node.dashboard:
            print("dashboard: http://%s:%d" % tuple(node.dashboard.address))
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
    """Job driver logs from the head's log store — the same surface
    ``ray_tpu_torch logs job-<id>`` reads (one log plane for job drivers
    and workers; the head falls back to the complete on-disk job file
    when the ring has aged out)."""
    _connect()
    from ray_tpu_torch.experimental.state import api as state

    reply = state.get_log(stream=f"job-{args.job_id}", limit=100_000)
    for r in reply["records"]:
        print(r["line"])


def cmd_job_stop(args) -> None:
    print("stopped" if _job_client().stop_job(args.job_id) else "not running")


def cmd_logs(args) -> None:
    """Cluster log plane (``ray logs`` analog): with no stream and no
    filters, one row per captured stream in the head's store; otherwise
    the matching records, each prefixed ``(stream pid=… node=…)``.
    Every filter matches the per-line context stamps, so ``--task``/
    ``--actor``/``--job`` find a plain ``print()`` from inside that
    execution.  ``--follow`` keeps polling the head's cursor."""
    _connect()
    from ray_tpu_torch.experimental.state import api as state

    filtered = any((args.stream, args.job, args.task, args.actor,
                    args.node, args.pid, args.grep, args.errors))
    if not filtered and not args.follow:
        rows = state.list_logs(limit=args.limit)
        if not rows:
            print("(no log streams captured yet)")
            return
        print(f"{'STREAM':<28} {'NODE':<12} {'PID':>7} {'LINES':>7} "
              f"{'BYTES':>9}  STATE")
        for r in rows:
            print(f"{r['stream']:<28} {str(r.get('node') or '-'):<12} "
                  f"{str(r.get('pid') or '-'):>7} {r['lines']:>7} "
                  f"{r['bytes']:>9}  "
                  f"{'retired' if r.get('retired') else 'live'}")
        return

    def emit(records):
        for r in records:
            print(f"({r['stream']} pid={r.get('pid')}, "
                  f"node={r.get('node')}) {r['line']}")

    reply = state.get_log(
        stream=args.stream, job=args.job, task=args.task, actor=args.actor,
        node=args.node, pid=args.pid, grep=args.grep, errors=args.errors,
        limit=args.tail)
    emit(reply["records"])
    if not args.follow:
        return
    cursor = reply["cursor"]
    try:
        while True:
            time.sleep(args.interval)
            reply = state.get_log(
                stream=args.stream, job=args.job, task=args.task,
                actor=args.actor, node=args.node, pid=args.pid,
                grep=args.grep, errors=args.errors,
                since_seq=cursor, limit=100_000)
            emit(reply["records"])
            cursor = reply["cursor"]
    except KeyboardInterrupt:
        pass


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
    """Request traces: without an id, list recent traces; with one, the
    assembled span tree + per-phase critical-path attribution."""
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
    trace = state.get_trace(args.trace_id)
    if trace is None:
        raise SystemExit(f"unknown trace {args.trace_id!r} (see "
                         f"`ray_tpu_torch trace` for recent ids)")
    from ray_tpu_torch.util.trace_analysis import analyze, render_trace

    analysis = analyze(trace)
    if args.json:
        trace["analysis"] = analysis
        print(json.dumps(trace, indent=2, default=repr))
    else:
        print(render_trace(trace, analysis))
        logs = trace.get("logs") or []
        if logs:
            print(f"\nlogs ({len(logs)} records stamped with this trace):")
            for r in logs:
                print(f"  ({r['stream']}) {r['line']}")


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


def _repo_root() -> str:
    """The checkout root (where the port's package and its raylint
    baseline live): the parent of the ``ray_tpu_torch`` package, falling
    back to the cwd when the package is installed elsewhere but the cwd
    looks like a checkout (it holds the package with its baseline)."""
    import ray_tpu_torch
    from ray_tpu_torch.devtools.raylint.core import BASELINE_RELPATH

    root = os.path.dirname(os.path.dirname(os.path.abspath(
        ray_tpu_torch.__file__)))
    if not os.path.exists(os.path.join(root, BASELINE_RELPATH)) \
            and os.path.exists(os.path.join(os.getcwd(), BASELINE_RELPATH)):
        return os.getcwd()
    return root


def _static_findings(rules=None, update_baseline=False, root=None):
    """Run the raylint gate over the checkout; returns the GateResult."""
    from ray_tpu_torch.devtools.raylint import run_gate

    return run_gate(root or _repo_root(), rules=rules,
                    update_baseline=update_baseline)


def cmd_lint(args) -> None:
    """raylint: the 8-rule static-analysis gate (no cluster needed).
    Exit 1 on findings the package's baseline doesn't grandfather."""
    from ray_tpu_torch.devtools.raylint.runner import render_report, to_json

    rules = None
    if args.rule:
        rules = sorted({r.strip().upper() for spec in args.rule
                        for r in spec.split(",") if r.strip()})
    try:
        result = _static_findings(rules=rules,
                                  update_baseline=args.update_baseline,
                                  root=args.root)
    except ValueError as e:  # bad --rule id / --update-baseline subset
        raise SystemExit(f"ray_tpu_torch lint: {e}")
    if args.json:
        print(json.dumps(to_json(result), indent=1))
    else:
        print(render_report(result, verbose=args.verbose))
    if not result.ok:
        sys.exit(1)


def cmd_doctor(args) -> None:
    """Rule-based pathology analysis over the recorded event/task state
    and the head's TSDB trends; exits non-zero when findings exist so CI
    can gate on it.  ``--live`` reports the watchdog's current open
    incidents instead of re-diagnosing.  With ``--static``, raylint's
    non-baselined findings join the report (one command for "is this
    cluster AND this tree healthy")."""
    findings = []
    if args.static:
        lint = _static_findings(root=args.root)
        findings.extend({
            "severity": "WARNING",
            "rule": f"raylint/{f.rule}",
            "summary": f"{f.location()}: {f.message}",
            "remedy": f.remedy,
            "evidence": [{"file": f.path, "line": f.line}],
            "count": 1,
        } for f in lint.new)
        # stale baseline keys fail `lint` (the baseline only burns
        # down): doctor --static must agree with the gate
        findings.extend({
            "severity": "WARNING",
            "rule": "raylint/baseline",
            "summary": f"stale baseline entry (finding fixed): {key}",
            "remedy": ("remove it via `python -m ray_tpu_torch lint "
                       "--update-baseline`"),
            "evidence": [{"baseline_key": key}],
            "count": 1,
        } for key in lint.stale_keys)
    _connect()
    from ray_tpu_torch.util.doctor import render, run_doctor

    if args.live:
        # report from the watchdog's CURRENT incident set instead of
        # re-diagnosing — what the continuous loop already concluded
        from ray_tpu_torch.experimental.state import api as state

        findings.extend({
            "severity": inc["severity"], "rule": inc["rule"],
            "summary": f"[{inc['state']}] {inc['summary']}",
            "remedy": inc.get("remedy", ""),
            "count": inc.get("count", 1),
            "evidence": [{"incident_id": inc["id"],
                          "bundle_dir": inc.get("bundle_dir")}],
        } for inc in state.list_incidents()
            if inc["state"] in ("open", "ack"))
    else:
        findings.extend(run_doctor())
    if args.json:
        print(json.dumps(findings, indent=2, default=repr))
    else:
        print(render(findings))
    if findings:
        sys.exit(1)


def _render_incident_row(inc: dict) -> str:
    age = time.time() - inc.get("opened_at", time.time())
    flags = ""
    if inc.get("escalated"):
        flags += "!"
    if inc.get("reopen_count"):
        flags += f" x{inc['reopen_count'] + 1}"
    return (f"{inc['state']:<9} {inc['severity']:<8} "
            f"{int(age):>6}s {inc['id'][:48]:<50}{flags:<6} "
            f"{inc['summary'][:90]}")


def cmd_incidents(args) -> None:
    """Watchdog incident lifecycle: the tracked set, one incident's
    transition history, ack, or --follow transitions live."""
    _connect()
    from ray_tpu_torch.experimental.state import api as state

    if args.ack:
        inc = state.ack_incident(args.ack)
        print(f"acked {inc['id']} ({inc['severity']}: "
              f"{inc['summary'][:100]})")
        return
    if args.history:
        inc = state.get_incident(args.history)
        if args.json:
            print(json.dumps(inc, indent=2, default=repr))
            return
        print(_render_incident_row(inc))
        if inc.get("bundle_dir"):
            print(f"  bundle: {inc['bundle_dir']}")
        for h in inc.get("history", []):
            ts = time.strftime("%H:%M:%S", time.localtime(h["ts"]))
            print(f"  {ts} {h['transition']:<9} {h.get('summary', '')[:100]}")
        return
    seen: dict = {}

    def _page():
        rows = state.list_incidents(limit=args.limit)
        rows.sort(key=lambda r: r.get("opened_at", 0.0))
        return rows

    rows = _page()
    if args.json:
        print(json.dumps(rows, indent=2, default=repr))
        return
    if not rows:
        print("no incidents")
    else:
        print(f"{'STATE':<9} {'SEV':<8} {'AGE':>7} {'INCIDENT':<56} SUMMARY")
        for inc in rows:
            print(_render_incident_row(inc))
            seen[inc["id"]] = (inc["state"], len(inc.get("history", [])))
    if not args.follow:
        return
    try:
        while True:
            time.sleep(args.interval)
            for inc in _page():
                key = (inc["state"], len(inc.get("history", [])))
                if seen.get(inc["id"]) != key:
                    seen[inc["id"]] = key
                    print(_render_incident_row(inc))
    except KeyboardInterrupt:
        pass


def cmd_slo(args) -> None:
    """Declared SLOs with their live multi-window burn-rate state."""
    _connect()
    from ray_tpu_torch.experimental.state import api as state

    rows = state.list_slos()
    if args.json:
        print(json.dumps(rows, indent=2, default=repr))
        return
    print(f"{'SLO':<16} {'STATE':<8} {'OBJECTIVE':<44} "
          f"{'FAST':>10} {'SLOW':>10}")
    for s in rows:
        obj = f"{s['metric']} {s.get('op', '<=')} {s['threshold']}"
        if s.get("kind") == "ratio":
            obj = f"{s['metric']} ratio <= {s['threshold']}"

        def _w(w):
            if not w or not w.get("evaluable"):
                return "no-data"
            return f"{w['value']}{'*' if w['breach'] else ''}"

        state_s = "BURNING" if s.get("burning") else "ok"
        print(f"{s['name']:<16} {state_s:<8} {obj:<44} "
              f"{_w(s.get('fast')):>10} {_w(s.get('slow')):>10}")
    if any(s.get("burning") for s in rows):
        sys.exit(1)


def cmd_debug(args) -> None:
    """`debug dump`: one-shot whole-cluster post-mortem bundle."""
    if args.what != "dump":
        raise SystemExit(f"unknown debug subcommand {args.what!r}")
    _connect()
    from ray_tpu_torch.experimental.state import api as state

    print(state.debug_dump(label=args.label))


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


def cmd_slices(args) -> None:
    """Failure-domain view: one line per slice with member health,
    draining state and the degraded flag doctor watches."""
    _connect()
    from ray_tpu_torch.experimental.state import api as state

    rows = state.list_slices(limit=args.limit)
    if args.json:
        print(json.dumps(rows, indent=2, default=repr))
        return
    if not rows:
        print("no slices (no node joined with a slice id)")
        return
    print(f"{'SLICE':<28} {'HOSTS':>5} {'ALIVE':>5} {'DEAD':>4} STATE")
    for r in rows:
        state_s = ("DEGRADED" if r["degraded"]
                   else "draining" if r["draining"]
                   else "healthy" if r["dead_members"] == 0 else "dead")
        print(f"{r['slice_id']:<28} {len(r['members']):>5} "
              f"{r['alive_members']:>5} {r['dead_members']:>4} {state_s}")


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


def cmd_profile(args) -> None:
    """Profiles, on demand and continuous.

    Default: dense on-demand sampling via the dashboard's /api/profile.
    ``--live`` reads the always-on plane instead (head ProfileStore —
    no new sampling, the history is already there); ``profile diff A B``
    emits differential folded stacks between the trailing B seconds and
    the A-second baseline before them; ``profile ledger`` prints the
    per-task CPU cost columns; ``profile list`` the origins with
    retained history.  ``--format collapsed`` (default for the
    continuous modes) is speedscope / flamegraph.pl ready."""
    import urllib.request

    rt = _connect()
    mode = args.rest[0] if args.rest else None
    if mode not in (None, "diff", "ledger", "list"):
        raise SystemExit(f"unknown profile mode {mode!r} "
                         "(expected: diff, ledger, list)")
    if args.live or mode in ("diff", "ledger", "list"):
        from ray_tpu_torch.experimental.state import api as state

        if mode == "list":
            rows = state.list_profiles()
            print(json.dumps(rows, indent=2))
            return
        if mode == "ledger":
            led = state.profile_ledger(window_s=args.window)
            if args.format == "json":
                print(json.dumps(led, indent=2))
                return
            wall = led["per_task_wall_us"]
            print(f"per-task CPU ledger over the last {led['window_s']:.0f}s "
                  f"({led['tasks']} tasks, {wall:.1f}us wall/task):")
            for col, us in led["columns"].items():
                pct = 100.0 * us / wall if wall else 0.0
                print(f"  {col:20s} {us:10.2f}us  {pct:5.1f}%")
            print(f"  {'sum':20s} {led['sum_us']:10.2f}us  "
                  f"{led['sum_over_wall'] * 100:5.1f}%  (exactness check)")
            print(f"  overlapped worker CPU (pipelined, not on the wall): "
                  f"{led['overlapped_worker_cpu_us']:.2f}us/task")
            return
        if mode == "diff":
            if len(args.rest) != 3:
                raise SystemExit(
                    "usage: ray_tpu_torch profile diff WINDOW_A WINDOW_B "
                    "(seconds; trailing B vs the A-long baseline before it)")
            d = state.profile_diff(window_a=float(args.rest[1]),
                                   window_b=float(args.rest[2]),
                                   origin=args.origin)
            body = (json.dumps(d, indent=2) if args.format == "json"
                    else d["collapsed"])
        else:  # --live
            q = state.get_profile(window_s=args.window, origin=args.origin)
            if args.format == "json":
                body = json.dumps(q, indent=2)
            else:
                body = "\n".join(
                    f"{stack.replace('|', ';')} {n}"
                    for stack, n in sorted(q["folded"].items(),
                                           key=lambda kv: -kv[1]))
        if args.out:
            with open(args.out, "w") as f:
                f.write(body + "\n")
            print(f"wrote profile to {args.out}")
        else:
            print(body)
        return
    snap = rt._private.worker.global_worker.client.request(
        {"type": "state_snapshot"})["value"]
    dash = snap.get("dashboard")
    if not dash:
        raise SystemExit("head has no dashboard; profiling needs it")
    duration = args.duration
    if duration > 30.0:
        # the dashboard clamps server-side; say so instead of silently
        # returning a shorter profile than asked for
        print("note: profile duration is capped at 30s by the dashboard",
              file=sys.stderr)
        duration = 30.0
    url = ("http://%s:%d/api/profile?duration=%s&format=%s"
           % (dash[0], dash[1], duration, args.format or "json"))
    if args.worker_id:
        url += f"&worker_id={args.worker_id}"
    with urllib.request.urlopen(url, timeout=duration + 60) as resp:
        body = resp.read().decode()
    if args.out:
        with open(args.out, "w") as f:
            f.write(body)
        print(f"wrote profile to {args.out}")
    else:
        print(body, end="" if body.endswith("\n") else "\n")


def cmd_serve_deploy(args) -> None:
    """``serve deploy config.yaml`` analog: validate the declarative app
    config and PUT it to the head's REST endpoint."""
    import urllib.request

    with open(args.config) as f:
        text = f.read()
    try:
        config = json.loads(text)
    except json.JSONDecodeError:
        try:  # yaml if the environment provides it; never a hard dependency
            import yaml  # type: ignore

            config = yaml.safe_load(text)
        except ImportError:
            raise SystemExit(
                "config must be JSON (no yaml parser in this environment)")
    from ray_tpu_torch.serve.schema import SchemaError, parse_deploy_config

    try:
        parse_deploy_config(config)  # client-side validation, better errors
    except SchemaError as e:
        raise SystemExit(f"invalid config: {e}")
    _connect()
    from ray_tpu_torch._private.worker import global_worker

    snap = global_worker.client.request({"type": "state_snapshot"})["value"]
    dash = snap.get("dashboard")
    if not dash:
        raise SystemExit("head has no dashboard; cannot reach the serve REST API")
    req = urllib.request.Request(
        "http://%s:%d/api/serve/applications" % tuple(dash),
        data=json.dumps(config).encode(),
        headers={"Content-Type": "application/json"}, method="PUT")
    try:
        with urllib.request.urlopen(req, timeout=240) as resp:
            print(resp.read().decode())
    except urllib.error.HTTPError as e:
        # the endpoint's JSON error payload IS the diagnosis; show it
        raise SystemExit(f"deploy failed ({e.code}): {e.read().decode()}")


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
                                    "traces", "slices", "tenants", "logs",
                                    "incidents", "slos"])
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

    s = sub.add_parser(
        "logs",
        help="cluster log plane: stream table, or task/actor/trace-"
             "correlated records from every node")
    s.add_argument("stream", nargs="?", default=None,
                   help="one stream (e.g. worker-<id>, job-<id>, head)")
    s.add_argument("--follow", "-f", action="store_true",
                   help="keep polling the head's cursor (Ctrl-C to stop)")
    s.add_argument("--errors", action="store_true",
                   help="only stderr/traceback lines")
    s.add_argument("--grep", default=None, help="substring filter")
    s.add_argument("--job", default=None)
    s.add_argument("--task", default=None, help="task id (hex)")
    s.add_argument("--actor", default=None, help="actor id (hex)")
    s.add_argument("--node", default=None)
    s.add_argument("--pid", type=int, default=None)
    s.add_argument("--tail", type=int, default=1000,
                   help="max records in the initial page")
    s.add_argument("--limit", type=int, default=1000,
                   help="max stream rows in the no-filter table")
    s.add_argument("--interval", type=float, default=1.0,
                   help="--follow poll period (s)")
    s.set_defaults(fn=cmd_logs)

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
                        "autoscaler|perf|client_proxy|rllib")
    s.add_argument("--severity", default=None,
                   help="filter: DEBUG|INFO|WARNING|ERROR")
    s.add_argument("--limit", type=int, default=200)
    s.add_argument("--summary", action="store_true",
                   help="counts by source/severity instead of rows")
    s.set_defaults(fn=cmd_events)

    s = sub.add_parser(
        "trace",
        help="request traces: list, or span tree + critical path for one")
    s.add_argument("trace_id", nargs="?", default=None)
    s.add_argument("--limit", type=int, default=20)
    s.add_argument("--json", action="store_true")
    s.set_defaults(fn=cmd_trace)

    sub.add_parser(
        "serve-status", help="serve deployments + autoscaling state"
    ).set_defaults(fn=cmd_serve_status)

    s = sub.add_parser(
        "serve-deploy",
        help="deploy serve applications from a declarative JSON config")
    s.add_argument("config", help="path to the config file")
    s.set_defaults(fn=cmd_serve_deploy)

    s = sub.add_parser(
        "doctor",
        help="pathology analysis over recorded events/tasks and TSDB "
             "trends (exit 1 on findings)")
    s.add_argument("--json", action="store_true")
    s.add_argument("--live", action="store_true",
                   help="report the watchdog's current open incidents "
                        "instead of re-diagnosing from scratch")
    s.add_argument("--static", action="store_true",
                   help="also run the raylint static gate and fold its "
                        "new findings into the report/exit code")
    s.add_argument("--root", default=None,
                   help="checkout root for --static (default: the "
                        "ray_tpu_torch package's parent, or cwd if the "
                        "baseline lives there)")
    s.set_defaults(fn=cmd_doctor)

    s = sub.add_parser(
        "incidents",
        help="watchdog incident lifecycle: tracked set, history, ack, "
             "or follow transitions live")
    s.add_argument("--follow", "-f", action="store_true",
                   help="keep polling and print state transitions")
    s.add_argument("--ack", default=None, metavar="ID",
                   help="acknowledge one open incident")
    s.add_argument("--history", default=None, metavar="ID",
                   help="one incident's full transition history")
    s.add_argument("--json", action="store_true")
    s.add_argument("--limit", type=int, default=200)
    s.add_argument("--interval", type=float, default=2.0,
                   help="--follow poll period (s)")
    s.set_defaults(fn=cmd_incidents)

    s = sub.add_parser(
        "slo",
        help="declared SLOs + multi-window burn-rate state (exit 1 "
             "when any objective is burning)")
    s.add_argument("--json", action="store_true")
    s.set_defaults(fn=cmd_slo)

    s = sub.add_parser(
        "debug",
        help="debug dump: write a whole-cluster post-mortem bundle "
             "under <session>/incidents/")
    s.add_argument("what", choices=["dump"])
    s.add_argument("--label", default=None,
                   help="bundle directory name (default dump-<ts>)")
    s.set_defaults(fn=cmd_debug)

    s = sub.add_parser(
        "lint",
        help="raylint static-analysis suite over the port's package "
             "(8 invariant rules; exit 1 on non-baselined findings)")
    s.add_argument("--rule", action="append", default=None,
                   metavar="R1[,R2...]",
                   help="run only these rule ids (repeatable)")
    s.add_argument("--json", action="store_true")
    s.add_argument("--verbose", action="store_true",
                   help="also list baselined findings")
    s.add_argument("--update-baseline", action="store_true",
                   help="rewrite the package's raylint baseline.json "
                        "from the current findings (full-rule runs only)")
    s.add_argument("--root", default=None,
                   help="checkout root to analyze (default: the "
                        "ray_tpu_torch package's parent, or cwd if the "
                        "baseline lives there)")
    s.set_defaults(fn=cmd_lint)

    s = sub.add_parser(
        "top", help="live cluster resource view (nodes, workers, pinned "
                    "bytes, card memory; Ctrl-C to exit)")
    s.add_argument("--interval", type=float, default=2.0)
    s.add_argument("--iterations", type=int, default=0,
                   help="frames to render (0 = forever); 1 prints once")
    s.add_argument("--sort", choices=["cpu", "rss", "pinned"], default="cpu")
    s.set_defaults(fn=cmd_top)

    s = sub.add_parser(
        "slices",
        help="slice failure domains: member health, draining, "
             "degraded flags")
    s.add_argument("--limit", type=int, default=100)
    s.add_argument("--json", action="store_true")
    s.set_defaults(fn=cmd_slices)

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

    s = sub.add_parser(
        "profile",
        help="profiles: on-demand sampling, the always-on plane "
             "(--live / diff / ledger / list)")
    s.add_argument("rest", nargs="*",
                   help="mode: diff WINDOW_A WINDOW_B | ledger | list "
                        "(none: on-demand or --live)")
    s.add_argument("--live", action="store_true",
                   help="read the continuous profiler's history instead "
                        "of sampling on demand")
    s.add_argument("--window", type=float, default=300.0,
                   help="trailing window seconds for --live/ledger")
    s.add_argument("--origin", default=None,
                   help="one origin ('head', worker id hex, "
                        "'agent:<node>', 'tenant-<job>'); default: all")
    s.add_argument("--duration", type=float, default=3.0,
                   help="on-demand sampling duration")
    s.add_argument("--worker-id", default=None, help="worker id hex")
    s.add_argument("--format", choices=["json", "collapsed"],
                   default=None)
    s.add_argument("--out", default=None, help="write to file")
    s.set_defaults(fn=cmd_profile)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
