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

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
