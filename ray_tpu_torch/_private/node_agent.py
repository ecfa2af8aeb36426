"""Per-node agent: joins a running cluster over TCP and manages this host.

The port's copy of ``ray_tpu/_private/node_agent.py``.  The raylet-join
path of the reference (``ray start --address=<head>``:
``python/ray/_private/services.py:1273`` launches a raylet that registers
with the GCS and serves its node): the agent

- registers a real ``NodeState`` with the head (resources + the cards it
  holds as ``gpu_ids``; an explicit ``--num-gpus`` wins over detection),
- spawns/kills worker processes on THIS host when the head asks (the
  workers connect straight back to the head's TCP control plane); a
  worker sees exactly the cards its grant names as
  ``CUDA_VISIBLE_DEVICES``, never the agent's own,
- serves object pulls from this node's private shm namespace through an
  :class:`~ray_tpu_torch._private.object_transfer.ObjectServer`,
- reports pre-registration worker deaths (the head cannot poll a remote
  process),
- unlinks local segments when the head evicts them,
- samples RSS, CPU% and open fds of itself and its workers from
  ``/proc`` every push interval and ships them as ``metrics_report``
  gauges, and its own stacks as ``profile_report`` frames (the
  continuous profiler), and
- gossips its resource view + liveness to peer agents through the
  :mod:`~ray_tpu_torch._private.syncer` P2P mesh, shipping the converged
  view back to the head each tick so the head is no longer the sole
  fan-in for every heartbeat and peer-observed death reaches it faster
  than a missed-pong timeout.

Run via ``python -m ray_tpu_torch._private.node_agent --address host:port
--num-cpus N --num-gpus G --shm-dir DIR`` (the authkey from
``--authkey`` or ``$RAY_TPU_TORCH_AUTHKEY``), or through
``cluster_utils.Cluster`` and ``autoscaler.LocalNodeProvider``.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle
import random
import subprocess
import sys
import tempfile
import threading
import time
from multiprocessing.connection import Client as MPClient
from typing import Dict, Optional, Tuple

logger = logging.getLogger(__name__)


class NodeAgent:
    def __init__(
        self,
        address: str,
        authkey: bytes,
        num_cpus: Optional[int] = None,
        num_gpus: Optional[int] = None,
        resources: Optional[Dict[str, float]] = None,
        node_id: Optional[str] = None,
        shm_dir: Optional[str] = None,
        host: str = "127.0.0.1",
        slice_id: Optional[str] = None,
    ):
        from ray_tpu_torch._private import shm as shm_mod
        from ray_tpu_torch._private import syncer as syncer_mod
        from ray_tpu_torch._private import wire
        from ray_tpu_torch._private.object_transfer import ObjectServer, configure
        from ray_tpu_torch._private.resource_spec import autodetect_resources

        self.node_id = node_id or f"node-{os.urandom(4).hex()}"
        self.slice_id = slice_id or os.environ.get("RAY_TPU_TORCH_SLICE_ID") or None
        self.authkey = authkey
        host_s, port_s = address.rsplit(":", 1)
        self.head_addr = (host_s, int(port_s))

        # Private shm namespace for this node: own directory (when given)
        # and own session id, so same-host siblings can't short-circuit the
        # object-transfer plane by attaching each other's segments.
        if shm_dir:
            os.makedirs(shm_dir, exist_ok=True)
            os.environ[shm_mod._SHM_DIR_ENV] = shm_dir
        session = os.environ.get(shm_mod._SESSION_ENV, "nosession")
        self.session = f"{session}{self.node_id.replace('-', '')[-6:]}"
        os.environ[shm_mod._SESSION_ENV] = self.session
        shm_mod.sweep_orphaned_segments()
        shm_mod.write_session_marker(self.session, os.getpid())

        configure(authkey)
        self.object_server = ObjectServer(host, authkey)

        total, gpu_ids = autodetect_resources(num_cpus, num_gpus, resources)
        self.resources = total
        self.procs: Dict[str, subprocess.Popen] = {}  # worker_id hex -> proc
        self._lock = threading.Lock()
        self._shutdown = False
        # message-drop window (the ``chaos_drop`` message): while active,
        # outbound control messages are dropped with probability ``frac``
        # — the head's direct view of this agent goes dark while the P2P
        # mesh keeps carrying its state
        self._drop: Optional[dict] = None

        # P2P resource/health mesh: always on in an agent (an agent IS the
        # multi-node case)
        self.syncer = syncer_mod.ResourceSyncer(
            self.node_id, authkey,
            state_fn=self._syncer_state,
            report_fn=self._syncer_report,
            host=host,
        )

        self.conn = wire.wrap(
            MPClient(self.head_addr, family="AF_INET", authkey=authkey))
        self._send_lock = threading.Lock()
        self._send({
            "type": "register_node",
            "node_id": self.node_id,
            "resources": total,
            "gpu_ids": gpu_ids,
            "fetch_addr": tuple(self.object_server.addr),
            "slice_id": self.slice_id,
            "syncer_addr": tuple(self.syncer.addr),
        })
        self.syncer.start()

        # agent events (syncer suspicions, drop windows) ship to the
        # head's event table like any worker's
        from ray_tpu_torch._private.events import EventsPusher

        self.events_pusher = EventsPusher(
            self._send, origin=self.node_id,
            closed_fn=lambda: self._shutdown).start()

        # continuous flamegraphs for the agent process itself, shipped
        # over the same head connection (workers on this host each run
        # their own)
        from ray_tpu_torch._private import sampling_profiler as _sp

        self.cont_profiler = None
        if _sp.continuous_enabled():
            self.cont_profiler = _sp.ContinuousProfiler(
                f"agent:{self.node_id}", send_fn=self._send,
                closed_fn=lambda: self._shutdown).start()

        # log plane: tail this host's worker capture files (registered at
        # spawn) and batch-ship them to the head's log store over the
        # same control connection (log_report frames).  Registration-based
        # — the head tails only ITS local workers, so a shared session dir
        # never double-ships.
        from ray_tpu_torch._private import log_plane as log_plane_mod

        self.log_monitor = None
        if log_plane_mod.enabled():
            self.log_monitor = log_plane_mod.LogMonitor(
                self.node_id, send_fn=self._send,
                closed_fn=lambda: self._shutdown).start()
            agent_log = os.environ.get("RAY_TPU_TORCH_AGENT_LOG")
            if agent_log and log_plane_mod.redirect_process_output(agent_log):
                self.log_monitor.register(
                    f"agent-{self.node_id}", agent_log,
                    node=self.node_id, pid=os.getpid())

        self._monitor = threading.Thread(target=self._monitor_loop, daemon=True,
                                         name="agent-monitor")
        self._monitor.start()

        # Per-entity resource sampler (reporter_agent analog): RSS / CPU% /
        # open fds for every worker on THIS host plus the agent itself,
        # shipped as tagged gauges over the metrics_report path so they
        # land in the head's merged registry and its TSDB.  The head
        # cannot read a remote host's /proc — this loop is the only
        # source of per-worker stats for agent nodes.  The head samples
        # only the workers it spawned itself, so a pid on a host the head
        # and an agent share has one sampler: its spawner's.
        t = threading.Thread(target=self._resource_loop, daemon=True,
                             name="agent-resources")
        t.start()

    # -- plumbing ---------------------------------------------------------
    def _send(self, msg: dict) -> None:
        drop = self._drop
        if drop is not None:
            if time.time() >= drop["until"]:
                self._drop = None
            elif drop["rng"].random() < drop["frac"]:
                return  # inside a drop window: this control message is lost
        with self._send_lock:
            self.conn.send(msg)

    # -- P2P mesh ---------------------------------------------------------
    def _syncer_state(self) -> dict:
        """This node's own versioned snapshot payload (gossiped each tick)."""
        from ray_tpu_torch._private.resource_spec import host_stats

        return {
            "resources": dict(self.resources),
            "stats": host_stats(),
            "slice_id": self.slice_id,
            "workers": len(self.procs),
        }

    def _syncer_report(self, view: dict) -> None:
        """Ship the converged mesh view to the head (one frame per tick,
        on the control connection)."""
        try:
            self._send({"type": "syncer_report", "origin": self.node_id,
                        **view})
        except (OSError, ValueError):
            pass  # head gone or conn tearing down; gossip continues

    # -- head message loop ------------------------------------------------
    def serve_forever(self) -> None:
        logger.info("node agent %s joined %s (object server %s)",
                    self.node_id, self.head_addr, self.object_server.addr)
        try:
            while not self._shutdown:
                try:
                    msg = self.conn.recv()
                except (EOFError, OSError, pickle.UnpicklingError):
                    # incl. wire.WireDecodeError: treat a bad frame as a
                    # lost head connection, not an agent crash
                    logger.warning("head connection lost; shutting down node")
                    break
                try:
                    self._handle(msg)
                except Exception:
                    logger.exception("agent error handling %s", msg.get("type"))
        finally:
            self.shutdown()

    def _handle(self, msg: dict) -> None:
        mtype = msg["type"]
        if mtype == "spawn_worker":
            self._spawn_worker(msg)
        elif mtype == "kill_worker":
            self._kill_worker(msg["worker_id"])
        elif mtype == "unlink":
            from ray_tpu_torch._private.shm import ShmSegment

            ShmSegment.unlink(msg["name"])
        elif mtype == "pull_object":
            # broadcast fan-out: fetch a copy into this node's namespace
            # (transfers take seconds — never on the agent's control loop)
            threading.Thread(
                target=self._pull_object, args=(msg,), daemon=True
            ).start()
        elif mtype == "shutdown":
            self._shutdown = True
        elif mtype == "syncer_peers":
            # head-maintained mesh directory (rebroadcast on membership
            # change); the syncer prunes its store to it
            self.syncer.set_peers({
                nid: tuple(addr)
                for nid, addr in (msg.get("peers") or {}).items()})
        elif mtype == "chaos_drop":
            # fault injection: drop outbound control messages for a
            # window (seeded — reproducible schedules)
            frac = float(msg.get("frac", 1.0))
            dur = float(msg.get("duration_s", 5.0))
            self._drop = {"frac": frac, "until": time.time() + dur,
                          "rng": random.Random(msg.get("seed"))}
            logger.warning("chaos: dropping %d%% of outbound messages for "
                           "%.1fs", int(frac * 100), dur)
        elif mtype == "ping":
            # heartbeat reply doubles as the per-node host report: live
            # host utilization rides every pong onto the head's NodeState
            from ray_tpu_torch._private.resource_spec import host_stats

            self._send({"type": "pong", "ts": msg.get("ts"),
                        "stats": host_stats()})
        else:
            logger.warning("agent: unknown message %s", mtype)

    def _pull_object(self, msg: dict) -> None:
        from ray_tpu_torch._private.object_transfer import pull_object

        try:
            pull_object(
                msg["name"], tuple(msg["addr"]), msg.get("size", -1),
                arena=tuple(msg["arena"]) if msg.get("arena") else None,
            )
            ok, error = True, None
        except Exception as e:  # noqa: BLE001 — the head needs the nack
            ok, error = False, f"{type(e).__name__}: {e}"
        try:
            self._send({"type": "object_pulled", "token": msg.get("token"),
                        "ok": ok, "error": error})
        except (OSError, ValueError):
            pass

    # -- worker management ------------------------------------------------
    def _spawn_worker(self, msg: dict) -> None:
        """Start a worker as the head starts its own (``worker_argv``,
        ``_worker_pythonpath``), in this node's namespace: a pip or conda
        env boots through the same shim, under the same ``PYTHONPATH``,
        so its worker imports torch as the head's does.  The head's
        overrides carry an actor's grant as ``CUDA_VISIBLE_DEVICES``; a
        worker given none sees no card (a pooled worker sets each task's
        grant itself before the task runs)."""
        from ray_tpu_torch._private import shm as shm_mod
        from ray_tpu_torch._private.node import _worker_pythonpath
        from ray_tpu_torch._private.runtime_env_setup import worker_argv

        overrides = msg.get("env_overrides") or {}
        env = dict(os.environ)
        env.update(overrides)
        for var in ("CUDA_VISIBLE_DEVICES", "RAY_TPU_TORCH_ASSIGNED_GPUS"):
            env[var] = overrides.get(var, "")
        # this node's namespace must win over anything inherited/overridden
        env[shm_mod._SESSION_ENV] = self.session
        if os.environ.get(shm_mod._SHM_DIR_ENV):
            env[shm_mod._SHM_DIR_ENV] = os.environ[shm_mod._SHM_DIR_ENV]
        env["RAY_TPU_TORCH_NODE_ID"] = self.node_id
        env["PYTHONPATH"] = _worker_pythonpath(env.get("PYTHONPATH", ""))
        wid = msg["worker_id"]
        try:
            proc = subprocess.Popen(worker_argv(msg.get("pip"), msg.get("conda")),
                                    env=env, cwd=msg.get("cwd"))
        except OSError as e:
            self._send({"type": "worker_exited", "worker_id": wid,
                        "returncode": -1, "error": str(e)})
            return
        with self._lock:
            self.procs[wid] = proc
        if self.log_monitor is not None and env.get("RAY_TPU_TORCH_WORKER_LOG"):
            self.log_monitor.register(
                f"worker-{wid}", env["RAY_TPU_TORCH_WORKER_LOG"],
                node=self.node_id, pid=proc.pid)

    def _kill_worker(self, worker_id: str) -> None:
        with self._lock:
            proc = self.procs.pop(worker_id, None)
        if proc is not None:
            try:
                proc.kill()
            except Exception:
                pass
        if self.log_monitor is not None:
            # ship whatever the file gained before the head retires the
            # stream (its kill_worker -> death path runs after this)
            self.log_monitor.unregister(f"worker-{worker_id}")

    def _resource_loop(self) -> None:
        """/proc sampling of agent + workers on the shared deadline grid
        (``metrics.grid_ticks``) — spacing must stay uniform for the
        head's TSDB."""
        from ray_tpu_torch._private.resource_spec import (
            ProcSampler,
            resource_metrics_snapshot,
        )
        from ray_tpu_torch.util.metrics import grid_ticks, push_interval_s

        sampler = ProcSampler()

        def wait(timeout: float) -> bool:
            time.sleep(timeout)
            return self._shutdown

        for _ in grid_ticks(push_interval_s(), wait):
            entities = [({"entity": "agent", "node": self.node_id},
                         os.getpid())]
            with self._lock:
                for wid, proc in self.procs.items():
                    entities.append((
                        {"entity": "worker", "worker_id": wid,
                         "node": self.node_id}, proc.pid))
            snap, _ = resource_metrics_snapshot(sampler, entities)
            if not snap:
                continue
            try:
                self._send({"type": "metrics_report", "origin": self.node_id,
                            "metrics": snap})
            except (OSError, ValueError):
                return  # head gone; serve_forever is tearing down

    def _monitor_loop(self) -> None:
        """Report worker processes that die (the head polls local procs
        itself; remote ones are invisible to it)."""
        while not self._shutdown:
            time.sleep(0.2)
            dead = []
            with self._lock:
                for wid, proc in list(self.procs.items()):
                    rc = proc.poll()
                    if rc is not None:
                        dead.append((wid, rc))
                        del self.procs[wid]
            for wid, rc in dead:
                if self.log_monitor is not None:
                    # final drain FIRST: the log_report rides the same
                    # connection, so the head holds the death tail before
                    # it processes worker_exited
                    self.log_monitor.unregister(f"worker-{wid}")
                try:
                    self._send({"type": "worker_exited", "worker_id": wid,
                                "returncode": rc})
                except (OSError, ValueError):
                    return

    def shutdown(self) -> None:
        from ray_tpu_torch._private import shm as shm_mod

        self._shutdown = True
        if self.log_monitor is not None:
            try:
                self.log_monitor.stop()  # final ship while the conn lives
            except Exception:
                pass
        self.syncer.stop()
        if self.cont_profiler is not None:
            try:
                self.cont_profiler.stop()
            except Exception:
                pass
        try:
            self.events_pusher.stop()
        except Exception:
            pass
        with self._lock:
            procs = list(self.procs.values())
            self.procs.clear()
        for p in procs:
            try:
                p.kill()
            except Exception:
                pass
        self.object_server.close()
        try:
            self.conn.close()
        except Exception:
            pass
        # reclaim this node's namespace
        shm_mod.remove_session_marker(self.session)
        shm_mod.sweep_orphaned_segments()


def start_agent(head, node_id: str, *, num_cpus: int, num_gpus: int = 0,
                resources: Optional[Dict[str, float]] = None,
                env: Optional[Dict[str, str]] = None,
                slice_id: Optional[str] = None) -> Tuple[subprocess.Popen, str]:
    """Start an agent subprocess on this host that joins ``head`` (the
    in-process head ``Node``) as ``node_id``, with a private shm
    directory under ``/dev/shm`` (prefix ``rtpt-``) so objects reach it
    only through the object-transfer plane.  The agent and its workers see
    the driver's import path.  Returns the process and the directory."""
    import json

    from ray_tpu_torch._private.node import _worker_pythonpath

    shm_sub = tempfile.mkdtemp(prefix=f"rtpt-{node_id}-", dir="/dev/shm")
    host, port = head.tcp_address
    agent_env = dict(os.environ)
    agent_env.update(env or {})
    agent_env["RAY_TPU_TORCH_AUTHKEY"] = head.authkey.hex()
    agent_env["PYTHONPATH"] = _worker_pythonpath(agent_env.get("PYTHONPATH", ""))
    cmd = [
        sys.executable, "-m", "ray_tpu_torch._private.node_agent",
        "--address", f"{host}:{port}",
        "--node-id", node_id,
        "--num-cpus", str(num_cpus),
        "--num-gpus", str(num_gpus),
        "--shm-dir", shm_sub,
    ]
    if slice_id:
        cmd += ["--slice-id", slice_id]
    if resources:
        cmd += ["--resources", json.dumps(resources)]
    return subprocess.Popen(cmd, env=agent_env), shm_sub


def main() -> None:
    p = argparse.ArgumentParser(description="ray_tpu_torch node agent")
    p.add_argument("--address", required=True, help="head host:port")
    p.add_argument("--authkey", default=None, help="cluster authkey (hex); "
                   "defaults to $RAY_TPU_TORCH_AUTHKEY")
    p.add_argument("--num-cpus", type=int, default=None)
    p.add_argument("--num-gpus", type=int, default=None,
                   help="cards this node holds (ids 0..N-1); detected when unset")
    p.add_argument("--resources", default=None,
                   help='extra custom resources as JSON, e.g. \'{"special": 1}\'')
    p.add_argument("--node-id", default=None)
    p.add_argument("--shm-dir", default=None)
    p.add_argument("--slice-id", default=None,
                   help="failure-domain id: hosts that share it are "
                        "provisioned/replaced as one unit")
    args = p.parse_args()
    import signal

    # SIGTERM (``autoscaler.commands.down``) unwinds through
    # ``serve_forever``'s ``finally``, which stops this node's workers
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    authkey = bytes.fromhex(args.authkey or os.environ["RAY_TPU_TORCH_AUTHKEY"])
    logging.basicConfig(level=os.environ.get("RAY_TPU_TORCH_LOG_LEVEL", "INFO"))
    import json

    agent = NodeAgent(
        args.address, authkey,
        num_cpus=args.num_cpus, num_gpus=args.num_gpus,
        resources=json.loads(args.resources) if args.resources else None,
        node_id=args.node_id, shm_dir=args.shm_dir, slice_id=args.slice_id,
    )
    agent.serve_forever()


if __name__ == "__main__":
    main()
