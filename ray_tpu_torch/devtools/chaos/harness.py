"""ChaosMonkey: host-level fault injection against emulated node agents.

Runs IN the head process (it signals local agent subprocesses and uses the
head's tables to resolve slice membership).  Four ops:

``sigkill``
    SIGKILL the agent process — the canonical slice-member death.  The
    kernel closes its sockets: the head sees the control-connection EOF,
    and mesh peers see connection-refused (both detection paths fire).
``pause``
    SIGSTOP for ``duration_s`` then SIGCONT — a hung host.  TCP stays
    open, so ONLY the timeout paths (missed pongs, peer suspect quorum)
    can catch it.
``drop``
    Ask the agent to drop a fraction of its *outbound* control messages
    for a window (the agent's ``chaos_drop`` arm) — a lossy/partitioned
    head link while the P2P mesh stays healthy.
``slow``
    Duty-cycled SIGSTOP/SIGCONT for ``duration_s`` — a straggler host
    (doctor's slow_node_skew food).
``kill_replica``
    SIGKILL one serve replica's worker process (resolved through the
    serve controller's routing table + the replica's own pid) — the
    serving-failure-domain injection: the ingress must retry idempotent
    in-flight requests to a live replica and the controller must
    replace the dead one, with zero client-visible 500s.

Every injection lands in the flight recorder under source ``chaos`` with
the op, target, slice and seed, so a post-mortem reads "what did the
harness do and when" next to "what did the runtime see".
"""

from __future__ import annotations

import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ray_tpu_torch._private import events as events_mod


@dataclass
class Injection:
    """One scheduled fault: fire ``op`` at ``at_s`` (relative to
    ``ChaosMonkey.start``) on ``target`` — or on a seeded-random alive
    member of ``slice_id`` when ``target`` is None."""

    at_s: float
    op: str  # sigkill | pause | drop | slow | kill_replica
    target: Optional[str] = None
    slice_id: Optional[str] = None
    duration_s: float = 5.0
    frac: float = 1.0   # drop only
    duty: float = 0.5   # slow only: fraction of each 100ms period stopped
    params: Dict = field(default_factory=dict)


class ChaosMonkey:
    """Injects faults into node-agent processes by pid.

    ``procs`` maps node_id -> a Popen-like object (``.pid``/``.poll()``)
    or a bare pid; pass ``cluster.agents`` (cluster_utils) or
    ``provider.procs`` (LocalNodeProvider).  ``node`` is the head Node
    (defaults to the connected driver's) — used for slice-membership
    targeting and the ``drop`` op's control message.
    """

    def __init__(self, node=None, procs: Optional[Dict] = None,
                 seed: int = 0, schedule: Optional[List[Injection]] = None):
        if node is None:
            from ray_tpu_torch._private.worker import global_worker

            node = global_worker.node
        self.node = node
        self.procs = procs or {}
        self.seed = seed
        import random

        self._rng = random.Random(seed)
        self.schedule = sorted(schedule or [], key=lambda i: i.at_s)
        self.injections: List[dict] = []  # what actually fired, in order
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._timers: List[threading.Thread] = []

    # -- targeting -----------------------------------------------------
    def members_of_slice(self, slice_id: str,
                         alive_only: bool = True) -> List[str]:
        with self.node.lock:
            return sorted(
                ns.node_id for ns in self.node.nodes.values()
                if ns.slice_id == slice_id and (ns.alive or not alive_only))

    def pick(self, slice_id: Optional[str] = None) -> str:
        """A seeded-random target: an alive member of ``slice_id``, or any
        alive node present in the pid map."""
        if slice_id is not None:
            cands = [n for n in self.members_of_slice(slice_id)
                     if self._pid(n) is not None]
        else:
            with self.node.lock:
                alive = {ns.node_id for ns in self.node.nodes.values()
                         if ns.alive}
            cands = sorted(n for n in self.procs if n in alive
                           and self._pid(n) is not None)
        if not cands:
            raise RuntimeError(
                f"chaos: no targetable node (slice={slice_id!r})")
        return self._rng.choice(cands)

    def _pid(self, node_id: str) -> Optional[int]:
        proc = self.procs.get(node_id)
        if proc is None:
            return None
        pid = getattr(proc, "pid", proc)
        poll = getattr(proc, "poll", None)
        if poll is not None and poll() is not None:
            return None  # already dead
        return int(pid)

    def _record(self, op: str, target: str, **data) -> dict:
        rec = {"op": op, "target": target, "ts": time.time(), **data}
        self.injections.append(rec)
        events_mod.emit(
            "chaos", f"inject {op}", severity="WARNING", entity_id=target,
            op=op, seed=self.seed, **data)
        return rec

    # -- ops -----------------------------------------------------------
    def sigkill(self, node_id: str,
                slice_id: Optional[str] = None) -> dict:
        pid = self._pid(node_id)
        if pid is None:
            raise RuntimeError(f"chaos: no live process for {node_id}")
        os.kill(pid, signal.SIGKILL)
        return self._record("sigkill", node_id, pid=pid,
                            slice_id=slice_id or self._slice_of(node_id))

    def pause(self, node_id: str, duration_s: float = 5.0) -> dict:
        pid = self._pid(node_id)
        if pid is None:
            raise RuntimeError(f"chaos: no live process for {node_id}")
        os.kill(pid, signal.SIGSTOP)
        rec = self._record("pause", node_id, pid=pid, duration_s=duration_s,
                           slice_id=self._slice_of(node_id))
        self._after(duration_s, lambda: self._resume(pid, node_id))
        return rec

    def _resume(self, pid: int, node_id: str) -> None:
        try:
            os.kill(pid, signal.SIGCONT)
            self._record("resume", node_id, pid=pid)
        except ProcessLookupError:
            pass  # died (or was removed+killed) while paused

    def drop_messages(self, node_id: str, frac: float = 1.0,
                      duration_s: float = 5.0) -> dict:
        with self.node.lock:
            ns = self.node.nodes.get(node_id)
            if ns is None or ns.agent_conn is None:
                raise RuntimeError(
                    f"chaos: {node_id} has no agent connection to drop on")
        ns.agent_send({"type": "chaos_drop", "frac": float(frac),
                       "duration_s": float(duration_s), "seed": self.seed})
        return self._record("drop", node_id, frac=frac,
                            duration_s=duration_s,
                            slice_id=self._slice_of(node_id))

    def slow_node(self, node_id: str, duration_s: float = 5.0,
                  duty: float = 0.5) -> dict:
        pid = self._pid(node_id)
        if pid is None:
            raise RuntimeError(f"chaos: no live process for {node_id}")
        rec = self._record("slow", node_id, pid=pid, duration_s=duration_s,
                           duty=duty, slice_id=self._slice_of(node_id))

        def cycle():
            period = 0.1
            deadline = time.monotonic() + duration_s
            try:
                while time.monotonic() < deadline and not self._stop.is_set():
                    os.kill(pid, signal.SIGSTOP)
                    time.sleep(period * duty)
                    os.kill(pid, signal.SIGCONT)
                    time.sleep(period * (1.0 - duty))
            except ProcessLookupError:
                return
            finally:
                try:
                    os.kill(pid, signal.SIGCONT)
                except ProcessLookupError:
                    pass

        self._spawn(cycle)
        return rec

    def kill_serve_replica(self, deployment: str,
                           controller=None,
                           replica_tag: Optional[str] = None) -> dict:
        """SIGKILL one replica of a serve deployment (seeded-random among
        RUNNING replicas unless ``replica_tag`` pins one).  The pid comes
        from the replica itself (``stats()``), so this works for local
        and emulated-multihost replicas alike — the worker process just
        dies, exactly like a preempted host."""
        import ray_tpu_torch
        from ray_tpu_torch.serve._private.controller import (
            CONTROLLER_NAME, SERVE_NAMESPACE)

        if controller is None:
            controller = ray_tpu_torch.get_actor(CONTROLLER_NAME,
                                           namespace=SERVE_NAMESPACE)
        info = ray_tpu_torch.get(
            controller.get_routing_info.remote(deployment), timeout=10)
        if not info or not info["replicas"]:
            raise RuntimeError(
                f"chaos: deployment {deployment!r} has no RUNNING replica")
        replicas = sorted(info["replicas"], key=lambda rh: rh[0])
        if replica_tag is not None:
            cands = [rh for rh in replicas if rh[0] == replica_tag]
            if not cands:
                raise RuntimeError(
                    f"chaos: no RUNNING replica {replica_tag!r}")
            tag, handle = cands[0]
        else:
            tag, handle = self._rng.choice(replicas)
        stats = ray_tpu_torch.get(handle.stats.remote(), timeout=10)
        pid = int(stats["pid"])
        os.kill(pid, signal.SIGKILL)
        return self._record("kill_replica", tag, pid=pid,
                            deployment=deployment)

    def kill_tenant_driver(self, job_id: Optional[str] = None,
                           namespace: Optional[str] = None) -> dict:
        """SIGKILL one tenant's proxied driver subprocess (the isolated
        per-connection driver the client proxy spawned).  The pid comes
        from the head's tenant directory — the driver registered it at
        connect — so the kill is indistinguishable from the tenant's
        driver host dying: the head sees the client connection drop and
        reaps everything the job owned while other tenants keep running."""
        with self.node.lock:
            cands = [dict(rec) for rec in self.node._jobs.values()
                     if rec["alive"] and rec.get("proxied") and rec.get("pid")
                     and (job_id is None or rec["job_id"] == job_id)
                     and (namespace is None
                          or rec["namespace"] == namespace)]
        if not cands:
            raise RuntimeError(
                f"chaos: no live proxied tenant driver "
                f"(job_id={job_id!r}, namespace={namespace!r})")
        rec = (cands[0] if job_id or namespace
               else self._rng.choice(sorted(cands, key=lambda r: r["job_id"])))
        os.kill(int(rec["pid"]), signal.SIGKILL)
        return self._record("kill_tenant_driver", rec["job_id"],
                            pid=rec["pid"], namespace=rec["namespace"])

    def _slice_of(self, node_id: str) -> Optional[str]:
        with self.node.lock:
            ns = self.node.nodes.get(node_id)
            return ns.slice_id if ns is not None else None

    # -- schedule execution --------------------------------------------
    def start(self) -> "ChaosMonkey":
        self._thread = threading.Thread(target=self._run_schedule,
                                        daemon=True, name="chaos-monkey")
        self._thread.start()
        return self

    def _run_schedule(self) -> None:
        t0 = time.monotonic()
        for inj in self.schedule:
            delay = inj.at_s - (time.monotonic() - t0)
            if delay > 0 and self._stop.wait(delay):
                return
            try:
                self.inject(inj)
            except Exception as e:  # noqa: BLE001 — a missed injection
                # (target already dead) must not abort the schedule
                events_mod.emit("chaos", "injection failed",
                                severity="WARNING", entity_id=inj.target,
                                op=inj.op, error=str(e)[:200])

    def inject(self, inj: Injection) -> dict:
        if inj.op == "kill_replica":
            # target names the DEPLOYMENT; the replica is seeded-random
            return self.kill_serve_replica(
                inj.target, replica_tag=inj.params.get("replica_tag"))
        if inj.op == "kill_tenant_driver":
            # target names the tenant JOB (empty = seeded-random tenant)
            return self.kill_tenant_driver(
                job_id=inj.target or None,
                namespace=inj.params.get("namespace"))
        target = inj.target or self.pick(inj.slice_id)
        if inj.op == "sigkill":
            return self.sigkill(target, slice_id=inj.slice_id)
        if inj.op == "pause":
            return self.pause(target, inj.duration_s)
        if inj.op == "drop":
            return self.drop_messages(target, inj.frac, inj.duration_s)
        if inj.op == "slow":
            return self.slow_node(target, inj.duration_s, inj.duty)
        raise ValueError(f"unknown chaos op {inj.op!r}")

    def _after(self, delay: float, fn) -> None:
        def run():
            if not self._stop.wait(delay):
                fn()

        self._spawn(run)

    def _spawn(self, fn) -> None:
        t = threading.Thread(target=fn, daemon=True, name="chaos-op")
        t.start()
        self._timers.append(t)

    def stop(self) -> None:
        """Cancel pending schedule entries and resume anything paused
        (a SIGSTOPPED child outliving the test wedges process teardown)."""
        self._stop.set()
        for rec in self.injections:
            if rec["op"] == "pause":
                try:
                    os.kill(rec["pid"], signal.SIGCONT)
                except (ProcessLookupError, PermissionError):
                    pass
        if self._thread is not None:
            self._thread.join(timeout=5)
        for t in self._timers:
            t.join(timeout=1)
