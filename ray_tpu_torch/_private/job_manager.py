"""Job submission manager — runs in the head process.

Analog of the reference's ``JobManager``/``JobSupervisor``
(``dashboard/modules/job/job_manager.py:431,133``): an entrypoint shell
command runs as a driver subprocess with the cluster address in its env,
stdout/stderr captured to a per-job log file under the session directory,
and a monitor thread tracking terminal status.

``runtime_env`` takes ``env_vars``, ``working_dir`` and ``py_modules``.
A submitter uploads local code first (``job_submission``), so the head
sees ``gcs://pkg-…`` URIs: it extracts each from its own KV into the
node-local package cache, runs the driver with the working_dir package
as its cwd and the py_modules packages on its ``PYTHONPATH``, moves its
pins to the driver's pid while the job runs, and drops them when the job
ends.  A package that cannot be materialised fails the job before it
launches, its log naming the cause.
"""

from __future__ import annotations

import os
import signal
import subprocess
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional


@dataclass
class JobInfo:
    job_id: str
    entrypoint: str
    status: str = "PENDING"  # PENDING/RUNNING/SUCCEEDED/FAILED/STOPPED
    start_time: float = field(default_factory=time.time)
    end_time: Optional[float] = None
    returncode: Optional[int] = None
    metadata: Dict[str, str] = field(default_factory=dict)
    log_path: str = ""


class JobManager:
    def __init__(self, node):
        self.node = node
        self.jobs: Dict[str, JobInfo] = {}
        self.procs: Dict[str, subprocess.Popen] = {}
        # job_id -> the package dirs its driver runs in (pinned to its pid)
        self.packages: Dict[str, List[str]] = {}
        self.lock = threading.Lock()
        self.log_dir = os.path.join(node.session_dir, "jobs")
        os.makedirs(self.log_dir, exist_ok=True)

    def _fail_pre_launch(self, job_id: str, entrypoint: str, log_path: str,
                         message: str) -> str:
        """Record a job that failed before its process launched."""
        info = JobInfo(job_id=job_id, entrypoint=entrypoint,
                       log_path=log_path, status="FAILED",
                       end_time=time.time())
        with self.lock:
            self.jobs[job_id] = info
        try:
            with open(log_path, "w") as f:
                f.write(message + "\n")
        except OSError:
            pass
        return job_id

    def submit(self, entrypoint: str, runtime_env: Optional[dict] = None,
               job_id: Optional[str] = None,
               metadata: Optional[Dict[str, str]] = None) -> str:
        job_id = job_id or f"job-{os.urandom(4).hex()}"
        log_path = os.path.join(self.log_dir, f"{job_id}.log")
        # reserve the id under the lock so two racing submits with the same
        # explicit job_id can't both launch
        placeholder = JobInfo(job_id=job_id, entrypoint=entrypoint, log_path=log_path)
        with self.lock:
            if job_id in self.jobs:
                raise ValueError(f"job {job_id} already exists")
            self.jobs[job_id] = placeholder
        env = dict(os.environ)
        cwd = None
        module_paths: list = []
        materialized: list = []  # package dirs pinned by THIS process
        if runtime_env:
            from ray_tpu_torch._private.runtime_env_packaging import (
                PKG_KV_NAMESPACE, ensure_package_local, is_package_uri,
            )

            def materialize(uri: str) -> str:
                # a remote submitter uploaded local code as content-
                # addressed packages; extract from the head's own KV
                d = ensure_package_local(
                    lambda u: self.node.gcs.kv_get(
                        PKG_KV_NAMESPACE, u.encode()), uri,
                    pin_suffix=job_id)
                materialized.append(d)
                return d

            try:
                env.update(runtime_env.get("env_vars") or {})
                cwd = runtime_env.get("working_dir")
                if is_package_uri(cwd):
                    cwd = materialize(cwd)
                # py_modules go on the DRIVER's PYTHONPATH (the reference
                # installs them through the agent before the driver starts)
                for m in runtime_env.get("py_modules") or []:
                    module_paths.append(materialize(m) if is_package_uri(m)
                                        else m)
            except Exception as e:  # noqa: BLE001 — a bad/missing package
                # fails THIS job with a readable log, never the reader
                # loop (that would close the submitter's connection and
                # leak the reserved job id)
                self._unpin(materialized, job_id)
                return self._fail_pre_launch(
                    job_id, entrypoint, log_path,
                    f"runtime_env package setup failed: {e}")
        host, port = self.node.tcp_address
        env["RAY_TPU_TORCH_ADDRESS"] = f"tcp://{host}:{port}"
        env["RAY_TPU_TORCH_AUTHKEY"] = self.node.authkey.hex()
        env["RAY_TPU_TORCH_JOB_ID"] = job_id
        # the entrypoint driver must resolve this framework regardless of
        # its cwd (the reference ships the working dir via runtime_env)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        parts = module_paths + [pkg_root]
        if env.get("PYTHONPATH"):
            parts.append(env["PYTHONPATH"])
        env["PYTHONPATH"] = os.pathsep.join(parts)
        info = JobInfo(job_id=job_id, entrypoint=entrypoint,
                       metadata=dict(metadata or {}), log_path=log_path)
        log_f = open(log_path, "wb")
        try:
            proc = subprocess.Popen(
                entrypoint, shell=True, env=env, cwd=cwd,
                stdout=log_f, stderr=subprocess.STDOUT,
                start_new_session=True,  # stop_job kills the whole group
            )
        except OSError as e:
            self._unpin(materialized, job_id)
            return self._fail_pre_launch(job_id, entrypoint, log_path,
                                         f"failed to launch: {e}")
        finally:
            log_f.close()
        # the packages now belong to the job process: transfer the head's
        # pins so the cache can evict them once the job exits (a
        # long-lived head must not pin every job's code forever)
        if materialized:
            from ray_tpu_torch._private.runtime_env_packaging import repin

            for d in materialized:
                repin(d, proc.pid, suffix=job_id)
        info.status = "RUNNING"
        with self.lock:
            self.jobs[job_id] = info
            self.procs[job_id] = proc
            self.packages[job_id] = materialized
        threading.Thread(target=self._monitor, args=(job_id, proc),
                         daemon=True, name=f"job-monitor-{job_id}").start()
        return job_id

    @staticmethod
    def _unpin(dirs: List[str], job_id: str, pid: Optional[int] = None) -> None:
        from ray_tpu_torch._private.runtime_env_packaging import unpin

        for d in dirs:
            unpin(d, pid=pid, suffix=None if pid else job_id)

    def _monitor(self, job_id: str, proc: subprocess.Popen) -> None:
        rc = proc.wait()
        with self.lock:
            dirs = self.packages.pop(job_id, [])
        # the driver is gone: its packages become evictable at once
        self._unpin(dirs, job_id, pid=proc.pid)
        with self.lock:
            info = self.jobs.get(job_id)
            self.procs.pop(job_id, None)
            if info is None or info.status == "STOPPED":
                return
            info.returncode = rc
            info.end_time = time.time()
            info.status = "SUCCEEDED" if rc == 0 else "FAILED"

    def stop(self, job_id: str) -> bool:
        with self.lock:
            info = self.jobs.get(job_id)
            proc = self.procs.get(job_id)
        if info is None:
            return False
        if proc is not None and proc.poll() is None:
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
            except OSError:
                proc.kill()
            with self.lock:
                info.status = "STOPPED"
                info.end_time = time.time()
            return True
        return False

    def info(self, job_id: str) -> Optional[dict]:
        with self.lock:
            info = self.jobs.get(job_id)
        return asdict(info) if info else None

    def logs(self, job_id: str) -> str:
        with self.lock:
            info = self.jobs.get(job_id)
        if info is None or not os.path.exists(info.log_path):
            return ""
        with open(info.log_path, "r", errors="replace") as f:
            return f.read()

    def list_jobs(self) -> List[dict]:
        with self.lock:
            return [asdict(i) for i in self.jobs.values()]

    def shutdown(self) -> None:
        with self.lock:
            procs = list(self.procs.items())
        for _, proc in procs:
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            except OSError:
                pass
