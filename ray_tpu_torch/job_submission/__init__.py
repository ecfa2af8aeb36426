"""Job submission SDK — ``ray.job_submission`` analog.

``JobSubmissionClient`` (reference ``dashboard/modules/job/sdk.py``, REST
head ``job_head.py``) drives the head's JobManager: submit an entrypoint
shell command as a cluster driver, poll status, fetch logs, stop.  The
driver joins the cluster through ``RAY_TPU_TORCH_ADDRESS``, which the head
puts in its env.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = {SUCCEEDED, FAILED, STOPPED}


class JobSubmissionClient:
    """Talks to the head over the existing control connection.  With no
    argument, uses the current driver session; pass ``address`` (a
    ``tcp://host:port`` from ``python -m ray_tpu_torch start --head`` or
    ``autoscaler.commands.up``) to attach from outside."""

    def __init__(self, address: Optional[str] = None, authkey: Optional[bytes] = None):
        if address is None:
            from ray_tpu_torch._private.worker import global_worker

            if not global_worker.connected:
                raise RuntimeError("no ray_tpu_torch session; init() first or pass address")
            self._client = global_worker.client
            self._owned = False
        else:
            import os

            from ray_tpu_torch._private.client import CoreClient

            authkey = authkey or bytes.fromhex(os.environ["RAY_TPU_TORCH_AUTHKEY"])
            self._client = CoreClient(address, authkey)
            self._client.register_client()
            self._owned = True

    def submit_job(self, *, entrypoint: str, runtime_env: Optional[dict] = None,
                   job_id: Optional[str] = None,
                   metadata: Optional[Dict[str, str]] = None) -> str:
        """Start ``entrypoint`` as a driver on the head's host.
        ``runtime_env`` takes ``env_vars``, ``working_dir`` and
        ``py_modules``: local directories are zipped and uploaded to the
        head's KV first (once per content), and the driver runs in the
        extracted working_dir with the py_modules on its ``PYTHONPATH``.
        A ``job_id`` already in use raises ``ValueError``."""
        if runtime_env and (runtime_env.get("working_dir")
                            or runtime_env.get("py_modules")):
            # ship local code as content-addressed packages so the job
            # driver runs inside it on the HEAD host (reference
            # sdk.py upload_working_dir_if_needed)
            from ray_tpu_torch._private.runtime_env_packaging import (
                prepare_runtime_env,
            )

            runtime_env = prepare_runtime_env(runtime_env, self._client)
        value = self._client.request({
            "type": "submit_job", "entrypoint": entrypoint,
            "runtime_env": runtime_env, "job_id": job_id, "metadata": metadata,
        })["value"]
        if isinstance(value, dict) and "__state_error__" in value:
            raise ValueError(value["__state_error__"])
        return value

    def get_job_info(self, job_id: str) -> Optional[dict]:
        return self._client.request({"type": "job_info", "job_id": job_id})["value"]

    def get_job_status(self, job_id: str) -> Optional[str]:
        info = self.get_job_info(job_id)
        return info["status"] if info else None

    def get_job_logs(self, job_id: str) -> str:
        return self._client.request({"type": "job_logs", "job_id": job_id})["value"]

    def stop_job(self, job_id: str) -> bool:
        return self._client.request({"type": "stop_job", "job_id": job_id})["value"]

    def list_jobs(self) -> List[dict]:
        return self._client.request({"type": "list_state", "what": "jobs",
                                     "limit": 10_000})["value"]

    def wait_until_finish(self, job_id: str, timeout: float = 300.0,
                          poll_s: float = 0.5) -> str:
        deadline = time.time() + timeout
        status = None
        while time.time() < deadline:
            status = self.get_job_status(job_id)
            if status in JobStatus.TERMINAL:
                return status
            time.sleep(poll_s)
        raise TimeoutError(f"job {job_id} still {status} after {timeout}s")

    def close(self) -> None:
        if self._owned:
            self._client.close()


__all__ = ["JobSubmissionClient", "JobStatus"]
