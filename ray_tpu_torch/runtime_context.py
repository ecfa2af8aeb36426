"""Runtime context (analog of ``python/ray/runtime_context.py``)."""

from __future__ import annotations

import os
from typing import List, Optional

from ray_tpu_torch._private.worker import global_worker


class RuntimeContext:
    @property
    def node_id(self) -> str:
        return global_worker.node_id

    @property
    def worker_id(self) -> Optional[bytes]:
        return global_worker.worker_id or None

    @property
    def task_id(self) -> Optional[bytes]:
        return global_worker.current_task_id

    @property
    def actor_id(self) -> Optional[bytes]:
        return global_worker.current_actor_id

    @property
    def namespace(self) -> str:
        """The tenant namespace this code runs under: the driver's own
        (assigned at ``init(namespace=...)``; proxied tenants default to
        an isolated per-job namespace), or — inside a task/actor method —
        the namespace of the job that submitted it."""
        return (global_worker.current_namespace
                or global_worker.namespace or "default")

    @property
    def job_id(self) -> Optional[str]:
        """The submitting job's id (``job-NNNN``), the unit the head
        attributes ownership/metrics to and reaps on driver death."""
        return global_worker.current_job_id or global_worker.job_id

    def get_gpu_ids(self) -> List[int]:
        """The card ids granted to the current task or actor, as the head
        numbers them (``CUDA_VISIBLE_DEVICES`` holds the same ids, so
        inside the worker the first granted card is ``cuda:0``).  Empty in
        the driver and in a worker that holds no GPU."""
        raw = os.environ.get("RAY_TPU_TORCH_ASSIGNED_GPUS", "")
        return [int(x) for x in raw.split(",") if x.strip()]


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext()
