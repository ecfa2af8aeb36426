"""WorkerGroup: the gang of training actors.

Analog of ``python/ray/train/_internal/worker_group.py:92``: N actors
created inside a placement group (gang semantics: the ranks lease
together and die together), with broadcast execution and per-worker
result queues.  A rank that holds ``"GPU"`` is a dedicated actor worker
whose ``CUDA_VISIBLE_DEVICES`` is its grant.
"""

from __future__ import annotations

import queue
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.air import session as air_session
from ray_tpu_torch.util.placement_group import placement_group, remove_placement_group
from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy


class TrainWorker:
    """Actor hosting one rank of the training gang.

    The user's train fn runs on a dedicated thread so the actor stays
    responsive to ``next_result`` polls (the reference gets this from its
    async result queue in ``_TrainSession``).
    """

    def __init__(self, rank: int, world_size: int):
        self.rank = rank
        self.world_size = world_size
        self.queue: "queue.Queue" = queue.Queue()
        self.thread: Optional[threading.Thread] = None
        self.env: Dict[str, str] = {}

    def setup_env(self, env: Dict[str, str]) -> bool:
        import os

        self.env = env
        os.environ.update(env)
        return True

    def join_collective_group(self, world_size: int, rank: int, group_name: str,
                              backend: str = "shm") -> bool:
        from ray_tpu_torch.util import collective

        collective.init_collective_group(world_size, rank, backend=backend,
                                         group_name=group_name)
        return True

    def execute(self, fn_blob: bytes, *args, **kwargs):
        """Run a pickled callable synchronously and return its result."""
        fn = cloudpickle.loads(fn_blob)
        return fn(*args, **kwargs)

    def run_train_fn(
        self, fn_blob: bytes, config: Optional[dict],
        session_kwargs: Dict[str, Any],
    ) -> bool:
        fn = cloudpickle.loads(fn_blob)
        ckpt = session_kwargs.pop("checkpoint", None)

        def report_fn(metrics, checkpoint):
            self.queue.put(("report", metrics, checkpoint))

        sess = air_session._Session(
            world_size=self.world_size, world_rank=self.rank,
            local_rank=self.rank, checkpoint=ckpt,
            report_fn=report_fn, **session_kwargs,
        )

        def runner():
            air_session._set_session(sess)
            try:
                if config is not None:
                    fn(config)
                else:
                    fn()
                self.queue.put(("finished", None, None))
            except BaseException:  # noqa: BLE001
                self.queue.put(("error", traceback.format_exc(), None))
            finally:
                air_session._set_session(None)

        self.thread = threading.Thread(target=runner, daemon=True)
        self.thread.start()
        return True

    def next_result(self, timeout: float = 30.0):
        """One queued event, or ("pending", None, None) on timeout."""
        try:
            return self.queue.get(timeout=timeout)
        except queue.Empty:
            return ("pending", None, None)


def _check_cluster_fits(num_workers: int,
                        resources_per_worker: Dict[str, float]) -> None:
    """Raise at once, naming the resource, when the cluster cannot hold the
    gang at all (a placement group would otherwise wait out its timeout)."""
    total = ray_tpu_torch.cluster_resources()
    for name, amount in resources_per_worker.items():
        need = amount * num_workers
        if total.get(name, 0.0) + 1e-9 < need:
            hint = (" (ScalingConfig(use_gpu=False) trains on the CPU)"
                    if name == "GPU" else "")
            raise RuntimeError(
                f"the cluster has {total.get(name, 0.0):g} {name} and the "
                f"training gang needs {need:g} ({num_workers} workers x "
                f"{amount:g}){hint}")


class WorkerGroup:
    def __init__(
        self,
        num_workers: int,
        resources_per_worker: Dict[str, float],
        placement_strategy: str = "PACK",
    ):
        self.num_workers = num_workers
        self.resources_per_worker = dict(resources_per_worker)
        _check_cluster_fits(num_workers, resources_per_worker)
        bundles = [dict(resources_per_worker) for _ in range(num_workers)]
        self.pg = placement_group(bundles, strategy=placement_strategy)
        ray_tpu_torch.get(self.pg.ready(), timeout=60)
        Worker = ray_tpu_torch.remote(TrainWorker)
        opts: Dict[str, Any] = {}
        if "CPU" in resources_per_worker:
            opts["num_cpus"] = resources_per_worker["CPU"]
        if "GPU" in resources_per_worker:
            opts["num_gpus"] = resources_per_worker["GPU"]
        self.workers = [
            Worker.options(
                **opts,
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    placement_group=self.pg, placement_group_bundle_index=i
                ),
            ).remote(i, num_workers)
            for i in range(num_workers)
        ]

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        """Run ``fn`` on every worker, gathered (worker_group.py:92 analog)."""
        blob = cloudpickle.dumps(fn)
        return ray_tpu_torch.get(
            [w.execute.remote(blob, *args, **kwargs) for w in self.workers],
            timeout=300,
        )

    def execute_single(self, rank: int, fn: Callable, *args, **kwargs) -> Any:
        blob = cloudpickle.dumps(fn)
        return ray_tpu_torch.get(
            self.workers[rank].execute.remote(blob, *args, **kwargs), timeout=300
        )

    def shutdown(self) -> None:
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        try:
            remove_placement_group(self.pg)
        except Exception:
            pass
