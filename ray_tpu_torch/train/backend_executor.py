"""BackendExecutor: drives the worker gang through a training run.

Analog of ``python/ray/train/_internal/backend_executor.py:42`` (``start``
``:93``, ``_create_placement_group`` ``:137``, ``start_training`` ``:314``,
``get_next_results`` ``:411``) — placement-group creation lives inside
WorkerGroup here; this class owns backend setup, launching the train fn,
and draining per-worker result queues in lockstep.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch._private import events as _events
from ray_tpu_torch.air import Checkpoint, ScalingConfig
from ray_tpu_torch.train.backend import Backend, BackendConfig
from ray_tpu_torch.train.worker_group import WorkerGroup


class TrainingFailedError(RuntimeError):
    pass


class BackendExecutor:
    def __init__(
        self,
        backend_config: BackendConfig,
        scaling_config: ScalingConfig,
        prior_gang_starts: int = 0,
    ):
        self.backend_config = backend_config
        self.scaling_config = scaling_config
        self.backend: Backend = backend_config.backend_cls()
        self.worker_group: Optional[WorkerGroup] = None
        self._finished: List[bool] = []
        # fit() builds a FRESH executor per whole-gang restart: the prior
        # start count must ride along or every incarnation reads as the
        # first and the flight recorder never shows "gang restarted"
        self._gang_starts = prior_gang_starts

    def start(self) -> None:
        sc = self.scaling_config
        self._gang_starts += 1
        self.worker_group = WorkerGroup(
            sc.num_workers, sc.worker_resources, sc.placement_strategy
        )
        self.backend.on_start(self.worker_group, self.backend_config)
        _events.emit(
            "train",
            "gang restarted" if self._gang_starts > 1 else "gang started",
            severity="WARNING" if self._gang_starts > 1 else "INFO",
            world_size=sc.num_workers, start_no=self._gang_starts)

    def worker_node_ids(self) -> List[str]:
        """Which node each rank's actor landed on (the locality input to
        DataConfig: rank i's streaming shard materializes its blocks on
        node ``worker_node_ids()[i]``)."""
        if self.worker_group is None:
            return []

        def node_of_self():
            import ray_tpu_torch as _rt

            return _rt.get_runtime_context().node_id

        return self.worker_group.execute(node_of_self)

    def perf_summaries(self) -> List[Optional[dict]]:
        """Per-rank step-profiler summaries (None for ranks whose train
        fn never installed one): phase totals, live MFU, compile table,
        last HBM sample — the device-time attribution artifact collected
        off the gang after (or during) a run.  Also emits one ``perf``
        flight-recorder event with the gang-level aggregate so the
        doctor and the timeline see a run's final numbers even when
        nobody polls the executor."""
        if self.worker_group is None:
            return []

        def _local():
            from ray_tpu_torch.util import perf as _perf

            return _perf.local_summary()

        summaries = self.worker_group.execute(_local)
        ranks = [s for s in summaries if s]
        if ranks:
            mfus = [s["mfu"]["mean"] for s in ranks
                    if (s.get("mfu") or {}).get("mean") is not None]
            _events.emit(
                "perf", "gang perf summary", severity="INFO",
                world_size=len(summaries),
                profiled_ranks=len(ranks),
                steps=sum(s.get("steps", 0) for s in ranks),
                mean_mfu=round(sum(mfus) / len(mfus), 5) if mfus else None)
        return summaries

    def start_training(
        self,
        train_fn: Callable,
        config: Optional[Dict] = None,
        checkpoint: Optional[Checkpoint] = None,
        datasets: Optional[Dict[str, Any]] = None,
        data_config=None,
        trial_info: Optional[Dict[str, str]] = None,
    ) -> None:
        dataset_shards = None
        if datasets:
            # shard wiring happens HERE, not in the trainer: only the
            # executor knows which node each rank landed on, and the
            # streaming split needs those node ids as locality hints
            from ray_tpu_torch.train.data_config import DataConfig

            data_config = data_config or DataConfig()
            dataset_shards = data_config.configure(
                datasets, self.worker_group.num_workers,
                self.worker_node_ids())
        self.backend.on_training_start(self.worker_group, self.backend_config)
        blob = cloudpickle.dumps(train_fn)
        futures = []
        for i, w in enumerate(self.worker_group.workers):
            session_kwargs: Dict[str, Any] = {
                "checkpoint": checkpoint,
                "trial_name": (trial_info or {}).get("name", ""),
                "trial_id": (trial_info or {}).get("id", ""),
            }
            if dataset_shards is not None:
                session_kwargs["dataset_shards"] = dataset_shards[i]
            futures.append(w.run_train_fn.remote(blob, config, session_kwargs))
        ray_tpu_torch.get(futures, timeout=300)
        self._finished = [False] * self.worker_group.num_workers

    def get_next_results(self, timeout: float = 600.0) -> Optional[List[tuple]]:
        """One (kind, payload, checkpoint) per still-running worker; None
        when every worker has finished.  A worker error raises — gang
        training is all-or-nothing (a straggler is a distributed deadlock,
        so failures surface immediately)."""
        import time

        if self.worker_group is None:
            return None
        if all(self._finished):
            return None
        from ray_tpu_torch.air import session as air_session

        deadline = time.monotonic() + timeout
        results: Dict[int, tuple] = {}
        while time.monotonic() < deadline:
            if air_session.is_stop_requested():
                # Hosting trial superseded: surface as "done" so fit()
                # returns and its finally releases the gang's placement
                # group promptly instead of holding cards past the reset.
                return None
            pending = [
                i for i in range(self.worker_group.num_workers)
                if not self._finished[i] and i not in results
            ]
            if not pending:
                break
            futs = {
                i: self.worker_group.workers[i].next_result.remote(timeout=5.0)
                for i in pending
            }
            for i, f in futs.items():
                try:
                    kind, payload, ckpt = ray_tpu_torch.get(f, timeout=60)
                except (ray_tpu_torch.exceptions.RayActorError,
                        ray_tpu_torch.exceptions.WorkerCrashedError) as e:
                    # worker PROCESS death is a gang failure exactly like an
                    # in-loop exception — fit()'s whole-gang restart must
                    # see one error type.  Other RayErrors (get timeouts,
                    # cancellations) are NOT deaths and propagate as-is.
                    _events.emit("train", f"gang failure: rank {i} died",
                                 severity="ERROR", rank=i,
                                 error=f"{type(e).__name__}: {e}"[:200])
                    raise TrainingFailedError(
                        f"worker {i} died: {type(e).__name__}: {e}"
                    ) from e
                if kind == "pending":
                    continue
                if kind == "error":
                    _events.emit("train", f"gang failure: rank {i} errored",
                                 severity="ERROR", rank=i,
                                 error=str(payload)[:200])
                    raise TrainingFailedError(
                        f"worker {i} failed:\n{payload}"
                    )
                if kind == "finished":
                    self._finished[i] = True
                    continue
                results[i] = (kind, payload, ckpt)
        if all(self._finished) and not results:
            return None
        return [results[i] for i in sorted(results)] if results else []

    def shutdown(self) -> None:
        if self.worker_group is not None:
            self.backend.on_shutdown(self.worker_group, self.backend_config)
            self.worker_group.shutdown()
            self.worker_group = None
