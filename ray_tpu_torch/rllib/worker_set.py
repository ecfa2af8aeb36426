"""WorkerSet: the local learner-side worker and the remote rollout actors.

Counterpart of ``ray_tpu/rllib/worker_set.py`` (the reference's
``rllib/evaluation/worker_set.py:77`` and the execution op it feeds,
``execution/rollout_ops.py:21`` ``synchronous_parallel_sample``): remote
workers are actors of the port's runtime that sample in parallel; weight
sync broadcasts one ``put`` object to all of them.

Each worker's device follows what the config grants it, and nothing
falls back.  The local worker's policy lives on ``config["device"]``
(the card when None).  A remote worker asks for
``num_gpus_per_worker`` cards (default 0): with none it builds its
policy on the CPU, with a share it asks the runtime for it and builds on
the card, raising when it sees none.  A worker whose policy is a
``RemotePolicy`` holds no tensor, so the device it is given is unused.
``config["_worker_class"]`` replaces ``RolloutWorker`` on every seat
(``MultiAgentPPO`` sets ``MultiAgentRolloutWorker``).
"""

from __future__ import annotations

from typing import Any, Dict, List

import ray_tpu_torch
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker
from ray_tpu_torch.rllib.sample_batch import SampleBatch


def _has_stats(blob) -> bool:
    """True when a stat-states/deltas blob carries anything: per-policy
    dicts hold positional lists whose stateless-connector entries are
    None."""
    if isinstance(blob, dict):
        return any(_has_stats(v) for v in blob.values())
    if isinstance(blob, (list, tuple)):
        return any(x is not None for x in blob)
    return blob is not None


class WorkerSet:
    def __init__(self, config: Dict[str, Any]):
        self.config = config
        n = config.get("num_rollout_workers", 0)
        worker_cls = config.get("_worker_class") or RolloutWorker
        # the local worker holds the learner policy; it also samples when n == 0
        self.local_worker = worker_cls(config, worker_index=0, device=config.get("device"))
        gpus = config.get("num_gpus_per_worker") or 0
        # rollout workers restart on crash and retry the in-flight sample;
        # sync_weights re-broadcasts the policy each training step anyway
        opts = {"num_cpus": config.get("num_cpus_per_worker", 1),
                "max_restarts": 2, "max_task_retries": 2}
        if gpus:
            opts["num_gpus"] = gpus
        RemoteWorker = ray_tpu_torch.remote(worker_cls)
        self.remote_workers = [
            RemoteWorker.options(**opts).remote(config, worker_index=i + 1,
                                                device="cuda" if gpus else "cpu")
            for i in range(n)
        ]

    # ------------------------------------------------------------------
    def sync_weights(self) -> None:
        """Broadcast the local worker's weights to all remotes (one shared
        object, not one copy per worker)."""
        if not self.remote_workers:
            return
        ref = ray_tpu_torch.put(self.local_worker.get_weights())
        ray_tpu_torch.get([w.set_weights.remote(ref) for w in self.remote_workers], timeout=120)

    def sync_connectors(self) -> None:
        """Broadcast the local worker's connector-pipeline state (a restored
        running-stat filter, say) to all remotes."""
        if not self.remote_workers:
            return
        state = self.local_worker.get_connector_state()
        ray_tpu_torch.get([w.set_connector_state.remote(state) for w in self.remote_workers],
                          timeout=120)

    def sync_filters(self) -> None:
        """Fold the remote workers' running-stat deltas (Welford buffers)
        into the local worker's pipelines and broadcast the merged
        statistics back (``FilterManager.synchronize``).  Statistics only:
        per-env episode state (frame stacks) is never touched.  Skipped
        when the pipelines carry no statistics."""
        if not self.remote_workers or not _has_stats(
                self.local_worker.get_connector_stat_states()):
            return
        deltas = ray_tpu_torch.get(
            [w.pop_connector_stat_deltas.remote() for w in self.remote_workers], timeout=120)
        for d in deltas:
            if _has_stats(d):
                self.local_worker.apply_connector_stat_deltas(d)
        merged = self.local_worker.get_connector_stat_states()
        ray_tpu_torch.get(
            [w.set_connector_stat_states.remote(merged) for w in self.remote_workers],
            timeout=120)

    def sync_global_vars(self, timesteps_total: int) -> None:
        """Broadcast the global env-step count, so per-worker exploration
        schedules (epsilon's anneal) follow global progress."""
        self.local_worker.set_global_vars(timesteps_total)
        if self.remote_workers:
            ray_tpu_torch.get(
                [w.set_global_vars.remote(timesteps_total) for w in self.remote_workers],
                timeout=120)

    def synchronous_parallel_sample(self) -> SampleBatch:
        """One sampling round across all workers."""
        if not self.remote_workers:
            return self.local_worker.sample()
        batches = ray_tpu_torch.get([w.sample.remote() for w in self.remote_workers],
                                    timeout=600)
        # MultiAgentBatch and SampleBatch both expose concat_samples
        return type(batches[0]).concat_samples(batches)

    def collect_metrics(self) -> List[Dict[str, Any]]:
        if not self.remote_workers:
            return [self.local_worker.get_metrics()]
        return ray_tpu_torch.get([w.get_metrics.remote() for w in self.remote_workers],
                                 timeout=300)

    def stop(self) -> None:
        for w in self.remote_workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
