"""APPO: asynchronous PPO, IMPALA's architecture with PPO's objective.

Counterpart of ``ray_tpu/rllib/appo.py`` (the reference's
``rllib/algorithms/appo/appo.py``, which composes the IMPALA execution
plan with the clipped surrogate; ``appo_torch_policy.py`` applies the
surrogate over V-trace advantages).  The composition is literal:

- loss: PPO's clipped surrogate (``ppo.make_ppo_loss``: the ratio is
  exp(current - behavior logp), which is what stale async samples need)
  over V-trace-corrected advantages and targets.
- correction: :meth:`Impala._vtrace_batch` (inherited) recomputes the
  advantages with the current learner policy, so the staleness of async
  sampling is handled by rho/c clipping, not ignored.
- execution: every remote rollout worker always has a ``sample()`` in
  flight; the learner trains on the batches that land first and re-arms
  each of those workers with fresh weights at once (the async
  rollout/learner overlap of ``execution/train_ops.py:82``).  No sampling
  barrier: a slow worker never stalls the learner.

With no remote workers the step samples synchronously (the local
worker) and learns as the async step does.  The JAX package falls back to
IMPALA's step there, whose required keys drop the behavior logp that
APPO's loss reads, and raises ``KeyError``.

The weights a step pushes are ``get_weights()``'s host copies, put once a
step: a worker on the CPU loads them as one on a share of the card does.
``cleanup`` drops the in-flight samples and kills the workers, which ends
their samples and gives back their grants (the port's ``cancel`` refuses
``force=True`` for actor tasks, and a kill needs none).
"""

from __future__ import annotations

from typing import Any, Dict

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import synchronous_parallel_sample, train_one_step
from ray_tpu_torch.rllib.impala import Impala, ImpalaConfig
from ray_tpu_torch.rllib.ppo import make_ppo_loss
from ray_tpu_torch.rllib.sample_batch import SampleBatch

APPO_KEYS = (SampleBatch.OBS, SampleBatch.ACTIONS, SampleBatch.ACTION_LOGP,
             SampleBatch.ADVANTAGES, SampleBatch.VALUE_TARGETS)


def _appo_loss_factory(config: Dict[str, Any]):
    """PPO's clipped surrogate; V-trace supplies the advantages and value
    targets, and the behavior logp anchors the ratio."""
    return make_ppo_loss(config["clip_param"], config["vf_clip_param"],
                         config["vf_loss_coeff"], config["entropy_coeff"])


class APPOConfig(ImpalaConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = APPO
        self._config.update(
            _loss_factory=_appo_loss_factory,
            clip_param=0.3,
            vf_clip_param=10.0,
            num_sgd_iter=1,        # async batches go stale fast
            minibatch_size=128,
            # how many completed worker batches one training_step consumes
            # (1 = train the moment anything lands; higher amortizes the
            # device step over more data)
            batches_per_step=1,
        )


class APPO(Impala):
    def setup(self, config: Dict[str, Any]) -> None:
        super().setup(config)
        # ref -> the remote worker with that sample() in flight
        self._inflight: Dict[Any, Any] = {}
        self._weights_ref = None

    def _arm(self, worker) -> None:
        """Push the current weights to ``worker`` and start its next
        sample, both without waiting: the actor runs them in order."""
        if self._weights_ref is None:
            self._weights_ref = ray_tpu_torch.put(self.workers.local_worker.get_weights())
        worker.set_weights.remote(self._weights_ref)
        self._inflight[worker.sample.remote()] = worker

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        workers = self.workers.remote_workers
        if not workers:
            # no async seats: sample synchronously, learn as below
            self.workers.sync_weights()
            return self._learn(synchronous_parallel_sample(
                self.workers, max_env_steps=cfg["train_batch_size"]))

        self._weights_ref = None  # one snapshot a training step
        for w in workers:
            if w not in self._inflight.values():
                self._arm(w)
        batches = []
        want = max(1, int(cfg.get("batches_per_step", 1)))
        while len(batches) < want:
            ready, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1)
            ref = ready[0]
            worker = self._inflight.pop(ref)
            try:
                batches.append(ray_tpu_torch.get(ref))
            except Exception:
                # the worker died mid-sample: it restarts (max_restarts);
                # re-arm it and learn from the others
                pass
            self._arm(worker)  # overlap: its next sample runs during our SGD
        return self._learn(SampleBatch.concat_samples(batches))

    def _learn(self, batch: SampleBatch) -> Dict[str, Any]:
        """The clipped surrogate's minibatch SGD over ``batch``'s V-trace
        batch, from the current learner policy."""
        cfg = self.config
        self._timesteps_total += batch.count
        learner_metrics = train_one_step(
            self.workers.local_worker.policy, self._vtrace_batch(batch),
            num_sgd_iter=cfg["num_sgd_iter"], sgd_minibatch_size=cfg["minibatch_size"],
            rng=self._sgd_rng, required_keys=APPO_KEYS)
        return {"info": {"learner": learner_metrics}}

    def cleanup(self) -> None:
        self._inflight.clear()
        self._weights_ref = None
        super().cleanup()


APPO._default_config = APPOConfig().to_dict()
