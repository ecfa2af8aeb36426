"""Training backends: per-framework gang setup.

``Backend``/``BackendConfig`` mirror ``python/ray/train/backend.py:55,43``.
:class:`TorchConfig` stands where the JAX package has ``JaxConfig``
(``ray_tpu/train/backend.py``), and does what the reference's torch config
does (``torch/config.py:69``):

- every rank gets the ``RAY_TRAIN_*`` environment and joins the gang's
  collective group, named uniquely for the run;
- with the ``torch`` process group (the seat of ``use_jax_distributed``)
  rank 0 publishes a ``tcp://`` rendezvous address on a free port and
  every worker calls ``parallel.mesh.init_world`` on its device: NCCL on
  its granted card, gloo where the worker holds no GPU.  The gang's
  collective group is then the ``"torch"`` group over that world; without
  it, the ``"shm"`` group through the object store.

``use_torch_distributed`` is chosen from the grant unless it is set: a
gang whose workers hold GPUs gets the ``torch`` group, so its gradients
stay on the cards (NCCL); CPU ranks get the ``shm`` group.  ``False`` on
GPU workers asks for the ``shm`` group on purpose (every gradient then
crosses the host); ``True`` on CPU ranks makes a gloo world.
"""

from __future__ import annotations

import dataclasses
import uuid
from typing import Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.train.worker_group import WorkerGroup


@dataclasses.dataclass
class BackendConfig:
    @property
    def backend_cls(self):
        return Backend


class Backend:
    def on_start(self, worker_group: WorkerGroup, backend_config: "BackendConfig"):
        pass

    def on_training_start(self, worker_group: WorkerGroup, backend_config: "BackendConfig"):
        pass

    def on_shutdown(self, worker_group: WorkerGroup, backend_config: "BackendConfig"):
        pass


@dataclasses.dataclass
class TorchConfig(BackendConfig):
    use_torch_distributed: Optional[bool] = None  # None: from the grant

    @property
    def backend_cls(self):
        return _TorchBackend


def _uses_torch_group(cfg: TorchConfig, resources_per_worker: dict) -> bool:
    """The ``torch`` group where ``cfg`` asks for it, else where the
    workers hold GPUs."""
    if cfg.use_torch_distributed is not None:
        return cfg.use_torch_distributed
    return resources_per_worker.get("GPU", 0) > 0


def _rendezvous_address() -> str:
    """Runs on rank 0: a ``tcp://`` address on a free port of its host."""
    import socket

    try:
        host = socket.gethostbyname(socket.gethostname())
    except socket.gaierror:  # a host whose name does not resolve: local ranks only
        host = "127.0.0.1"
    with socket.socket() as s:
        s.bind(("", 0))
        port = s.getsockname()[1]
    return f"tcp://{host}:{port}"


def _init_world(address: str, rank: int, world_size: int) -> str:
    """Runs on every rank: join the gang's process group on this worker's
    device (its granted card, or the CPU where it holds no GPU)."""
    from ray_tpu_torch.parallel.mesh import init_world
    from ray_tpu_torch.runtime_context import get_runtime_context

    device = None if get_runtime_context().get_gpu_ids() else "cpu"
    return str(init_world(None, rank, world_size, address, device=device))


class _TorchBackend(Backend):
    def on_start(self, worker_group: WorkerGroup, cfg: TorchConfig):
        n = worker_group.num_workers
        group = f"train-{uuid.uuid4().hex[:8]}"
        env = {
            "RAY_TRAIN_WORLD_SIZE": str(n),
            "RAY_TRAIN_COLLECTIVE_GROUP": group,
        }
        ray_tpu_torch.get(
            [w.setup_env.remote({**env, "RAY_TRAIN_WORLD_RANK": str(i)})
             for i, w in enumerate(worker_group.workers)],
            timeout=60,
        )
        if _uses_torch_group(cfg, worker_group.resources_per_worker):
            address = worker_group.execute_single(0, _rendezvous_address)
            blob = cloudpickle.dumps(_init_world)
            # every rank at once: the rendezvous returns when all have joined
            ray_tpu_torch.get(
                [w.execute.remote(blob, address, i, n)
                 for i, w in enumerate(worker_group.workers)],
                timeout=300,
            )
            ray_tpu_torch.get(
                [w.join_collective_group.remote(n, i, group, "torch")
                 for i, w in enumerate(worker_group.workers)],
                timeout=60,
            )
            return
        # rank 0 first: it creates the coordinator the others poll for
        ray_tpu_torch.get(
            worker_group.workers[0].join_collective_group.remote(n, 0, group),
            timeout=60,
        )
        ray_tpu_torch.get(
            [
                w.join_collective_group.remote(n, i, group)
                for i, w in enumerate(worker_group.workers)
                if i > 0
            ],
            timeout=60,
        )
