"""Training helpers for the data-parallel gang: the port's counterpart of
``ray_tpu/train/jax_utils.py``.

Gradient sync is one all-reduce of the flattened gradient tree (one
collective round per step, not one per leaf, as ``ravel_pytree`` makes it
in the JAX package), over the gang's collective group: the ``shm`` group
through the object store, or the ``torch`` group over the gang's
``torch.distributed`` world (NCCL on the card).  Batch sharding is a pure
function of rank.  :func:`get_device` is the worker's granted card.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.air import session
from ray_tpu_torch.util.tree import tree_leaves, tree_map


def get_device(device: DeviceLike = None) -> torch.device:
    """The device this Train worker runs on: its granted card, which CUDA
    numbers ``cuda:0`` inside the worker (its ``CUDA_VISIBLE_DEVICES`` is
    the grant), made the current device.  Raises ``RuntimeError`` when the
    worker holds no GPU (``ScalingConfig(use_gpu=False)``) unless
    ``device="cpu"`` is passed: a worker without a grant never trains on
    the CPU by itself."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    from ray_tpu_torch.runtime_context import get_runtime_context

    if not get_runtime_context().get_gpu_ids():
        raise RuntimeError(
            "this worker holds no GPU (ScalingConfig(use_gpu=False)); pass "
            "device='cpu' to train on the CPU")
    dev = resolve_device("cuda" if device is None else device)
    if dev.index is None:
        dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return dev


def allreduce_grads(grads: Any, group_name: Optional[str] = None) -> Any:
    """Mean-all-reduce a gradient tree across the training gang in one
    round, and return the tree of the means (views of one flat buffer).

    The leaves are flattened into one buffer of their common dtype; the
    ``torch`` group reduces it in place on the device, the ``shm`` group
    carries it through the object store as a numpy array and the result
    comes back to the leaves' device.  When the process has an active
    :class:`~ray_tpu_torch.util.perf.StepProfiler` with a step open, the
    round is billed to that step's ``collective`` phase."""
    from ray_tpu_torch.util import collective
    from ray_tpu_torch.util import perf as _perf

    group = group_name or os.environ.get("RAY_TRAIN_COLLECTIVE_GROUP", "default")
    leaves = tree_leaves(grads)
    if not leaves:
        return grads
    dtypes = {g.dtype for g in leaves}
    if len(dtypes) != 1:
        raise ValueError(f"allreduce_grads takes leaves of one dtype, got {sorted(map(str, dtypes))}")
    flat = torch.cat([g.detach().reshape(-1) for g in leaves])
    prof = _perf.active_profiler()
    scope = prof.phase("collective") if prof is not None else contextlib.nullcontext()
    with scope:
        if collective.get_group_backend(group) == "shm":
            out = collective.allreduce(flat.cpu().numpy(), group_name=group, op="mean")
            flat = torch.from_numpy(np.ascontiguousarray(out)).to(flat.device)
        else:
            flat = collective.allreduce(flat, group_name=group, op="mean")
    pieces = iter(torch.split(flat, [g.numel() for g in leaves]))
    return tree_map(lambda g: next(pieces).view_as(g), grads)


def step_profiler(*, cfg: Any = None, n_params: Optional[int] = None,
                  tokens_per_step: Optional[int] = None,
                  rank: Optional[int] = None, **kwargs):
    """Build and install a :class:`~ray_tpu_torch.util.perf.StepProfiler`
    for this train worker, with the FLOPs model derived from a model
    config (``util/flops.py``, the arithmetic ``chip_smoke.py`` uses)::

        prof = torch_utils.step_profiler(cfg=cfg, n_params=n_params,
                                         tokens_per_step=B * T, device=dev)
        step_fn = prof.wrap_jit(step_fn)
        for ...:
            with prof.step():
                ...
    """
    from ray_tpu_torch.util import flops as flops_mod
    from ray_tpu_torch.util import perf as _perf

    fpt = kwargs.pop("flops_per_token", None)
    if fpt is None and cfg is not None and n_params is not None:
        fpt = flops_mod.model_flops_per_token(cfg, n_params)
    if rank is None:
        rank = session.get_world_rank()
    return _perf.StepProfiler(
        flops_per_token=fpt, tokens_per_step=tokens_per_step,
        rank=rank, **kwargs).install()


def shard_batch(batch: Any, *, rank: Optional[int] = None,
                world_size: Optional[int] = None) -> Any:
    """This rank's slice of a global batch (leading axis split evenly)."""
    rank = rank if rank is not None else session.get_world_rank()
    world_size = world_size if world_size is not None else session.get_world_size()

    def _slice(x):
        per = x.shape[0] // world_size
        return x[rank * per:(rank + 1) * per]

    return tree_map(_slice, batch)


def global_mesh(axis_name: str = "dp", *, device: DeviceLike = None):
    """A 1-D ``DeviceMesh`` over every rank of the gang's process group
    (``TorchConfig`` makes it for GPU workers, or with
    ``use_torch_distributed=True``)."""
    from ray_tpu_torch.parallel.mesh import MeshSpec, create_mesh

    return create_mesh(MeshSpec(**{axis_name: -1}), device=device)
