"""Device meshes with named parallelism axes.

Counterpart of ``ray_tpu/parallel/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, one process per device, with ``mesh_dim_names`` from the
same vocabulary:

- ``dp``   — pure data parallelism (params replicated)
- ``fsdp`` — data parallelism with ZeRO-style parameter sharding
- ``tp``   — tensor (model) parallelism, Megatron-style
- ``sp``   — sequence parallelism (ring attention)
- ``ep``   — expert parallelism for MoE
- ``pp``   — pipeline stages

Axes are laid out in :data:`AXIS_ORDER`, outermost first, so ``tp`` and
``sp`` take adjacent ranks.  Unlike the JAX package, where every process
builds the mesh over the slice's devices, the process group must exist
first: :func:`init_world` joins it (NCCL on the card, gloo on the CPU).
"""

from __future__ import annotations

import dataclasses
import math
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch._device import DeviceLike, resolve_device

# Canonical axis order, outermost to innermost (as in the JAX package).
AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape: axis name -> size.

    ``-1`` for at most one axis means "all remaining ranks"::

        MeshSpec(dp=-1, tp=4).build()   # 2-D mesh over every rank
    """

    pp: int = 1
    dp: int = 1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def axis_sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = self.axis_sizes()
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one axis may be -1, got {wild}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"mesh spec {sizes} needs {fixed} devices, have {n_devices}")
        return sizes

    def build(self, ranks: Optional[Sequence[int]] = None, *, device: DeviceLike = None,
              keep_unit_axes: bool = False) -> DeviceMesh:
        return create_mesh(self, ranks, device=device, keep_unit_axes=keep_unit_axes)


def init_world(backend: Optional[str] = None, rank: int = 0, world_size: int = 1,
               init_method: Optional[str] = None,
               timeout: timedelta = timedelta(seconds=60), *,
               device: DeviceLike = None) -> torch.device:
    """Join the default process group and return this rank's device.

    ``device`` None means the card: the rank takes CUDA device ``rank %
    device_count`` and the backend defaults to NCCL; ``device="cpu"``
    defaults to gloo.  ``init_method`` is the rendezvous
    (``tcp://host:port`` or ``file:///path``; None reads the ``env://``
    variables).  There is no fallback from one backend to another."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=init_method, rank=rank, world_size=world_size,
                            timeout=timeout)
    return dev


def mesh_axes(spec: MeshSpec, n_devices: int, *, keep_unit_axes: bool = False
              ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """The names and shape ``create_mesh`` gives ``spec`` over
    ``n_devices``: ``AXIS_ORDER``, unit axes dropped unless
    ``keep_unit_axes``, one ``dp`` axis when no axis is left."""
    sizes = spec.resolve(n_devices)
    names = tuple(a for a in AXIS_ORDER if keep_unit_axes or sizes[a] > 1) or ("dp",)
    return names, tuple(sizes[a] for a in names)


def create_mesh(spec: Union[MeshSpec, Dict[str, int]], ranks: Optional[Sequence[int]] = None,
                *, device: DeviceLike = None, keep_unit_axes: bool = False) -> DeviceMesh:
    """Build a ``DeviceMesh`` from a spec over ``ranks`` (default: every
    rank of the default process group, which must be initialised).

    Axes are laid out in ``AXIS_ORDER``; unit axes are dropped unless
    ``keep_unit_axes``, and a mesh with no axis left keeps one ``dp``
    axis.  ``device`` None means the card."""
    dev = resolve_device(device)
    if isinstance(spec, dict):
        spec = MeshSpec(**spec)
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call init_world first")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    names, shape = mesh_axes(spec, len(ranks), keep_unit_axes=keep_unit_axes)
    return DeviceMesh(dev.type, torch.tensor(ranks, dtype=torch.int).reshape(shape),
                      mesh_dim_names=names)


def local_mesh(axis: str = "dp", *, device: DeviceLike = None) -> DeviceMesh:
    """1-D mesh over every rank of the default process group (one process
    per device, so these are the world's devices)."""
    return DeviceMesh(resolve_device(device).type, torch.arange(dist.get_world_size()),
                      mesh_dim_names=(axis,))


def get_abstract_mesh(mesh: DeviceMesh) -> Dict[str, int]:
    """axis name -> size view of a mesh (for logging)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def ici_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """Axes whose collectives sit on every layer's path (tp, sp, ep): on a
    GPU host these belong on NVLink."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("tp", "sp", "ep"))


def dcn_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """Axes that may span hosts (gradient sync and stage hops only)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pp", "dp", "fsdp"))
