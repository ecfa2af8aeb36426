"""The parallelism layer of the port: meshes, sharding rules, collectives
and the GPipe pipeline.

Counterpart of ``ray_tpu/parallel``.  A mesh is a ``DeviceMesh`` with
named axes (``dp``/``fsdp``/``tp``/``sp``/``ep``/``pp``) over the ranks of
a process group; sharding rules map the models' logical axes to DTensor
placements; the collectives run on one mesh axis's process group and
carry gradients.

- :mod:`ray_tpu_torch.parallel.mesh` — ``MeshSpec``, ``create_mesh``,
  ``init_world``.
- :mod:`ray_tpu_torch.parallel.sharding` — rule tables, placements,
  ``shard_params``.
- :mod:`ray_tpu_torch.parallel.collective` — ``allreduce`` and the rest,
  per rank.
- :mod:`ray_tpu_torch.parallel.pipeline` — ``gpipe`` over ``pp``.
- :mod:`ray_tpu_torch.parallel.spawn` — ``run_world``, ``n`` local ranks.
- :mod:`ray_tpu_torch.parallel.dryrun` — ``dryrun_multichip``, the
  sharded train-step gate.
"""

from ray_tpu_torch.parallel.mesh import (
    MeshSpec,
    create_mesh,
    get_abstract_mesh,
    init_world,
    local_mesh,
)
from ray_tpu_torch.parallel.pipeline import gpipe, pp_size
from ray_tpu_torch.parallel.sharding import (
    ShardingRules,
    infer_sharding,
    logical_to_sharding,
    shard_params,
    with_sharding_constraint,
)

__all__ = [
    "gpipe",
    "pp_size",
    "MeshSpec",
    "create_mesh",
    "init_world",
    "local_mesh",
    "get_abstract_mesh",
    "ShardingRules",
    "infer_sharding",
    "logical_to_sharding",
    "shard_params",
    "with_sharding_constraint",
]
