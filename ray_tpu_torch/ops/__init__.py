"""Operators of the port: ``layers`` (norms, rope, the loss),
``attention`` (the plain paths and flash attention, forward and
backward), with the hand-written CUDA kernels under ``csrc/`` built by
``_build``, and ``moe`` (the Switch MoE FFN on one device).

Import the modules themselves (``from ray_tpu_torch.ops import
attention``): nothing is re-exported here, so the module ``attention`` is
never shadowed by the function of the same name."""
