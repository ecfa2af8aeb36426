"""The port's AIR layer: ``Checkpoint`` (``air/checkpoint.py``), its own
copy of ``ray_tpu/air/checkpoint.py`` without the object store."""

from ray_tpu_torch.air.checkpoint import Checkpoint

__all__ = ["Checkpoint"]
