"""ray_tpu_torch.tune: the ``Trainable`` class API that RLlib's
``Algorithm`` subclasses.  Counterpart of part of ``ray_tpu/tune/``;
the Tuner, the trial runner, the schedulers and search are not ported
yet."""

from ray_tpu_torch.tune.trainable import DONE, TRAINING_ITERATION, Trainable

__all__ = ["Trainable", "DONE", "TRAINING_ITERATION"]
