"""The port's Train layer: ``Predictor`` and ``TorchPredictor``
(``train/predictor.py``).  The Train runtime (worker group, backend,
``BatchPredictor``) is not ported."""

from ray_tpu_torch.train.predictor import Predictor, TorchPredictor

__all__ = ["Predictor", "TorchPredictor"]
