"""Predictors: a checkpoint turned into inference on the card.

Counterpart of ``ray_tpu/train/predictor.py``'s ``Predictor`` and
``JaxPredictor``.  ``BatchPredictor``, which scores a Dataset over an actor
pool, needs the Data runtime and is not ported.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.convert import from_jax_params
from ray_tpu_torch.util.tree import tree_map

# an array, or any tree of dicts, lists and tuples of arrays
Batch = Any


class Predictor:
    """Base predictor: subclasses implement :meth:`from_checkpoint` and
    :meth:`predict` over a numpy batch (an array or a tree of them)."""

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, **kwargs) -> "Predictor":
        raise NotImplementedError

    def predict(self, batch: Batch, **kwargs):
        raise NotImplementedError


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:  # numpy has no bfloat16
        t = t.float()
    return t.cpu().numpy()


class TorchPredictor(Predictor):
    """Predictor over an eager PyTorch function ``apply_fn(params, batch)
    -> predictions``, on ``device`` (the card when None; raises when there
    is no card and none was asked for).

    ``params`` is a tree of dicts whose leaves are tensors or numpy arrays
    (carried by ``convert.from_jax_params``, so a JAX package's checkpoint
    loads); they are copied onto the device once.  :meth:`predict` moves
    each array of a numpy batch (any tree of dicts, lists and tuples) to
    the device, runs ``apply_fn`` under ``torch.inference_mode()`` and
    returns each tensor of its output as numpy in the output's own tree
    (bf16 as f32), as ``JaxPredictor.predict`` does; other values of either
    tree stay as they are.
    ``apply_fn`` sees device tensors, so ids that index a table are
    checked on the host before :meth:`predict` (``bert.check_tokens``):
    on the card an index out of range is a device-side assert that ends
    the process."""

    def __init__(self, params: Any, apply_fn: Callable, *, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._params = from_jax_params(params, None, self.device)
        self._apply = apply_fn

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, apply_fn: Callable, *,
                        params_key: str = "params", device: DeviceLike = None
                        ) -> "TorchPredictor":
        """The params are ``checkpoint.to_dict()[params_key]``, or the whole
        dict when it has no such key."""
        data = checkpoint.to_dict()
        return cls(data.get(params_key, data), apply_fn, device=device)

    def predict(self, batch: Batch, **kwargs):
        batch = tree_map(lambda a: torch.from_numpy(np.asarray(a)).to(self.device), batch)
        with torch.inference_mode():
            out = self._apply(self._params, batch)
        return tree_map(lambda t: _to_numpy(t) if isinstance(t, torch.Tensor) else t, out)
