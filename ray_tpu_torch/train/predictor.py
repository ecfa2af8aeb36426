"""Predictors: a checkpoint turned into inference on the card, one batch
at a time or over a Dataset.

Counterpart of ``ray_tpu/train/predictor.py``: ``Predictor``,
``TorchPredictor`` in the place of ``JaxPredictor``, and
``BatchPredictor``, which scores a :class:`~ray_tpu_torch.data.Dataset`
over a pool of actors, each holding the model on the card (or the share of
card 0) it was granted.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

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


class _ScoringWrapper:
    """The callable class that ``map_batches`` runs on each pool actor:
    it builds the predictor once, in the actor, on the card the actor was
    granted (the actor's ``CUDA_VISIBLE_DEVICES``; the forked worker has
    made no CUDA context before this), then scores batches
    (``batch_predictor.py`` ScoringWrapper analog)."""

    def __init__(
        self,
        checkpoint_blob: bytes,
        predictor_cls: type,
        predictor_kwargs: dict,
        feature_columns,
        keep_columns,
    ):
        import cloudpickle

        checkpoint = cloudpickle.loads(checkpoint_blob)
        self._predictor = predictor_cls.from_checkpoint(checkpoint, **predictor_kwargs)
        self._feature_columns = feature_columns
        self._keep_columns = keep_columns

    def __call__(self, batch):
        feats = batch
        if self._feature_columns is not None and isinstance(batch, dict):
            if len(self._feature_columns) == 1:
                feats = batch[self._feature_columns[0]]
            else:
                feats = {c: batch[c] for c in self._feature_columns}
        preds = self._predictor.predict(feats)
        if not isinstance(preds, dict):
            preds = {"predictions": np.asarray(preds)}
        if self._keep_columns and isinstance(batch, dict):
            for c in self._keep_columns:
                preds[c] = batch[c]
        return preds


class BatchPredictor:
    """Score a Dataset with an actor pool of predictors
    (``train/batch_predictor.py`` analog).  ``predictor_kwargs`` go to
    ``predictor_cls.from_checkpoint`` in each actor: for ``TorchPredictor``
    its ``apply_fn`` and, for a pool without cards, ``device="cpu"``."""

    def __init__(self, checkpoint: Checkpoint, predictor_cls: type, **predictor_kwargs):
        if not (isinstance(predictor_cls, type) and issubclass(predictor_cls, Predictor)):
            raise TypeError(f"predictor_cls must be a Predictor subclass, got {predictor_cls!r}")
        self._checkpoint = checkpoint
        self._predictor_cls = predictor_cls
        self._predictor_kwargs = predictor_kwargs

    @classmethod
    def from_checkpoint(
        cls, checkpoint: Checkpoint, predictor_cls: type, **predictor_kwargs
    ) -> "BatchPredictor":
        return cls(checkpoint, predictor_cls, **predictor_kwargs)

    def predict(
        self,
        data,
        *,
        batch_size: Optional[int] = None,
        min_scoring_workers: int = 1,
        max_scoring_workers: int = 2,
        num_gpus_per_worker: float = 0,
        num_cpus_per_worker: float = 1,
        feature_columns=None,
        keep_columns=None,
    ):
        """Returns a Dataset of predictions (lazy, like the input).  Each of
        the ``max_scoring_workers`` actors holds ``num_gpus_per_worker``
        of a card: 1 for a card of its own, 0.5 for two actors on card 0.
        The checkpoint crosses to the actors by cloudpickle: a directory
        checkpoint as its path, a dict checkpoint as its data."""
        import cloudpickle

        from ray_tpu_torch.data.dataset import ActorPoolStrategy

        if min_scoring_workers > max_scoring_workers:
            raise ValueError(
                f"min_scoring_workers={min_scoring_workers} exceeds "
                f"max_scoring_workers={max_scoring_workers}"
            )
        ckpt_blob = cloudpickle.dumps(self._checkpoint)
        return data.map_batches(
            _ScoringWrapper,
            batch_size=batch_size,
            compute=ActorPoolStrategy(size=max_scoring_workers),
            fn_constructor_args=(
                ckpt_blob,
                self._predictor_cls,
                self._predictor_kwargs,
                feature_columns,
                keep_columns,
            ),
            num_gpus=num_gpus_per_worker,
        )
