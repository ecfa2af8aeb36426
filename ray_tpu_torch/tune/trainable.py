"""Trainable: the unit of work a trial executes.

The port's own copy of ``ray_tpu/tune/trainable.py``'s ``Trainable``
(the reference's ``python/ray/tune/trainable/trainable.py`` class API):
``setup`` / ``step`` / ``save_checkpoint`` / ``load_checkpoint`` /
``cleanup``, driven by ``train``, ``save``, ``restore`` and ``stop``;
checkpoints travel as the port's ``air.Checkpoint``.
``FunctionTrainable`` and the ``wrap_*`` helpers wait for Tune.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.air import Checkpoint

DONE = "done"
TRAINING_ITERATION = "training_iteration"


class Trainable:
    def __init__(self, config: Optional[Dict] = None):
        self.config = config or {}
        self.iteration = 0
        self.setup(self.config)

    # -- subclass API --------------------------------------------------
    def setup(self, config: Dict) -> None:
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self) -> Optional[Dict]:
        return None

    def load_checkpoint(self, state: Dict) -> None:
        pass

    def cleanup(self) -> None:
        pass

    # -- runner-facing -------------------------------------------------
    def train(self) -> Dict[str, Any]:
        result = self.step()
        self.iteration += 1
        result.setdefault(TRAINING_ITERATION, self.iteration)
        result.setdefault(DONE, False)
        return result

    def save(self) -> Optional[Checkpoint]:
        state = self.save_checkpoint()
        if state is None:
            return None
        state["_iteration"] = self.iteration
        return Checkpoint.from_dict(state)

    def restore(self, ckpt: Checkpoint) -> None:
        state = ckpt.to_dict()
        self.iteration = state.pop("_iteration", 0)
        self.load_checkpoint(state)

    def stop(self) -> None:
        self.cleanup()
