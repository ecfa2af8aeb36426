"""RLModule: the model plugin surface.

Counterpart of ``ray_tpu/rllib/rl_module.py``.  A module is a stateless
description: ``init(generator, device=...) -> params`` plus forwards over
the params tree (``forward_train`` for the losses,
``forward_exploration`` for sampling, ``forward_inference`` for greedy
acting).  The policy owns the params, the optimizer and the sampling
generator, and routes every forward through its module, so a custom
PyTorch model plugs in without subclassing the policy::

    class MyModule(RLModule):
        def init(self, generator, *, device=None): ...
        def forward_train(self, params, obs):
            return {Columns.ACTION_DIST_INPUTS: logits,
                    Columns.VF_PREDS: value}
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.rllib.models import apply_model, init_actor_critic, init_conv_actor_critic


class Columns:
    """Forward-output keys (RLlib's ``core.columns.Columns``)."""

    ACTION_DIST_INPUTS = "action_dist_inputs"
    VF_PREDS = "vf_preds"


class RLModule:
    """Base plugin: forwards over a params tree.

    ``forward_train`` is the only required forward; exploration and
    inference default to it, which is right for any shared-trunk
    actor-critic.  Forwards take device tensors and must not read values
    back to the host (they run inside every sampling tick and SGD step).
    """

    def init(self, generator: torch.Generator, *, device: DeviceLike = None) -> Any:
        """Build the params tree on ``device`` (the card when None)."""
        raise NotImplementedError

    def forward_train(self, params, obs) -> Dict[str, Any]:
        """Loss-path forward: must return ``Columns.ACTION_DIST_INPUTS``
        (logits / dist params) and ``Columns.VF_PREDS``."""
        raise NotImplementedError

    def forward_exploration(self, params, obs) -> Dict[str, Any]:
        """Sampling-path forward (stochastic acting)."""
        return self.forward_train(params, obs)

    def forward_inference(self, params, obs) -> Dict[str, Any]:
        """Greedy serving-path forward (evaluation)."""
        return self.forward_exploration(params, obs)


class DefaultActorCriticModule(RLModule):
    """The catalog's MLP/CNN actor-critic as a module: what every policy
    uses when no custom module is configured (the CNN when ``obs_shape``
    is an image's [H, W, C])."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hiddens: Tuple[int, ...] = (64, 64),
                 obs_shape: Optional[Tuple[int, ...]] = None):
        self.obs_dim = int(obs_dim)
        self.num_actions = int(num_actions)
        self.hiddens = tuple(int(h) for h in hiddens)
        self.obs_shape = tuple(obs_shape) if obs_shape else None

    def init(self, generator: torch.Generator, *, device: DeviceLike = None) -> Any:
        if self.obs_shape is not None and len(self.obs_shape) == 3:
            return init_conv_actor_critic(generator, self.obs_shape, self.num_actions,
                                          hiddens=self.hiddens, device=device)
        return init_actor_critic(generator, self.obs_dim, self.num_actions, self.hiddens,
                                 device=device)

    def forward_train(self, params, obs) -> Dict[str, Any]:
        logits, value = apply_model(params, obs)
        return {Columns.ACTION_DIST_INPUTS: logits, Columns.VF_PREDS: value}
