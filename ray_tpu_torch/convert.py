"""Carry weights and train states from the JAX package into the port.

The JAX package's params are a dict pytree with stacked ``[L, ...]``
block leaves and weights laid out ``(in, out)`` for ``x @ W``.  The port
keeps exactly that layout (its layers compute ``x @ W`` too), so the
conversion is a leaf-by-leaf copy with no transpose.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.transformer import named_leaves, train_state


def _leaf(a: Any, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C", copy=True)  # the port owns its weights
    if a.dtype.name == "bfloat16":
        # an ml_dtypes bfloat16 array, which torch.from_numpy refuses:
        # reinterpret its bits, which are torch.bfloat16's bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_jax_params(np_params: Mapping[str, Any], cfg, device: DeviceLike = None
                    ) -> dict:
    """The port's params for ``cfg`` from the JAX package's params as
    numpy arrays (``jax.tree.map(np.asarray, params)``): the same tree of
    dicts, each leaf a tensor on ``device`` (the card when None) in the
    leaf's own dtype.  ``cfg`` is the port's config; its ``n_layers``
    must match the stacked leaves."""
    dev = resolve_device(device)

    def convert(tree):
        if isinstance(tree, Mapping):
            return {k: convert(v) for k, v in tree.items()}
        return _leaf(tree, dev)

    params = convert(np_params)
    for name, leaf in params.get("blocks", {}).items():
        if leaf.shape[0] != cfg.n_layers:
            raise ValueError(f"blocks/{name} has {leaf.shape[0]} layers, "
                             f"config says {cfg.n_layers}")
    return params


def from_jax_train_state(np_state: Mapping[str, Any], cfg, optimizer,
                         device: DeviceLike = None) -> Dict[str, Any]:
    """The port's train state from the JAX package's, as numpy arrays
    (``jax.tree.map(np.asarray, state)`` of ``gpt2.init_state`` or of a
    state ``make_train_step`` returned), so a run started in JAX goes on
    in the port.  ``optimizer`` is the port's ``make_optimizer`` with the
    same settings as the JAX one.

    The optax state of that recipe is ``(EmptyState, (ScaleByAdamState(
    count, mu, nu), MaskedState(EmptyState), ScaleByScheduleState(count)))``
    (clip, then adamw); it maps to the port as mu -> ``exp_avg``, nu ->
    ``exp_avg_sq``, the Adam count -> AdamW's ``step``, the schedule
    count -> the LR schedule's position, and ``step`` -> ``step``."""
    dev = resolve_device(device)
    params = from_jax_params(np_state["params"], cfg, dev)
    adam, _, schedule = np_state["opt_state"][1]
    count, mu, nu = adam[0], adam[1], adam[2]
    state = train_state(params, optimizer, int(schedule[0]))
    state["step"] = int(np_state["step"])
    mu = dict(named_leaves(from_jax_params(mu, cfg, dev)))
    nu = dict(named_leaves(from_jax_params(nu, cfg, dev)))
    adamw = state["opt_state"]["adamw"]
    for name, p in named_leaves(params):
        adamw.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32),
                          "exp_avg": mu[name], "exp_avg_sq": nu[name]}
    return state
