"""Carry weights and train states from the JAX package into the port.

The JAX package's params are a dict pytree with stacked ``[L, ...]``
block leaves and weights laid out ``(in, out)`` for ``x @ W``.  The port
keeps exactly that layout (its layers compute ``x @ W`` too), so the
conversion is a leaf-by-leaf copy with no transpose.  That carries every
model of the port: the decoders, BERT (``wtype``, ``pool_*``, ``cls_*``),
the MLP (no ``blocks``) and the MoE leaves (``[L, E, ...]``).

The RL nets (``rllib/models.py``) keep the JAX package's layouts too:
dense ``(in, out)`` and conv kernels HWIO, so their weights carry across
leaf by leaf as well (``from_jax_rl_params``), with the static
``ConvSpec`` node rebuilt as the port's own; ``from_jax_rl_state`` carries
a policy's optax Adam state into ``torch.optim.Adam``'s.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.transformer import named_leaves, train_state
from ray_tpu_torch.rllib.models import ConvSpec
from ray_tpu_torch.util.tree import tree_map


def _leaf(a: Any, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to(device, copy=True)
    a = np.array(a, order="C", copy=True)  # the port owns its weights
    if a.dtype.name == "bfloat16":
        # an ml_dtypes bfloat16 array, which torch.from_numpy refuses:
        # reinterpret its bits, which are torch.bfloat16's bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_jax_params(np_params: Any, cfg=None, device: DeviceLike = None
                    ) -> Any:
    """The port's params from the JAX package's params as numpy arrays
    (``jax.tree.map(np.asarray, params)``): the same tree of dicts, each
    leaf a tensor on ``device`` (the card when None) in the leaf's own
    dtype (a leaf that is a tensor already is copied; lists and tuples
    keep their place, other values stay as they are).  Where the tree has
    ``blocks``, every block leaf must stack the same number of layers,
    and that number must be ``cfg.n_layers`` when a config is given."""
    dev = resolve_device(device)
    params = tree_map(lambda a: _leaf(a, dev), np_params)
    blocks = params.get("blocks", {}) if isinstance(params, dict) else {}
    depths = {name: leaf.shape[0] for name, leaf in blocks.items()}
    wanted = set(depths.values()) | ({cfg.n_layers} if cfg is not None and depths else set())
    if len(wanted) > 1:
        raise ValueError(f"block leaves stack {depths} layers"
                         + (f", config says {cfg.n_layers}" if cfg is not None else ""))
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


def from_jax_rl_params(np_params: Any, device: DeviceLike = None) -> Any:
    """An RL net's params (``JaxPolicy.get_weights()``, or ``SACPolicy``'s:
    dicts of lists of dicts, a 0-d ``log_alpha``) as tensors on ``device``
    (the card when None).  The JAX package's ``ConvSpec`` node, metadata
    and not a leaf, becomes the port's ``ConvSpec`` with the same filters,
    so the port's optimizer never sees the strides."""
    params = from_jax_params(np_params, None, device)
    if isinstance(params, dict) and "conv_spec" in params:
        params["conv_spec"] = ConvSpec(tuple(tuple(int(x) for x in f)
                                             for f in params["conv_spec"].filters))
    return params


def _adam_state(node: Any) -> Optional[tuple]:
    """The first optax ``ScaleByAdamState(count, mu, nu)`` in a chain's
    state, depth first."""
    if isinstance(node, tuple):
        if {"count", "mu", "nu"} <= set(getattr(node, "_fields", ())):
            return node.count, node.mu, node.nu
        for child in node:
            found = _adam_state(child)
            if found is not None:
                return found
    return None


def from_jax_rl_state(np_state: Mapping[str, Any], device: DeviceLike = None
                      ) -> Dict[str, Any]:
    """A policy's state in the port's form from ``JaxPolicy.get_state()``
    (or ``DQNPolicy``'s, ``SACPolicy``'s), for ``set_state`` of the
    matching port policy.  The optax state is ``(EmptyState,
    (ScaleByAdamState(count, mu, nu), EmptyState))`` with a clip and
    ``((ScaleByAdamState, EmptyState),)`` without one; it maps to
    ``torch.optim.Adam``'s per-param ``step`` (the count), ``exp_avg`` (mu)
    and ``exp_avg_sq`` (nu).  SAC's ``target_q`` comes across too."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {"weights": from_jax_rl_params(np_state["weights"], dev)}
    if np_state.get("opt_state") is not None:
        adam = _adam_state(np_state["opt_state"])
        if adam is None:
            raise ValueError("from_jax_rl_state: no ScaleByAdamState in the optax state")
        count, mu, nu = adam
        out["opt_state"] = {"step": int(np.asarray(count)),
                            "exp_avg": from_jax_rl_params(mu, dev),
                            "exp_avg_sq": from_jax_rl_params(nu, dev)}
    if np_state.get("target_q") is not None:
        out["target_q"] = from_jax_rl_params(np_state["target_q"], dev)
    return out
