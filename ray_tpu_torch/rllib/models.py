"""RL model catalog: MLP and CNN actor-critics, the Gaussian actor and the
Q network, as plain functions over param trees.

Counterpart of ``ray_tpu/rllib/models.py``.  The params keep the JAX
package's layouts, so its weights carry across leaf by leaf
(``convert.from_jax_rl_params``): dense weights ``(in, out)`` for
``x @ W``, conv kernels HWIO over NHWC observations.  ``F.conv2d`` reads
the NHWC activations as NCHW views (channels-last memory, which cuDNN
convolves natively) and the HWIO kernels as OIHW views; the trunk's output
is read back as NHWC before the flatten, so the first dense layer's rows
follow the JAX package's (h, w, c) order.  ``apply_model`` dispatches on
the params (``"conv"`` present or not) and casts integer pixels to f32/255
on the params' device.

Weights are drawn on the CPU from a ``torch.Generator`` and then moved to
``device`` (the card when None; raises when there is none), as
``models/mlp.py`` draws them.  The draws differ from ``jax.random``'s.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.util.tree import tree_map

# Nature-DQN conv stack: (out_channels, kernel, stride)
NATURE_CONV_FILTERS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """The conv stack's architecture, carried inside the params dict as
    metadata, not a leaf (``util.tree`` leaves it alone): the optimizer
    never sees the strides, and ``apply_model`` reads them."""

    filters: Tuple[Tuple[int, int, int], ...]


def _dense_params(g: torch.Generator, n_in: int, n_out: int, scale: float = 1.0) -> Dict:
    """Scaled-normal weights, zero bias (final layers down-scaled as in
    PPO practice)."""
    return {"w": torch.randn(n_in, n_out, generator=g) * (scale / math.sqrt(n_in)),
            "b": torch.zeros(n_out)}


def _to(tree, dev: torch.device):
    return tree_map(lambda t: t.to(dev), tree)


def _mlp(layers: List[Dict], x: torch.Tensor) -> torch.Tensor:
    """tanh MLP with a linear last layer."""
    for layer in layers[:-1]:
        x = torch.tanh(x @ layer["w"] + layer["b"])
    last = layers[-1]
    return x @ last["w"] + last["b"]


def _heads(g: torch.Generator, n_in: int, num_actions: int, hiddens: Sequence[int]) -> Dict:
    pi, vf = [], []
    for h in hiddens:
        pi.append(_dense_params(g, n_in, h))
        vf.append(_dense_params(g, n_in, h))
        n_in = h
    pi.append(_dense_params(g, n_in, num_actions, 0.01))
    vf.append(_dense_params(g, n_in, 1))
    return {"pi": pi, "vf": vf}


def init_actor_critic(generator: torch.Generator, obs_dim: int, num_actions: int,
                      hiddens: Sequence[int] = (64, 64), *, device: DeviceLike = None) -> Dict:
    """Params for policy and value MLPs: ``{"pi": [...], "vf": [...]}``."""
    dev = resolve_device(device)
    return _to(_heads(generator, obs_dim, num_actions, hiddens), dev)


def apply_actor_critic(params: Dict, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """obs [B, obs_dim] -> (logits [B, A], value [B])."""
    return _mlp(params["pi"], obs), _mlp(params["vf"], obs)[..., 0]


# ---------------------------------------------------------------------------
# CNN actor-critic (Atari-shaped inputs)
# ---------------------------------------------------------------------------


def conv_out_hw(h: int, w: int, filters: Sequence[Tuple[int, int, int]]) -> Tuple[int, int]:
    """Height and width after the VALID convs of ``filters``."""
    for _, k, stride in filters:
        h, w = (h - k) // stride + 1, (w - k) // stride + 1
    return h, w


def _conv_forward(convs: List[Dict], x: torch.Tensor, filters) -> torch.Tensor:
    """x [B, H, W, C] -> relu'd trunk flattened in (h, w, c) order."""
    x = x.permute(0, 3, 1, 2)  # an NCHW view of NHWC memory: channels-last
    for layer, (_, _, stride) in zip(convs, filters):
        x = F.relu(F.conv2d(x, layer["w"].permute(3, 2, 0, 1), layer["b"], stride=stride))
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def init_conv_actor_critic(
    generator: torch.Generator, obs_shape: Tuple[int, int, int], num_actions: int,
    conv_filters: Sequence[Tuple[int, int, int]] = NATURE_CONV_FILTERS,
    hiddens: Sequence[int] = (256,), *, device: DeviceLike = None,
) -> Dict:
    """Shared conv trunk + separate pi/vf dense heads for [H, W, C] obs.
    Conv kernels HWIO, He-normal; the dict carries its architecture as a
    ``ConvSpec`` under ``"conv_spec"``."""
    dev = resolve_device(device)
    H, W, C = obs_shape
    convs, c_in = [], C
    for c_out, k, _ in conv_filters:
        fan_in = k * k * c_in
        convs.append({"w": torch.randn(k, k, c_in, c_out, generator=generator)
                      * math.sqrt(2.0 / fan_in), "b": torch.zeros(c_out)})
        c_in = c_out
    oh, ow = conv_out_hw(H, W, conv_filters)
    params = {"conv": convs, **_heads(generator, oh * ow * c_in, num_actions, hiddens),
              "conv_spec": ConvSpec(tuple(tuple(f) for f in conv_filters))}
    return _to(params, dev)


def apply_conv_actor_critic(params: Dict, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """obs [B, H, W, C] float (pixels already scaled) -> (logits, value)."""
    x = _conv_forward(params["conv"], obs, params["conv_spec"].filters)
    return _mlp(params["pi"], x), _mlp(params["vf"], x)[..., 0]


def apply_model(params: Dict, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Catalog dispatch: the params name their architecture.  Integer
    pixels become f32 / 255 here, on the tensor's own device, so uint8
    frames cross to the card as one byte a pixel; other inputs become
    f32."""
    obs = obs.float() if obs.is_floating_point() else obs.float() / 255.0
    if "conv" in params:
        return apply_conv_actor_critic(params, obs)
    return apply_actor_critic(params, obs)


# ---------------------------------------------------------------------------
# continuous-control nets (SAC): squashed-Gaussian actor + state-action Q
# ---------------------------------------------------------------------------


def _stack(g: torch.Generator, n_in: int, hiddens: Sequence[int], n_out: int,
           last_scale: float, dev: torch.device) -> Dict:
    layers = []
    for h in hiddens:
        layers.append(_dense_params(g, n_in, h))
        n_in = h
    layers.append(_dense_params(g, n_in, n_out, last_scale))
    return _to({"layers": layers}, dev)


def init_gaussian_actor(generator: torch.Generator, obs_dim: int, act_dim: int,
                        hiddens: Sequence[int] = (64, 64), *, device: DeviceLike = None) -> Dict:
    """Actor emitting (mean, log_std) per action dim."""
    return _stack(generator, obs_dim, hiddens, 2 * act_dim, 0.01, resolve_device(device))


def apply_gaussian_actor(params: Dict, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """obs [B, D] -> (mean [B, A], log_std [B, A]) with log_std in [-20, 2]."""
    out = _mlp(params["layers"], obs)
    act_dim = out.shape[-1] // 2
    return out[..., :act_dim], torch.clamp(out[..., act_dim:], -20.0, 2.0)


def init_q_network(generator: torch.Generator, obs_dim: int, act_dim: int,
                   hiddens: Sequence[int] = (64, 64), *, device: DeviceLike = None) -> Dict:
    return _stack(generator, obs_dim + act_dim, hiddens, 1, 1.0, resolve_device(device))


def apply_q_network(params: Dict, obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    """(obs [B, D], act [B, A]) -> Q [B]."""
    return _mlp(params["layers"], torch.cat([obs, act], dim=-1))[..., 0]
