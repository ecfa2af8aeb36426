"""MLP classifier (BASELINE config 2: the MNIST MLP).

Counterpart of ``ray_tpu/models/mlp.py``: dense layers with ReLU between
them, softmax cross entropy on one-hot labels, and accuracy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: Tuple[int, ...] = (512, 256)
    num_classes: int = 10
    dtype: torch.dtype = torch.float32


def init(cfg: MLPConfig, generator: Optional[torch.Generator] = None, *,
         device: DeviceLike = None) -> Dict[str, Any]:
    """He-normal weights ``w{i}`` ``(in, out)`` and zero biases ``b{i}``,
    f32, drawn on the CPU from ``generator`` (seed 0 when None), then
    moved to ``device`` (the card when None)."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    dims = (cfg.in_dim, *cfg.hidden, cfg.num_classes)
    params = {}
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{i}"] = (torch.randn(d_in, d_out, generator=g) * (2.0 / d_in) ** 0.5).to(dev)
        params[f"b{i}"] = torch.zeros(d_out, device=dev)
    return params


def apply(params: Dict[str, Any], x: torch.Tensor, cfg: MLPConfig) -> torch.Tensor:
    """x [B, in_dim] -> logits [B, num_classes] in cfg.dtype."""
    n_layers = len(cfg.hidden) + 1
    h = x.to(cfg.dtype)
    for i in range(n_layers):
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            h = F.relu(h)
    return h


def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor], cfg: MLPConfig
            ) -> torch.Tensor:
    """Mean softmax cross entropy against one-hot labels.  batch:
    ``{"x": [B, in_dim], "y": [B] int}``."""
    logits = apply(params, batch["x"], cfg)
    labels = F.one_hot(batch["y"].long(), cfg.num_classes).to(logits.dtype)
    return -(labels * F.log_softmax(logits, dim=-1)).sum(dim=-1).mean()


def accuracy(params: Dict[str, Any], batch: Dict[str, torch.Tensor], cfg: MLPConfig
             ) -> torch.Tensor:
    return (apply(params, batch["x"], cfg).argmax(dim=-1) == batch["y"]).float().mean()
