"""Layer ops: norms, rotary embeddings, the token loss.

Counterpart of ``ray_tpu/ops/layers.py``, in plain PyTorch.  The norms
take their statistics in f32 and cast to ``x.dtype`` before the weight is
applied; the bf16 rounding depends on that order.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


def layernorm(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    out = F.layer_norm(xf, xf.shape[-1:], eps=eps).to(x.dtype) * weight
    if bias is not None:
        out = out + bias
    return out


def rope(x: torch.Tensor, positions: torch.Tensor, *, base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding on interleaved (even, odd) lane pairs.
    x: [..., T, D] with D even.

    positions: [T] (shared across the batch) or [B, T] (each sequence at
    its own offset, as in KV-cache decode; x is then [B, H, T, D])."""
    d = x.shape[-1]
    inv_freq = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32,
                                            device=x.device) / d))
    if positions.ndim == 2:  # [B, T] -> angles [B, 1, T, D/2]
        angles = positions.float()[:, None, :, None] * inv_freq
    else:
        angles = positions.float()[:, None] * inv_freq[None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.stack([out1, out2], dim=-1).reshape(x.shape).to(x.dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       ignore_index: int = -100, z_loss: float = 0.0) -> torch.Tensor:
    """Token-level cross entropy with optional z-loss; logits [..., V]
    reduced in f32, labels [...] int."""
    logits = logits.float()
    if isinstance(logits, DTensor):
        # the label gather needs each rank's rows whole: keep the plain
        # shardings of the leading dims, replicate the rest
        logits = logits.redistribute(placements=[
            pl if type(pl) is Shard and pl.dim < logits.ndim - 1 else Replicate()
            for pl in logits.placements])
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(
        logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = lse - label_logit
    if z_loss:
        nll = nll + z_loss * lse ** 2
    valid = labels != ignore_index
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)
